"""Motion transformations of the CDNA, DNA and STP heads and the mask
compositor, on NHWC tensors.

Counterpart of `pivp_tpu/ops/transforms.py`. CDNA and DNA are expressed
over a shifted stack: the K*K zero-padded spatial shifts of the previous
frame, contracted against the predicted kernels (per sample for CDNA,
per pixel for DNA). The fused CDNA path collapses the masked mixture
into one per-pixel kernel; it and DNA apply their per-pixel kernels with
the local-apply kernel when given its wrapper. STP warps the previous
frame by affine parameters: an align-corners sampling grid and a
bilinear sampler with zero padding, as one-hot row and column weights
contracted by a batched product and a weighted sum (the default) or as
a gather.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from pivp_tpu_torch.config import DNA_KERN_SIZE, RELU_SHIFT


def shifted_stack(image: torch.Tensor, ksize: int = DNA_KERN_SIZE,
                  border_zero: bool = False) -> torch.Tensor:
    """(B, H, W, C) -> (B, K*K, H, W, C) of zero-padded spatial shifts;
    index k = dx*K + dy is the tap padded[h+dx, w+dy] with pad K//2.

    `border_zero=True` reproduces the Chainer port's DNA slicing bug:
    each shift takes padded[dx:H, dy:W] and re-pads the bottom/right
    tail with zeros."""
    pad = ksize // 2
    _, h, w, _ = image.shape
    padded = F.pad(image, (0, 0, pad, pad, pad, pad))
    shifts = []
    for dx in range(ksize):
        for dy in range(ksize):
            if border_zero:
                win = padded[:, dx:h, dy:w]
                win = F.pad(win, (0, 0, 0, dy, 0, dx))
            else:
                win = padded[:, dx:dx + h, dy:dy + w]
            shifts.append(win)
    return torch.stack(shifts, dim=1)


def mask_softmax(mask_logits: torch.Tensor,
                 scramble: bool = False) -> torch.Tensor:
    """ReLU + softmax of the compositing mask logits (B, H, W, M+1).

    `scramble=False`: per-pixel softmax over the M+1 mask channels.
    `scramble=True`: the Chainer port's reshape(-1, M+1) softmax over the
    NCHW tensor, which groups runs of M+1 consecutive row-major NCHW
    elements instead of per-pixel channels."""
    x = torch.relu(mask_logits)
    if not scramble:
        return torch.softmax(x, dim=-1)
    b, h, w, m1 = mask_logits.shape
    x = x.permute(0, 3, 1, 2).reshape(-1, m1)          # NCHW row-major
    x = torch.softmax(x, dim=-1)
    return x.reshape(b, m1, h, w).permute(0, 2, 3, 1)


def normalize_cdna_kernels(raw: torch.Tensor,
                           relu_shift: float = RELU_SHIFT) -> torch.Tensor:
    """ReLU-shift + sum-normalize raw kernel logits (B, M, K*K)."""
    k = torch.relu(raw - relu_shift) + relu_shift
    return k / k.sum(dim=-1, keepdim=True)


def cdna_apply(prev_image: torch.Tensor,
               kernels: torch.Tensor) -> torch.Tensor:
    """Apply per-sample CDNA kernels (B, M, K*K) to the previous frame
    (B, H, W, C); returns (B, M, H, W, C), one transformed frame per
    mask, as one batched matmul (B, M, KK) @ (B, KK, H*W*C)."""
    b, h, w, c = prev_image.shape
    ksq = kernels.shape[-1]
    ksize = int(round(ksq ** 0.5))
    stack = shifted_stack(prev_image, ksize).reshape(b, ksq, h * w * c)
    out = torch.bmm(kernels.to(prev_image.dtype), stack)
    return out.reshape(b, kernels.shape[1], h, w, c)


def fused_cdna_composite(
        prev_image: torch.Tensor, synth: torch.Tensor,
        kernels: torch.Tensor, mask_logits: torch.Tensor,
        local_apply: Optional[Callable] = None,
        scramble: bool = False) -> torch.Tensor:
    """CDNA transform + mask compositing in one pass, never materializing
    the (B, M, H, W, C) per-mask stack:

        out = prev*m_0 + synth*m_1 + sum_t w_t * shift_t(prev),
        w[b,h,w,t] = sum_j masks[b,h,w,j+2] * kernels[b,j,t]

    over the first M-1 kernels (the compositor's zip truncation).
    `local_apply(x, w)` applies the per-pixel kernel (the CUDA kernel's
    wrapper); None uses the shifted-stack einsum."""
    masks = mask_softmax(mask_logits, scramble)
    m = kernels.shape[1]
    w = torch.einsum("bhwm,bmk->bhwk", masks[..., 2:].to(kernels.dtype),
                     kernels[:, :m - 1])
    out = prev_image * masks[..., 0:1] + synth * masks[..., 1:2]
    if local_apply is None:
        ksize = int(round(w.shape[-1] ** 0.5))
        stack = shifted_stack(prev_image, ksize)
        return out + torch.einsum("bkhwc,bhwk->bhwc", stack,
                                  w.to(stack.dtype))
    return out + local_apply(prev_image.contiguous(),
                             w.to(prev_image.dtype).contiguous())


def dna_apply(prev_image: torch.Tensor, kernel_logits: torch.Tensor,
              relu_shift: float = RELU_SHIFT,
              local_apply: Optional[Callable] = None,
              border_zero: bool = False) -> torch.Tensor:
    """Dynamic neural advection: per-pixel K*K kernels.

    prev_image (B, H, W, C); kernel_logits (B, H, W, K*K), the enc7
    output. ReLU-shift normalizes over the K*K axis, then takes the
    per-pixel expectation over the shifted stack, or `local_apply(x, w)`
    (the CUDA kernel's wrapper) when given and `border_zero` is off:
    the kernel computes the true windows, not the Chainer port's
    border-zeroed ones (see shifted_stack)."""
    ksize = int(round(kernel_logits.shape[-1] ** 0.5))
    kern = torch.relu(kernel_logits - relu_shift) + relu_shift
    kern = kern / kern.sum(dim=-1, keepdim=True)
    if local_apply is not None and not border_zero:
        # enc7 is a channel slice of the merged output conv, so the
        # kernel (which takes contiguous NHWC tensors) gets a copy.
        return local_apply(prev_image.contiguous(),
                           kern.to(prev_image.dtype).contiguous())
    stack = shifted_stack(prev_image, ksize, border_zero=border_zero)
    return torch.einsum("bkhwc,bhwk->bhwc", stack, kern.to(stack.dtype))


def _linspace_m1_1(n: int, dtype: torch.dtype,
                   device) -> torch.Tensor:
    """n points from -1 to 1 as `jnp.linspace` computes them:
    start*(1-s) + stop*s with s = i/(n-1), and the endpoint appended.
    torch.linspace rounds differently (by up to 1.8e-7 in float32),
    which moves floor() of a sampling coordinate, and with it the
    one-sided derivative of the sampler, at some grid points."""
    if n == 1:
        return torch.full((1,), -1.0, dtype=dtype, device=device)
    div = n - 1
    s = torch.arange(div, dtype=dtype, device=device) / div
    out = -1.0 * (1 - s) + 1.0 * s
    return torch.cat([out, torch.ones(1, dtype=dtype, device=device)])


def affine_grid(theta: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Normalized (x, y) source coordinates in [-1, 1] from affine params,
    align-corners convention (chainer `F.spatial_transformer_grid`).

    theta (..., 2, 3); size (H, W). Returns (..., H, W, 2); leading dims
    (e.g. a per-mask axis) pass through."""
    h, w = size
    ys = _linspace_m1_1(h, theta.dtype, theta.device)
    xs = _linspace_m1_1(w, theta.dtype, theta.device)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")     # (H, W)
    base = torch.stack([grid_x, grid_y, torch.ones_like(grid_x)], dim=-1)
    return torch.einsum("...ij,hwj->...hwi", theta, base)


def _source_coords(grid: torch.Tensor, h: int, w: int):
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    return gx, gy


def _cell(coord: torch.Tensor) -> torch.Tensor:
    """The pixel cell of each source coordinate, floor(coord): the
    samplers' one discontinuity, where the derivative with respect to the
    coordinate changes side. Both samplers look it up here at call time,
    so a check can hold two float32 paths to the same cells."""
    return torch.floor(coord)


def bilinear_sample(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with zero padding outside the image, as four
    gathers (chainer `F.spatial_transformer_sampler`).

    image (B, H, W, C); grid (B, ..., 2) normalized (x, y) coordinates;
    extra leading grid dims (e.g. a per-mask warp axis) are sampled in
    the same gathers. Returns (B, ..., C)."""
    b, h, w, c = image.shape
    gx, gy = _source_coords(grid, h, w)
    x0, y0 = _cell(gx), _cell(gy)
    x1, y1 = x0 + 1.0, y0 + 1.0
    wx1, wy1 = gx - x0, gy - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    img_flat = image.reshape(b, h * w, c)

    def gather(yi, xi, wgt):
        # Out-of-bounds taps get zero weight (zero padding).
        valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        yc = torch.clamp(yi, 0, h - 1).to(torch.int64)
        xc = torch.clamp(xi, 0, w - 1).to(torch.int64)
        flat = (yc * w + xc).reshape(b, -1, 1).expand(-1, -1, c)
        vals = torch.gather(img_flat, 1, flat).reshape(yi.shape + (c,))
        return vals * (wgt * valid.to(image.dtype))[..., None]

    return (gather(y0, x0, wy0 * wx0) + gather(y0, x1, wy0 * wx1)
            + gather(y1, x0, wy1 * wx0) + gather(y1, x1, wy1 * wx1))


def bilinear_sample_matmul(image: torch.Tensor,
                           grid: torch.Tensor) -> torch.Tensor:
    """Gather-free bilinear sampling with zero padding: output pixel p
    with source (gy, gx) gets one-hot row weights R[p, y] (nonzero only
    at floor(gy) and floor(gy)+1) and column weights C[p, x], and
    out[p] = sum_x C[p, x] * (R @ image)[p, x]. An out-of-range tap
    matches no row or column, so it weighs nothing. The selectors come
    from float equality and `where`, so the gradient reaches the grid
    through the interpolation weights only, as in the JAX package.

    image (B, H, W, C); grid (B, ..., 2). Returns (B, ..., C)."""
    b, h, w, c = image.shape
    lead = tuple(grid.shape[1:-1])
    gx, gy = _source_coords(grid.reshape(b, -1, 2), h, w)     # (B, P)
    x0, y0 = _cell(gx), _cell(gy)
    wx1, wy1 = (gx - x0)[..., None], (gy - y0)[..., None]
    ys = torch.arange(h, dtype=image.dtype, device=image.device)
    xs = torch.arange(w, dtype=image.dtype, device=image.device)
    zero = image.new_zeros(())
    r = (torch.where(ys == y0[..., None], 1.0 - wy1, zero)
         + torch.where(ys == y0[..., None] + 1.0, wy1, zero))  # (B, P, H)
    col = (torch.where(xs == x0[..., None], 1.0 - wx1, zero)
           + torch.where(xs == x0[..., None] + 1.0, wx1, zero))  # (B, P, W)
    rows = torch.bmm(r.to(image.dtype), image.reshape(b, h, w * c))
    rows = rows.reshape(b, -1, w, c)                           # (B, P, W, C)
    # The column contraction as a weighted sum over `rows`: as an einsum
    # it becomes one (1, W) @ (W, C) product per output pixel, which
    # cuBLAS runs as batched matrix-vector kernels.
    out = (col.to(image.dtype)[..., None] * rows).sum(dim=2)
    return out.reshape((b,) + lead + (c,))


def stp_apply(prev_image: torch.Tensor, theta: torch.Tensor,
              use_matmul: bool = True) -> torch.Tensor:
    """Warp prev_image (B, H, W, C) by affine params theta (B, 2, 3), or
    by a stack (B, M, 2, 3) into (B, M, H, W, C). `use_matmul` picks
    the one-hot product sampler (default) over the gather one."""
    grid = affine_grid(theta.to(prev_image.dtype), prev_image.shape[1:3])
    if use_matmul:
        return bilinear_sample_matmul(prev_image, grid)
    return bilinear_sample(prev_image, grid)


def mask_composite(prev_image: torch.Tensor, transformed: torch.Tensor,
                   mask_logits: torch.Tensor, scramble: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax the masks per pixel and composite the candidates:
    output = prev*mask0 + sum_m transformed_m * mask_{m+1}.

    prev_image (B, H, W, C); transformed (B, M, H, W, C); mask_logits
    (B, H, W, M+1). Returns (output (B, H, W, C), masks)."""
    masks = mask_softmax(mask_logits, scramble)
    out = prev_image * masks[..., 0:1]
    out = out + torch.einsum("bmhwc,bhwm->bhwc", transformed,
                             masks[..., 1:].to(transformed.dtype))
    return out, masks


def quantize_frames_u8(frames: torch.Tensor) -> torch.Tensor:
    """[0,1] float frames -> uint8 with round-half-up and clipping (the
    uint8 wire format of the serving function)."""
    return torch.clamp(frames.to(torch.float32) * 255.0 + 0.5,
                       0.0, 255.0).to(torch.uint8)
