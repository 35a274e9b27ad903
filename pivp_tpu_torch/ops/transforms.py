"""CDNA motion transformation and mask compositing on NHWC tensors.

Counterpart of the CDNA and compositing half of
`pivp_tpu/ops/transforms.py` (the DNA and STP halves come with their
heads). CDNA is expressed over a shifted stack: the K*K zero-padded
spatial shifts of the previous frame, contracted against the predicted
kernels. The fused path collapses the masked CDNA mixture into one
per-pixel kernel and applies it with the local-apply kernel.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

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
