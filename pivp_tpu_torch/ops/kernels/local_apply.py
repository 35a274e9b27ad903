"""Per-pixel K*K local kernel application: the `torch.ops.pivp` ops
that launch the CUDA kernels, their wrappers, the autograd Function
around them and their plain PyTorch versions.

    y[b, h, w, c]  = sum_t  W[b, h, w, t] * x_pad[b, h + dx_t, w + dy_t, c]
    dW[b, h, w, t] = sum_c  g[b, h, w, c] * x_pad[b, h + dx_t, w + dy_t, c]
    dX             = sum_t  flipped-shift_t(W_t * g)
    (t = dx*K + dy, pad = K//2, zero padding)

Counterpart of `pivp_tpu/ops/pallas/local_apply.py`, forward and backward
(its custom VJP becomes a `torch.autograd.Function`). The kernels are in
`csrc/local_apply.cu`; its note says what bounds them and how they are
laid out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pivp_tpu_torch.ops.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)

# The tiled kernels (forward, dW): at most TILE_THREADS threads (one per
# pixel) and SMEM_LIMIT bytes of shared memory a block; the plan halves
# the rows of a tile while the grid has fewer than TARGET_BLOCKS blocks
# (about 16 per SM of an H100's 132, all resident at once at the main
# shape) and the block more than MIN_THREADS threads: at the main shape,
# one row of 64 pixels a block, which ran both kernels faster on the
# H100 than tiles of 2 or 4 rows.
TILE_THREADS = 256
MIN_THREADS = 64
TARGET_BLOCKS = 2048
SMEM_LIMIT = 232448
MAX_K = 15
# The dX kernel stages w and g with a halo of K//2 rows above and below
# its tile, so its tiles are taller: as many rows as a block's threads
# take, halved while the grid has fewer than BWD_X_BLOCKS blocks (two per
# SM of an H100, all resident at once at the main shape) but not below
# K - 1 rows, where the halo doubles what a tile reads. A block has up to
# BWD_X_THREADS threads, a thread a pixel; at K = 5, C = 3 (the main
# path) up to BWD_X_MAIN_THREADS, a thread for BWD_X_PER_THREAD rows of a
# column (the kernel's kBwdXThreads, kBwdXMainThreads, kBwdXPerThread).
# The kernel keeps an 8-byte barrier in static shared memory, which the
# block's dynamic shared memory leaves room for.
BWD_X_THREADS = 1024
BWD_X_MAIN_THREADS = 256
BWD_X_PER_THREAD = 2
BWD_X_BLOCKS = 256
BWD_X_SMEM_LIMIT = SMEM_LIMIT - 8


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A block owns `rows` rows of one sample over `cols` columns, and
    `smem` bytes of shared memory; `grid` is (column strips, row tiles,
    samples), the launch's blockIdx (x, y, z)."""
    rows: int
    cols: int
    smem: int
    grid: Tuple[int, int, int]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _halo_bytes(rows: int, cols: int, w: int, width: int, p: int,
                item: int) -> int:
    """An input staged with a halo of p rows and columns
    (csrc/local_apply.cu `Halo`): p pixels before the first row (rounded
    up to 16 bytes), rows + 2p staged rows (a full-width tile's as one
    span of the frame's rows, a column strip's with p columns each side)
    and p pixels after them, rounded up to 16 bytes."""
    stride = (cols if cols == w else cols + 2 * p) * width
    lead = _round_up(p * width, 16 // item)
    return _round_up((lead + (rows + 2 * p) * stride + p * width) * item, 16)


def tile_smem_bytes(rows: int, cols: int, w: int, c: int, k: int,
                    item: int) -> int:
    """The shared memory of one block (csrc/local_apply.cu `TileLayout`)
    for a frame `w` pixels wide, the same for the forward and dW: the
    K*K-wide tile (forward: w in; dW: dW out), the C-wide tile (forward:
    y out; dW: g in) and the x rows of the tile with their halo, in the
    storage type, each rounded up to 16 bytes."""
    px = rows * cols
    return (_round_up(px * k * k * item, 16) + _round_up(px * c * item, 16)
            + _halo_bytes(rows, cols, w, c, k // 2, item))


def bwd_x_smem_bytes(rows: int, cols: int, w: int, c: int, k: int,
                     item: int) -> int:
    """The shared memory of one dX block (csrc/local_apply.cu
    `BwdXLayout`): w (K*K wide) and g (C wide), each with its halo, and
    the dX tile, in the storage type, each rounded up to 16 bytes."""
    return (_halo_bytes(rows, cols, w, k * k, k // 2, item)
            + _halo_bytes(rows, cols, w, c, k // 2, item)
            + _round_up(rows * cols * c * item, 16))


def _fit(shape, k: int, item: int, rows: int, cols: int, smem_bytes,
         per: int = 1, limit: int = SMEM_LIMIT) -> TilePlan:
    """The plan of (rows, cols), with rows (kept a multiple of `per`) and
    then columns halved until the block fits in `limit` bytes of shared
    memory."""
    b, h, w, c = shape
    while smem_bytes(rows, cols, w, c, k, item) > limit:
        if rows > per:
            rows = _round_up((rows + 1) // 2, per)
        elif cols > 1:
            cols = (cols + 1) // 2
        else:
            raise ValueError(f"no tile of a ({h},{w},{c}) frame with "
                             f"K={k} fits in shared memory")
    return TilePlan(rows, cols, smem_bytes(rows, cols, w, c, k, item),
                    (-(-w // cols), -(-h // rows), b))


def _item(k: int, dtype: torch.dtype) -> int:
    if k > MAX_K:
        raise ValueError(f"the CUDA kernels take K up to {MAX_K}, got {k}")
    return torch.empty((), dtype=dtype).element_size()


def tile_plan(shape, k: int, dtype: torch.dtype) -> TilePlan:
    """The tile plan of the forward and dW kernels for x of `shape`
    (B, H, W, C): full-width tiles up to TILE_THREADS columns (column
    strips beyond), as many rows as the block's threads allow, halved
    while the grid is small; then rows, and then columns, halved until
    the block fits in shared memory."""
    b, h, w, _ = shape
    item = _item(k, dtype)
    cols = max(1, min(w, TILE_THREADS))
    rows = max(1, min(h, TILE_THREADS // cols))
    while (rows > 1 and b * -(-h // rows) * -(-w // cols) < TARGET_BLOCKS
           and rows * cols > MIN_THREADS):
        rows = (rows + 1) // 2
    return _fit(shape, k, item, rows, cols, tile_smem_bytes)


def bwd_x_block(k: int, c: int) -> Tuple[int, int]:
    """(rows of a column a dX thread computes, threads a block may have)."""
    if (k, c) == (5, 3):
        return BWD_X_PER_THREAD, BWD_X_MAIN_THREADS
    return 1, BWD_X_THREADS


def tile_plan_bwd_x(shape, k: int, dtype: torch.dtype,
                    rows: Optional[int] = None) -> TilePlan:
    """The tile plan of the dX kernel for g of `shape` (B, H, W, C):
    full-width tiles up to TILE_THREADS columns (column strips beyond),
    as many rows as a block's threads take, halved while the grid has
    fewer than BWD_X_BLOCKS blocks and the tile keeps K - 1 rows (or
    `rows` rows, as many as the threads take, to time another plan), in
    whole rows of threads; then rows, and then columns, halved until the
    block fits in shared memory."""
    b, h, w, c = shape
    item = _item(k, dtype)
    per, threads = bwd_x_block(k, c)
    cols = max(1, min(w, TILE_THREADS))
    most = per * max(1, threads // cols)
    if rows is None:
        rows = most
        while (rows > 1 and (rows + 1) // 2 >= k - 1
               and b * -(-h // rows) * -(-w // cols) < BWD_X_BLOCKS):
            rows = (rows + 1) // 2
    rows = _round_up(max(1, min(h, rows, most)), per)
    return _fit(shape, k, item, rows, cols, bwd_x_smem_bytes, per,
                BWD_X_SMEM_LIMIT)


def kernel_size(w: torch.Tensor) -> int:
    ksq = w.shape[-1]
    k = int(round(math.sqrt(ksq)))
    if k * k != ksq or k % 2 == 0:
        raise ValueError(f"w's last dim {ksq} is not an odd square")
    return k


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def local_kernel_apply_plain(x: torch.Tensor,
                             w: torch.Tensor) -> torch.Tensor:
    """Shifted stack plus einsum, as the JAX package's
    `local_kernel_apply_reference`."""
    from pivp_tpu_torch.ops import transforms

    stack = transforms.shifted_stack(x, kernel_size(w))
    return torch.einsum("bkhwc,bhwk->bhwc", stack, w.to(stack.dtype))


def local_kernel_apply_bwd_w_plain(x: torch.Tensor, g: torch.Tensor,
                                   k: int) -> torch.Tensor:
    """dW: each tap's shifted x dotted with g over the channels."""
    from pivp_tpu_torch.ops import transforms

    acc = _acc_dtype(x)
    stack = transforms.shifted_stack(x.to(acc), k)
    return torch.einsum("bkhwc,bhwc->bhwk", stack, g.to(acc)).to(x.dtype)


def local_kernel_apply_bwd_x_plain(w: torch.Tensor,
                                   g: torch.Tensor) -> torch.Tensor:
    """dX: each tap's w_t * g, zero-padded and read at the flipped shift
    (2p - dx, 2p - dy), summed over the taps."""
    k = kernel_size(w)
    pad = k // 2
    acc = _acc_dtype(g)
    _, h, wd, _ = g.shape
    prod = w.to(acc)[..., :, None] * g.to(acc)[..., None, :]  # B,H,W,KK,C
    padded = F.pad(prod, (0, 0, 0, 0, pad, pad, pad, pad))
    dx = torch.zeros_like(g, dtype=acc)
    for t in range(k * k):
        fx, fy = 2 * pad - t // k, 2 * pad - t % k
        dx = dx + padded[:, fx:fx + h, fy:fy + wd, t]
    return dx.to(g.dtype)


def local_kernel_apply_bwd_plain(x: torch.Tensor, w: torch.Tensor,
                                 g: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) from the cotangent g of y, as the JAX package's
    `_bwd_call` computes them."""
    return (local_kernel_apply_bwd_x_plain(w, g),
            local_kernel_apply_bwd_w_plain(x, g, kernel_size(w)))


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    """Two NHWC operands of one kernel: (B, H, W, *) each, one type
    (float32 or bfloat16), one device, contiguous."""
    if a.ndim != 4 or b.ndim != 4 or a.shape[:3] != b.shape[:3]:
        raise ValueError(f"expected two (B,H,W,*) tensors of one frame, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"local_kernel_apply takes float32 or bfloat16 "
                        f"tensors of one type, got {a.dtype}, {b.dtype}")
    if b.device != a.device:
        raise ValueError("the operands are on different devices")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("local_kernel_apply takes contiguous NHWC tensors")


def _launch(name: str, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
            shape, k: int, plan: TilePlan) -> None:
    bsz, h, wd, c = shape
    lib, _ = build.load()
    err = getattr(lib, name)(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, h, wd, c, k,
        plan.rows, plan.cols, plan.smem, int(a.dtype == torch.bfloat16),
        a.device.index or 0, torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, name)


# The dispatcher ops. Each kernel launch is an op of the `pivp`
# namespace, so that a traced graph (torch.export) holds the launch as a
# node and a replay of that graph launches the kernel. An op has three
# implementations: CUDA (the launch, counted), CPU (the plain version)
# and fake (shapes and dtypes only, for tracing; it builds nothing).
# They are registered when this module is imported; the kernels build at
# the first CUDA launch.
_LIB = torch.library.Library("pivp", "FRAGMENT")
_LIB.define("local_apply_fwd(Tensor x, Tensor w) -> Tensor")
_LIB.define("local_apply_bwd_w(Tensor x, Tensor g, int k) -> Tensor")
_LIB.define("local_apply_bwd_x(Tensor w, Tensor g) -> Tensor")


def _fwd_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check(x, w)
    k = kernel_size(w)
    y = torch.empty_like(x)
    _launch("pivp_local_apply_fwd", x, w, y, x.shape, k,
            tile_plan(x.shape, k, x.dtype))
    local_kernel_apply.launches += 1
    return y


def _bwd_w_cuda(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    _check(x, g)
    if g.shape != x.shape:
        raise ValueError(f"cotangent {tuple(g.shape)} is not x's shape "
                         f"{tuple(x.shape)}")
    dw = x.new_empty(x.shape[:3] + (k * k,))
    _launch("pivp_local_apply_bwd_w", x, g, dw, x.shape, k,
            tile_plan(x.shape, k, x.dtype))
    local_kernel_apply_bwd_w.launches += 1
    return dw


def _bwd_x_cuda(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    _check(w, g)
    k = kernel_size(w)
    dx = torch.empty_like(g)
    _launch("pivp_local_apply_bwd_x", w, g, dx, g.shape, k,
            tile_plan_bwd_x(g.shape, k, g.dtype))
    local_kernel_apply_bwd_x.launches += 1
    return dx


_LIB.impl("local_apply_fwd", _fwd_cuda, "CUDA")
_LIB.impl("local_apply_bwd_w", _bwd_w_cuda, "CUDA")
_LIB.impl("local_apply_bwd_x", _bwd_x_cuda, "CUDA")
_LIB.impl("local_apply_fwd", local_kernel_apply_plain, "CPU")
_LIB.impl("local_apply_bwd_w", local_kernel_apply_bwd_w_plain, "CPU")
_LIB.impl("local_apply_bwd_x", local_kernel_apply_bwd_x_plain, "CPU")


@torch.library.register_fake("pivp::local_apply_fwd", lib=_LIB)
def _fwd_fake(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.new_empty(x.shape)


@torch.library.register_fake("pivp::local_apply_bwd_w", lib=_LIB)
def _bwd_w_fake(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    return x.new_empty(x.shape[:3] + (k * k,))


@torch.library.register_fake("pivp::local_apply_bwd_x", lib=_LIB)
def _bwd_x_fake(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return g.new_empty(g.shape)


def _require_device(t: torch.Tensor, name: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, got {t.device}")


_FWD = torch.ops.pivp.local_apply_fwd.default
_BWD_W = torch.ops.pivp.local_apply_bwd_w.default
_BWD_X = torch.ops.pivp.local_apply_bwd_x.default


def local_kernel_apply_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward pass, outside autograd: the op `pivp::local_apply_fwd`.
    On CUDA tensors it launches the forward kernel (counted in
    `local_kernel_apply.launches`); on CPU tensors it computes the plain
    version."""
    _require_device(x, "local_kernel_apply")
    return _FWD(x, w)


def local_kernel_apply_bwd_w(x: torch.Tensor, g: torch.Tensor,
                             k: int) -> torch.Tensor:
    """dW (B, H, W, K*K) from x and the cotangent g (B, H, W, C): the op
    `pivp::local_apply_bwd_w`. On CUDA tensors it launches the dW kernel
    (counted in `local_kernel_apply_bwd_w.launches`); on CPU tensors it
    computes the plain version."""
    _require_device(x, "local_kernel_apply_bwd_w")
    return _BWD_W(x, g, k)


def local_kernel_apply_bwd_x(w: torch.Tensor, g: torch.Tensor
                             ) -> torch.Tensor:
    """dX (B, H, W, C) from w and the cotangent g (B, H, W, C): the op
    `pivp::local_apply_bwd_x`. On CUDA tensors it launches the dX kernel
    (counted in `local_kernel_apply_bwd_x.launches`); on CPU tensors it
    computes the plain version."""
    _require_device(w, "local_kernel_apply_bwd_x")
    return _BWD_X(w, g)


class _LocalKernelApply(torch.autograd.Function):
    """The JAX custom VJP: saves (x, w); the backward computes both dx
    and dw, as the JAX `_bwd_call` does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return local_kernel_apply_fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        return (local_kernel_apply_bwd_x(w, g),
                local_kernel_apply_bwd_w(x, g, kernel_size(w)))


def local_kernel_apply(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[b,h,w,c] = sum_t W[b,h,w,t] * shift_t(x)[b,h,w,c], differentiable
    in x and w.

    x: (B, H, W, C); w: (B, H, W, K*K) per-pixel kernels. On CUDA tensors
    the forward launches the forward kernel and the backward the dX and
    dW kernels (counted in `local_kernel_apply.launches`,
    `local_kernel_apply_bwd_x.launches` and
    `local_kernel_apply_bwd_w.launches`); on CPU tensors they compute the
    plain versions."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _LocalKernelApply.apply(x, w)
    # Nothing to differentiate (inference): the same forward, without the
    # autograd Function's per-call cost.
    return local_kernel_apply_fwd(x, w)


local_kernel_apply.launches = 0
local_kernel_apply_bwd_w.launches = 0
local_kernel_apply_bwd_x.launches = 0
