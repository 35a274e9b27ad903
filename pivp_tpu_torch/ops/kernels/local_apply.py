"""Per-pixel K*K local kernel application: the CUDA kernel's wrapper and
its plain PyTorch version.

    y[b, h, w, c] = sum_t  W[b, h, w, t] * x_pad[b, h + dx_t, w + dy_t, c]
    (t = dx*K + dy, pad = K//2, zero padding)

Counterpart of `pivp_tpu/ops/pallas/local_apply.py` (forward only; the
backward kernels come with the training slice). The kernel is
`csrc/local_apply.cu`; its note says what bounds it and how it is laid
out.
"""

from __future__ import annotations

import math

import torch

from pivp_tpu_torch.ops.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


def kernel_size(w: torch.Tensor) -> int:
    ksq = w.shape[-1]
    k = int(round(math.sqrt(ksq)))
    if k * k != ksq or k % 2 == 0:
        raise ValueError(f"w's last dim {ksq} is not an odd square")
    return k


def local_kernel_apply_plain(x: torch.Tensor,
                             w: torch.Tensor) -> torch.Tensor:
    """Shifted stack plus einsum, as the JAX package's
    `local_kernel_apply_reference`."""
    from pivp_tpu_torch.ops import transforms

    stack = transforms.shifted_stack(x, kernel_size(w))
    return torch.einsum("bkhwc,bhwk->bhwc", stack, w.to(stack.dtype))


def _check(x: torch.Tensor, w: torch.Tensor) -> int:
    if x.ndim != 4 or w.ndim != 4 or x.shape[:3] != w.shape[:3]:
        raise ValueError(f"expected x (B,H,W,C) and w (B,H,W,K*K), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"local_kernel_apply takes float32 or bfloat16 "
                        f"x and w of one type, got {x.dtype}, {w.dtype}")
    if w.device != x.device:
        raise ValueError("x and w are on different devices")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("local_kernel_apply takes contiguous NHWC tensors")
    return kernel_size(w)


def local_kernel_apply(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[b,h,w,c] = sum_t W[b,h,w,t] * shift_t(x)[b,h,w,c].

    x: (B, H, W, C); w: (B, H, W, K*K) per-pixel kernels. On a CUDA
    tensor this launches the CUDA kernel (and counts the launch in
    `local_kernel_apply.launches`); on a CPU tensor it computes the plain
    version."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return local_kernel_apply_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"local_kernel_apply runs on cuda or cpu, got "
                         f"{x.device}")
    k = _check(x, w)
    b, h, wd, c = x.shape
    y = torch.empty_like(x)
    lib, _ = build.load()
    err = lib.pivp_local_apply_fwd(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, c, k,
        int(x.dtype == torch.bfloat16), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "pivp_local_apply_fwd")
    local_kernel_apply.launches += 1
    return y


local_kernel_apply.launches = 0
