"""Fused ConvLSTM gate update: the CUDA kernel's wrapper and its plain
PyTorch version.

    j, i, f, o = split(gates, 4, axis=-1)          # (B, H, W, C) each
    new_c = c * sigmoid(f + forget_bias) + sigmoid(i) * tanh(j)
    new_h = tanh(new_c) * sigmoid(o)

Counterpart of `pivp_tpu/ops/pallas/lstm_gates.py` (forward only; the
backward kernel comes with the training slice). The kernel is
`csrc/lstm_gates.cu`; its note says what bounds it and how it is laid
out. Gate math is float32 whatever the storage type (float64 on the CPU
path for a float64 carry); outputs are in c's type.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pivp_tpu_torch.ops.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


def fused_lstm_gates_plain(gates: torch.Tensor, c: torch.Tensor,
                           forget_bias: float = 1.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split / sigmoid / tanh, as the JAX package's
    `fused_lstm_gates_reference`."""
    acc = torch.promote_types(c.dtype, torch.float32)
    j, i, f, o = torch.chunk(gates.to(acc), 4, dim=-1)
    new_c = (c.to(acc) * torch.sigmoid(f + forget_bias)
             + torch.sigmoid(i) * torch.tanh(j))
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    return new_c.to(c.dtype), new_h.to(c.dtype)


def _check(gates: torch.Tensor, c: torch.Tensor) -> int:
    C = c.shape[-1]
    if gates.shape[:-1] != c.shape[:-1] or gates.shape[-1] != 4 * C:
        raise ValueError(f"gates {tuple(gates.shape)} is not c "
                         f"{tuple(c.shape)} with a 4*C last dim")
    if c.dtype not in _DTYPES or gates.dtype != c.dtype:
        raise TypeError(f"fused_lstm_gates takes float32 or bfloat16 "
                        f"gates and c of one type, got {gates.dtype}, "
                        f"{c.dtype}")
    if gates.device != c.device:
        raise ValueError("gates and c are on different devices")
    if not (gates.is_contiguous() and c.is_contiguous()):
        raise ValueError("fused_lstm_gates takes contiguous tensors")
    return C


def fused_lstm_gates(gates: torch.Tensor, c: torch.Tensor,
                     forget_bias: float = 1.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ConvLSTM gate update: gates (..., 4C) pre-activation conv
    output in (j, i, f, o) block order, c (..., C) carry. Returns (new_c,
    new_h) in c's type. On a CUDA tensor this launches the CUDA kernel
    (and counts the launch in `fused_lstm_gates.launches`); on a CPU
    tensor it computes the plain version."""
    if gates.device.type == "cpu" and c.device.type == "cpu":
        return fused_lstm_gates_plain(gates, c, forget_bias)
    if c.device.type != "cuda":
        raise ValueError(f"fused_lstm_gates runs on cuda or cpu, got "
                         f"{c.device}")
    C = _check(gates, c)
    new_c = torch.empty_like(c)
    new_h = torch.empty_like(c)
    lib, _ = build.load()
    err = lib.pivp_lstm_gates_fwd(
        gates.data_ptr(), c.data_ptr(), new_c.data_ptr(), new_h.data_ptr(),
        c.numel() // max(C, 1), C, float(forget_bias),
        int(c.dtype == torch.bfloat16), c.device.index or 0,
        torch.cuda.current_stream(c.device).cuda_stream)
    build.check(err, "pivp_lstm_gates_fwd")
    fused_lstm_gates.launches += 1
    return new_c, new_h


fused_lstm_gates.launches = 0
