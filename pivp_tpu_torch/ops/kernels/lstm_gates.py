"""Fused ConvLSTM gate update: the `torch.ops.pivp` ops that launch the
CUDA kernels, their wrappers, the autograd Function around them and
their plain PyTorch versions.

    j, i, f, o = split(gates, 4, axis=-1)          # (B, H, W, C) each
    new_c = c * sigmoid(f + forget_bias) + sigmoid(i) * tanh(j)
    new_h = tanh(new_c) * sigmoid(o)

Counterpart of `pivp_tpu/ops/pallas/lstm_gates.py`, forward and backward
(its custom VJP becomes a `torch.autograd.Function`). The kernels are in
`csrc/lstm_gates.cu`; its note says what bounds them and how they are
laid out. Gate math is float32 whatever the storage type (float64 on the
CPU path for a float64 carry); outputs are in c's type.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pivp_tpu_torch.ops.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


def _acc_dtype(c: torch.Tensor) -> torch.dtype:
    return torch.promote_types(c.dtype, torch.float32)


def fused_lstm_gates_plain(gates: torch.Tensor, c: torch.Tensor,
                           forget_bias: float = 1.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split / sigmoid / tanh, as the JAX package's
    `fused_lstm_gates_reference`."""
    acc = _acc_dtype(c)
    j, i, f, o = torch.chunk(gates.to(acc), 4, dim=-1)
    new_c = (c.to(acc) * torch.sigmoid(f + forget_bias)
             + torch.sigmoid(i) * torch.tanh(j))
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    return new_c.to(c.dtype), new_h.to(c.dtype)


def fused_lstm_gates_bwd_plain(gates: torch.Tensor, c: torch.Tensor,
                               g_newc: Optional[torch.Tensor],
                               g_newh: Optional[torch.Tensor],
                               forget_bias: float = 1.0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dgates, dc) from the cotangents of (new_c, new_h), recomputing
    the activations from (gates, c) as the JAX package's `_bwd_kernel`
    does. A None cotangent counts as zero."""
    acc = _acc_dtype(c)
    j, i, f, o = torch.chunk(gates.to(acc), 4, dim=-1)
    cc = c.to(acc)
    zero = torch.zeros((), dtype=acc, device=c.device)
    g_c = zero if g_newc is None else g_newc.to(acc)
    g_h = zero if g_newh is None else g_newh.to(acc)
    s_i, s_f, s_o = (torch.sigmoid(i), torch.sigmoid(f + forget_bias),
                     torch.sigmoid(o))
    t_j = torch.tanh(j)
    t_c = torch.tanh(cc * s_f + s_i * t_j)
    dct = g_c + g_h * s_o * (1.0 - t_c * t_c)
    dgates = torch.cat([
        dct * s_i * (1.0 - t_j * t_j),
        dct * t_j * (s_i * (1.0 - s_i)),
        dct * cc * (s_f * (1.0 - s_f)),
        g_h * t_c * (s_o * (1.0 - s_o)),
    ], dim=-1)
    return dgates.to(gates.dtype), (dct * s_f).to(c.dtype)


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


def _cotangent(g: Optional[torch.Tensor], c: torch.Tensor):
    """A cotangent as the kernel takes it: c's type, contiguous, on c's
    device; None stays None (a null pointer, read as zero)."""
    if g is None:
        return None
    if g.shape != c.shape or g.device != c.device:
        raise ValueError(f"cotangent {tuple(g.shape)} on {g.device} does "
                         f"not match c {tuple(c.shape)} on {c.device}")
    return g.to(c.dtype).contiguous()


# The dispatcher ops, as in local_apply.py: CUDA (the launch, counted),
# CPU (the plain version) and fake (shapes and dtypes only) for each.
# The backward's cotangents are optional: None reaches the kernel as a
# null pointer, which it reads as zero.
_LIB = torch.library.Library("pivp", "FRAGMENT")
_LIB.define("lstm_gates_fwd(Tensor gates, Tensor c, float forget_bias) "
            "-> (Tensor, Tensor)")
_LIB.define("lstm_gates_bwd(Tensor gates, Tensor c, Tensor? g_newc, "
            "Tensor? g_newh, float forget_bias) -> (Tensor, Tensor)")


def _fwd_cuda(gates: torch.Tensor, c: torch.Tensor, forget_bias: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
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


def _bwd_cuda(gates: torch.Tensor, c: torch.Tensor,
              g_newc: Optional[torch.Tensor], g_newh: Optional[torch.Tensor],
              forget_bias: float) -> Tuple[torch.Tensor, torch.Tensor]:
    C = _check(gates, c)
    g_c, g_h = _cotangent(g_newc, c), _cotangent(g_newh, c)
    dgates = torch.empty_like(gates)
    dc = torch.empty_like(c)
    lib, _ = build.load()
    err = lib.pivp_lstm_gates_bwd(
        gates.data_ptr(), c.data_ptr(),
        None if g_c is None else g_c.data_ptr(),
        None if g_h is None else g_h.data_ptr(),
        dgates.data_ptr(), dc.data_ptr(), c.numel() // max(C, 1), C,
        float(forget_bias), int(c.dtype == torch.bfloat16),
        c.device.index or 0,
        torch.cuda.current_stream(c.device).cuda_stream)
    build.check(err, "pivp_lstm_gates_bwd")
    fused_lstm_gates_bwd.launches += 1
    return dgates, dc


_LIB.impl("lstm_gates_fwd", _fwd_cuda, "CUDA")
_LIB.impl("lstm_gates_bwd", _bwd_cuda, "CUDA")
_LIB.impl("lstm_gates_fwd", fused_lstm_gates_plain, "CPU")
_LIB.impl("lstm_gates_bwd", fused_lstm_gates_bwd_plain, "CPU")


@torch.library.register_fake("pivp::lstm_gates_fwd", lib=_LIB)
def _fwd_fake(gates: torch.Tensor, c: torch.Tensor, forget_bias: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    return c.new_empty(c.shape), c.new_empty(c.shape)


@torch.library.register_fake("pivp::lstm_gates_bwd", lib=_LIB)
def _bwd_fake(gates: torch.Tensor, c: torch.Tensor,
              g_newc: Optional[torch.Tensor], g_newh: Optional[torch.Tensor],
              forget_bias: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return gates.new_empty(gates.shape), c.new_empty(c.shape)


def _require_device(t: torch.Tensor, name: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, got {t.device}")


_FWD = torch.ops.pivp.lstm_gates_fwd.default
_BWD = torch.ops.pivp.lstm_gates_bwd.default


def fused_lstm_gates_fwd(gates: torch.Tensor, c: torch.Tensor,
                         forget_bias: float = 1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward pass, outside autograd: the op `pivp::lstm_gates_fwd`.
    On CUDA tensors it launches the forward kernel (counted in
    `fused_lstm_gates.launches`); on CPU tensors it computes the plain
    version."""
    _require_device(c, "fused_lstm_gates")
    return _FWD(gates, c, float(forget_bias))


def fused_lstm_gates_bwd(gates: torch.Tensor, c: torch.Tensor,
                         g_newc: Optional[torch.Tensor],
                         g_newh: Optional[torch.Tensor],
                         forget_bias: float = 1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dgates, dc) from the cotangents of (new_c, new_h), either of which
    may be None for zero: the op `pivp::lstm_gates_bwd`. On CUDA tensors
    it launches the backward kernel (counted in
    `fused_lstm_gates_bwd.launches`), passing a None cotangent as a null
    pointer; on CPU tensors it computes the plain version."""
    _require_device(c, "fused_lstm_gates_bwd")
    return _BWD(gates, c, g_newc, g_newh, float(forget_bias))


class _FusedLSTMGates(torch.autograd.Function):
    """The JAX custom VJP: saves (gates, c) and recomputes the
    activations in the backward. Autograd passes None, not a tensor of
    zeros, for an output nothing used (set_materialize_grads(False))."""

    @staticmethod
    def forward(ctx, gates, c, forget_bias):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(gates, c)
        ctx.forget_bias = forget_bias
        return fused_lstm_gates_fwd(gates, c, forget_bias)

    @staticmethod
    def backward(ctx, g_newc, g_newh):
        if g_newc is None and g_newh is None:
            return None, None, None
        gates, c = ctx.saved_tensors
        dgates, dc = fused_lstm_gates_bwd(gates, c, g_newc, g_newh,
                                          ctx.forget_bias)
        return dgates, dc, None


def fused_lstm_gates(gates: torch.Tensor, c: torch.Tensor,
                     forget_bias: float = 1.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ConvLSTM gate update, differentiable in gates and c: gates
    (..., 4C) pre-activation conv output in (j, i, f, o) block order, c
    (..., C) carry. Returns (new_c, new_h) in c's type. On CUDA tensors
    the forward and backward launch the kernels (counted in
    `fused_lstm_gates.launches` and `fused_lstm_gates_bwd.launches`); on
    CPU tensors they compute the plain versions."""
    if torch.is_grad_enabled() and (gates.requires_grad or c.requires_grad):
        return _FusedLSTMGates.apply(gates, c, float(forget_bias))
    # Nothing to differentiate (inference): the same forward, without the
    # autograd Function's per-call cost.
    return fused_lstm_gates_fwd(gates, c, forget_bias)


fused_lstm_gates.launches = 0
fused_lstm_gates_bwd.launches = 0
