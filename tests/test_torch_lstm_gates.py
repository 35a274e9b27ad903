"""The gate kernel's plain PyTorch version (what the port's wrapper
computes on a CPU tensor) against the JAX package's Pallas gate kernel
in interpret mode, at the model's channel widths, three forget biases
and both storage types. The CUDA kernel itself is held against the plain
version on the card (test_torch_gpu.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pivp_tpu.ops.pallas import lstm_gates as jlg
from pivp_tpu_torch.ops.kernels import lstm_gates as tlg


def _data(C, b=2, h=4, w=4, seed=0):
    r = np.random.RandomState(seed + C)
    gates = (r.randn(b, h, w, 4 * C) * 1.5).astype(np.float32)
    c = r.randn(b, h, w, C).astype(np.float32)
    return gates, c


@pytest.mark.parametrize("C", [32, 64, 128])
@pytest.mark.parametrize("forget_bias", [0.0, 1.0, 5.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(C, forget_bias, dtype):
    gates, c = _data(C)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    want_c, want_h = jlg.fused_lstm_gates(
        jnp.asarray(gates).astype(jdt), jnp.asarray(c).astype(jdt),
        forget_bias, interpret=True)
    got_c, got_h = tlg.fused_lstm_gates(
        torch.as_tensor(gates).to(tdt), torch.as_tensor(c).to(tdt),
        forget_bias)
    assert got_c.dtype == tdt and got_h.dtype == tdt
    # f32: one rounding apart; bf16 storage: a bf16 ulp (the JAX
    # package's own bf16 kernel tolerance is 1e-2).
    tol = 1e-6 if dtype == "float32" else 1e-2
    for got, want in ((got_c, want_c), (got_h, want_h)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


def test_float64_carry_keeps_float64_math():
    gates, c = (a.astype(np.float64) for a in _data(32))
    got_c, _ = tlg.fused_lstm_gates(torch.tensor(gates), torch.tensor(c))
    want = (c / (1 + np.exp(-(gates[..., 64:96] + 1.0)))
            + np.tanh(gates[..., :32]) / (1 + np.exp(-gates[..., 32:64])))
    assert got_c.dtype == torch.float64
    np.testing.assert_allclose(got_c.numpy(), want, rtol=1e-12, atol=1e-12)


def test_rejects_bad_gate_width():
    with pytest.raises(ValueError, match="4\\*C"):
        tlg._check(torch.zeros(2, 4, 4, 30), torch.zeros(2, 4, 4, 8))
