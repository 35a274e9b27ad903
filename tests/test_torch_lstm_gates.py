"""The gate kernel's plain PyTorch version (what the port's wrapper
computes on a CPU tensor) against the JAX package's Pallas gate kernel
in interpret mode, at the model's channel widths, three forget biases
and both storage types. The CUDA kernel itself is held against the plain
version on the card (test_torch_gpu.py, chip_smoke.py)."""

import jax
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


def _cotangents(C, b=2, h=4, w=4, seed=1):
    r = np.random.RandomState(seed + C)
    return (r.randn(b, h, w, C).astype(np.float32),
            r.randn(b, h, w, C).astype(np.float32))


@pytest.mark.parametrize("C", [32, 64, 128])
@pytest.mark.parametrize("forget_bias", [0.0, 1.0, 5.0])
@pytest.mark.parametrize("zero", [None, "c", "h"])
def test_bwd_plain_matches_pallas_interpret(C, forget_bias, zero):
    gates, c = _data(C)
    g_c, g_h = _cotangents(C)
    if zero == "c":
        g_c = np.zeros_like(g_c)
    if zero == "h":
        g_h = np.zeros_like(g_h)
    want = jlg._bwd_call(jnp.asarray(gates), jnp.asarray(c),
                         jnp.asarray(g_c), jnp.asarray(g_h), forget_bias,
                         True)
    # The port takes a zero cotangent as None (what autograd passes for
    # an unused output).
    got = tlg.fused_lstm_gates_bwd(
        torch.as_tensor(gates), torch.as_tensor(c),
        None if zero == "c" else torch.as_tensor(g_c),
        None if zero == "h" else torch.as_tensor(g_h), forget_bias)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("C", [32, 64, 128])
def test_autograd_matches_jax_grad_of_pallas_vjp(C):
    gates, c = _data(C)
    g_c, g_h = _cotangents(C)

    def jloss(gt, cc):
        nc, nh = jlg.fused_lstm_gates(gt, cc, 1.0, True)
        return jnp.sum(nc * g_c) + jnp.sum(nh * g_h)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(gates),
                                           jnp.asarray(c))
    gt = torch.tensor(gates, requires_grad=True)
    cc = torch.tensor(c, requires_grad=True)
    nc, nh = tlg.fused_lstm_gates(gt, cc, 1.0)
    (nc * torch.as_tensor(g_c) + nh * torch.as_tensor(g_h)).sum().backward()
    for got, w in ((gt.grad, want[0]), (cc.grad, want[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_unused_output_passes_none_and_counts_no_launch():
    gates, c = (torch.tensor(a, requires_grad=True) for a in _data(32))
    before = tlg.fused_lstm_gates_bwd.launches
    _, nh = tlg.fused_lstm_gates(gates, c)
    nh.sum().backward()
    assert tlg.fused_lstm_gates_bwd.launches == before
    want, _ = tlg.fused_lstm_gates_bwd_plain(
        gates.detach(), c.detach(), None, torch.ones_like(nh), 1.0)
    torch.testing.assert_close(gates.grad, want, rtol=0, atol=0)


@pytest.mark.parametrize("forget_bias", [0.0, 1.0, 5.0])
def test_gradcheck_float64(forget_bias):
    r = np.random.RandomState(7)
    gates = torch.tensor(r.randn(2, 3, 3, 8), requires_grad=True)
    c = torch.tensor(r.randn(2, 3, 3, 2), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda g, cc: tlg.fused_lstm_gates(g, cc, forget_bias),
        (gates, c), eps=1e-6, atol=1e-8, rtol=1e-6)
