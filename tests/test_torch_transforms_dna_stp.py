"""The PyTorch port's DNA and STP transforms against the JAX package's, on
the same numpy inputs: values and gradients (float32, and float64 where
stated)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pivp_tpu.ops import transforms as jt
from pivp_tpu_torch.ops import transforms as tt
from pivp_tpu_torch.ops.kernels import local_apply

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _vjp_jax(fn, args, cot):
    """fn's value and its vjp of `cot`, under one jit (one compile, not
    an eager dispatch per op)."""
    def run(args, cot):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cot)

    return jax.jit(run)(tuple(jnp.asarray(a) for a in args),
                        jnp.asarray(cot))


def _vjp_port(fn, args, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.as_tensor(cot))
    return out, grads


def _dna_inputs(seed=0):
    r = np.random.RandomState(seed)
    prev = r.rand(2, 9, 7, 3).astype(np.float32)
    logits = r.randn(2, 9, 7, 25).astype(np.float32)
    cot = r.randn(2, 9, 7, 3).astype(np.float32)
    return prev, logits, cot


@pytest.mark.parametrize("border_zero", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_dna_apply_values_and_gradients(use_kernel, border_zero):
    """The port's dna_apply, through the kernel wrapper or the shifted
    stack, against the JAX one's shifted-stack form; border_zero (the
    reference-literal windows) bypasses the wrapper in both."""
    prev, logits, cot = _dna_inputs()
    local = local_apply.local_kernel_apply if use_kernel else None
    want, want_g = _vjp_jax(
        lambda p, k: jt.dna_apply(p, k, border_zero=border_zero),
        (prev, logits), cot)
    got, got_g = _vjp_port(
        lambda p, k: tt.dna_apply(p, k, local_apply=local,
                                  border_zero=border_zero),
        (prev, logits), cot)
    _close(got, want)
    for g, w in zip(got_g, want_g):
        _close(g, w)


def test_dna_apply_kernel_gets_contiguous_operands():
    """enc7 is a channel slice of the merged output conv: the wrapper,
    which refuses strided NHWC tensors on the card, gets contiguous
    copies of the frame and the normalized kernels, in the frame's
    dtype."""
    prev, logits, _ = _dna_inputs(1)
    merged = np.concatenate([np.zeros((2, 9, 7, 2), np.float32), logits], -1)
    seen = []

    def spy(x, w):
        seen.append((x.is_contiguous(), w.is_contiguous(), w.dtype))
        return local_apply.local_kernel_apply(x, w)

    enc7 = torch.as_tensor(merged.astype(np.float64))[..., 2:]
    assert not enc7.is_contiguous()
    got = tt.dna_apply(torch.as_tensor(prev), enc7, local_apply=spy)
    assert seen == [(True, True, torch.float32)]
    _close(got, jt.dna_apply(jnp.asarray(prev), jnp.asarray(logits)))


@pytest.mark.parametrize("dtype,tol", [(np.float32, 6e-7),
                                       (np.float64, 1e-15)])
@pytest.mark.parametrize("n", [16, 64, 256])
def test_affine_grid(n, dtype, tol):
    """The grid against JAX's at 16, 64 and 256 points. The port builds
    the coordinates as jnp.linspace does (start*(1-s) + stop*s, endpoint
    appended); XLA's CPU code for that expression (a reciprocal and a
    fused multiply-add) still differs from it by an ulp at some points,
    as JAX's eager and jitted linspace differ from each other. Found:
    at most 4.8e-7 in float32 (two ulps of a coordinate past 1) and
    4.5e-16 in float64."""
    r = np.random.RandomState(n)
    theta = (np.eye(2, 3)[None, None]
             + 0.2 * r.randn(2, 3, 2, 3)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jt.affine_grid(jnp.asarray(theta), (n, n)))
    got = tt.affine_grid(torch.as_tensor(theta), (n, n))
    assert tuple(got.shape) == (2, 3, n, n, 2) and got.dtype == \
        torch.as_tensor(theta).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("n", [16, 64, 256])
def test_grid_coordinates_nearer_jax_than_torch_linspace(n):
    """Source columns floor((x+1)(W-1)/2) of the identity grid: the
    port's construction puts fewer of them in another cell than
    torch.linspace would (where the sampler's derivative is one-sided)."""
    ident = np.eye(2, 3, dtype=np.float32)[None]
    want = np.asarray(jt.affine_grid(jnp.asarray(ident), (n, n)))[0, 0, :, 0]
    got = tt.affine_grid(torch.as_tensor(ident), (n, n))[0, 0, :, 0]
    lin = torch.linspace(-1.0, 1.0, n)

    def cells(x):
        return np.floor((np.asarray(x) + 1.0) * (n - 1) / 2.0)

    moved = int((cells(got) != cells(want)).sum())
    assert moved < int((cells(lin) != cells(want)).sum())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1.2e-7)


def _sample_inputs(lead, seed=0):
    r = np.random.RandomState(seed)
    image = r.rand(2, 8, 6, 3).astype(np.float32)
    # Coordinates reaching past the border on every side (zero padding).
    grid = r.uniform(-1.3, 1.3, (2,) + lead + (2,)).astype(np.float32)
    cot = r.randn(*((2,) + lead + (3,))).astype(np.float32)
    return image, grid, cot


@pytest.mark.parametrize("lead", [(5, 4), (3, 5, 4)],
                         ids=["one_warp", "three_warps"])
@pytest.mark.parametrize("sampler", ["bilinear_sample",
                                     "bilinear_sample_matmul"])
def test_samplers_values_and_gradients(sampler, lead):
    image, grid, cot = _sample_inputs(lead)
    want, want_g = _vjp_jax(getattr(jt, sampler), (image, grid), cot)
    got, got_g = _vjp_port(getattr(tt, sampler), (image, grid), cot)
    assert tuple(got.shape) == (2,) + lead + (3,)
    _close(got, want)
    for g, w in zip(got_g, want_g):
        _close(g, w)


def test_samplers_agree_with_each_other():
    image, grid, _ = _sample_inputs((3, 7, 5), seed=3)
    a = tt.bilinear_sample(torch.as_tensor(image), torch.as_tensor(grid))
    b = tt.bilinear_sample_matmul(torch.as_tensor(image),
                                  torch.as_tensor(grid))
    _close(a, b.numpy(), 1e-6)


@pytest.mark.parametrize("use_matmul", [True, False])
@pytest.mark.parametrize("stack", [False, True],
                         ids=["one_theta", "per_mask_thetas"])
def test_stp_apply_values_and_gradients(stack, use_matmul):
    """stp_apply with theta (B, 2, 3) or a (B, M, 2, 3) stack: values and
    gradients in the frame and in theta, float64 (where a tap's weight
    is one-sided at an integer coordinate, float32's rounding of the
    grid could pick the other side)."""
    r = np.random.RandomState(7)
    image = r.rand(2, 12, 10, 3)
    shape = (2, 3, 2, 3) if stack else (2, 2, 3)
    theta = np.broadcast_to(np.eye(2, 3), shape) + 0.3 * r.randn(*shape)
    cot = r.randn(*(shape[:-2] + (12, 10, 3)))
    with jax.enable_x64(True):
        want, want_g = _vjp_jax(
            lambda i, t: jt.stp_apply(i, t, use_matmul=use_matmul),
            (image, theta), cot)
        want_g = [np.asarray(g) for g in want_g]
        want = np.asarray(want)
    got, got_g = _vjp_port(
        lambda i, t: tt.stp_apply(i, t, use_matmul=use_matmul),
        (image, theta), cot)
    _close(got, want, 1e-12)
    for g, w in zip(got_g, want_g):
        _close(g, w, 1e-12)


def test_identity_warp_returns_the_frame():
    # Values, not bits: the grid's coordinates are within an ulp of the
    # pixel centres.
    image = np.random.RandomState(9).rand(2, 16, 16, 3).astype(np.float32)
    theta = np.broadcast_to(np.eye(2, 3, dtype=np.float32), (2, 2, 3))
    for use_matmul in (True, False):
        got = tt.stp_apply(torch.as_tensor(image),
                           torch.as_tensor(theta.copy()), use_matmul)
        _close(got, image, 1e-6)
