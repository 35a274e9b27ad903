"""The PyTorch port's CDNA and compositing transforms against the JAX
package's, on the same numpy inputs (float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pivp_tpu.ops import transforms as jt
from pivp_tpu_torch.ops import transforms as tt
from pivp_tpu_torch.ops.kernels import local_apply

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def _cdna_inputs(m=4, seed=0):
    r = np.random.RandomState(seed)
    prev = r.rand(2, 8, 8, 3).astype(np.float32)
    synth = r.rand(2, 8, 8, 3).astype(np.float32)
    raw = r.randn(2, m, 25).astype(np.float32)
    logits = (r.randn(2, 8, 8, m + 1) * 2).astype(np.float32)
    return prev, synth, raw, logits


@pytest.mark.parametrize("border_zero", [False, True])
@pytest.mark.parametrize("k", [3, 5])
def test_shifted_stack(border_zero, k):
    x = np.random.RandomState(k).randn(2, 7, 6, 3).astype(np.float32)
    want = jt.shifted_stack(jnp.asarray(x), k, border_zero)
    got = tt.shifted_stack(torch.as_tensor(x), k, border_zero)
    assert tuple(got.shape) == (2, k * k, 7, 6, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scramble", [False, True])
def test_mask_softmax(scramble):
    _, _, _, logits = _cdna_inputs()
    _close(tt.mask_softmax(torch.as_tensor(logits), scramble),
           jt.mask_softmax(jnp.asarray(logits), scramble))


def test_normalize_cdna_kernels():
    _, _, raw, _ = _cdna_inputs()
    _close(tt.normalize_cdna_kernels(torch.as_tensor(raw)),
           jt.normalize_cdna_kernels(jnp.asarray(raw)))


def test_cdna_apply():
    prev, _, raw, _ = _cdna_inputs()
    kern = np.array(jt.normalize_cdna_kernels(jnp.asarray(raw)))
    _close(tt.cdna_apply(torch.as_tensor(prev), torch.as_tensor(kern)),
           jt.cdna_apply(jnp.asarray(prev), jnp.asarray(kern)))


@pytest.mark.parametrize("scramble", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_fused_composite_matches_unfused_jax(scramble, use_kernel):
    """The port's fused composite (with and without the kernel wrapper)
    against the JAX candidate-stack formulation: cdna_apply, then
    mask_composite over synth + the first M-1 transforms."""
    prev, synth, raw, logits = _cdna_inputs()
    kern = np.array(jt.normalize_cdna_kernels(jnp.asarray(raw)))
    moved = jt.cdna_apply(jnp.asarray(prev), jnp.asarray(kern))
    cands = jnp.concatenate([jnp.asarray(synth)[:, None], moved], axis=1)
    want, _ = jt.mask_composite(jnp.asarray(prev), cands[:, :4],
                                jnp.asarray(logits), scramble)
    got = tt.fused_cdna_composite(
        torch.as_tensor(prev), torch.as_tensor(synth), torch.as_tensor(kern),
        torch.as_tensor(logits),
        local_apply=local_apply.local_kernel_apply if use_kernel else None,
        scramble=scramble)
    _close(got, want)


def test_mask_composite():
    prev, synth, raw, logits = _cdna_inputs(seed=2)
    kern = np.array(jt.normalize_cdna_kernels(jnp.asarray(raw)))
    cands = np.array(jnp.concatenate(
        [jnp.asarray(synth)[:, None],
         jt.cdna_apply(jnp.asarray(prev), jnp.asarray(kern))], axis=1))[:, :4]
    want, want_m = jt.mask_composite(jnp.asarray(prev), jnp.asarray(cands),
                                     jnp.asarray(logits))
    got, got_m = tt.mask_composite(torch.as_tensor(prev),
                                   torch.as_tensor(cands),
                                   torch.as_tensor(logits))
    _close(got, want)
    _close(got_m, want_m)


def test_quantize_frames_u8():
    x = np.concatenate([
        np.random.RandomState(4).uniform(-0.2, 1.2, 500),
        np.arange(256) / 255.0, (np.arange(255) + 0.5) / 255.0,
    ]).astype(np.float32)
    got = tt.quantize_frames_u8(torch.as_tensor(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jt.quantize_frames_u8(jnp.asarray(x))))
