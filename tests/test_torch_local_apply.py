"""The local-apply kernel's plain PyTorch version (what the port's wrapper
computes on a CPU tensor) against the JAX package's Pallas kernel in
interpret mode and its shifted-stack reference. The CUDA kernel itself
is held against the plain version on the card (test_torch_gpu.py,
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pivp_tpu.ops.pallas import local_apply as jla
from pivp_tpu_torch.ops.kernels import local_apply as tla


def _data(b, h, w, c, k, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(b, h, w, c).astype(np.float32)
    wts = r.rand(b, h, w, k * k).astype(np.float32)
    return x, wts / wts.sum(-1, keepdims=True)


@pytest.mark.parametrize("shape,k", [
    ((2, 8, 8, 3), 5),
    ((2, 8, 8, 3), 3),
    ((1, 12, 10, 5), 5),          # non-square frame, C not a multiple of 4
    ((1, 136, 8, 3), 5),          # H > 128: the JAX tiled layout's regime
])
def test_plain_matches_pallas_interpret(shape, k):
    x, w = _data(*shape, k)
    want_pallas = np.asarray(jla.local_kernel_apply(jnp.asarray(x),
                                                    jnp.asarray(w), True))
    want_ref = np.asarray(jla.local_kernel_apply_reference(
        jnp.asarray(x), jnp.asarray(w)))
    got = tla.local_kernel_apply(torch.as_tensor(x), torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-5, atol=1e-6)


def test_cpu_wrapper_counts_no_launch():
    x, w = _data(1, 6, 6, 3, 5)
    before = tla.local_kernel_apply.launches
    tla.local_kernel_apply(torch.as_tensor(x), torch.as_tensor(w))
    assert tla.local_kernel_apply.launches == before


def test_rejects_even_kernel():
    with pytest.raises(ValueError, match="odd square"):
        tla.local_kernel_apply_plain(torch.zeros(1, 4, 4, 3),
                                     torch.zeros(1, 4, 4, 16))


def test_rejects_meta_device():
    x = torch.empty(1, 4, 4, 3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tla.local_kernel_apply(x, torch.empty(1, 4, 4, 25, device="meta"))
