"""The PyTorch port's metrics against the JAX package's, on the same numpy
inputs, in float32 and float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pivp_tpu.ops import metrics as jm
from pivp_tpu_torch.ops import metrics as tm

FNS = ("mean_squared_error", "peak_signal_to_noise_ratio", "per_image_mse",
       "psnr_per_image", "ssim_per_image", "structural_similarity",
       "ssim_global_per_image", "ssim_global")


def _pair(hw, seed=0):
    r = np.random.RandomState(seed)
    x = r.rand(3, hw, hw, 3).astype(np.float32)
    y = np.clip(x + r.randn(*x.shape).astype(np.float32) * 0.1, 0, 1)
    return x, y


@pytest.mark.parametrize("name", FNS)
@pytest.mark.parametrize("hw", [16, 8], ids=["windowed", "small_global"])
def test_metric_matches_jax_f32(name, hw):
    x, y = _pair(hw)
    want = getattr(jm, name)(jnp.asarray(x), jnp.asarray(y))
    got = getattr(tm, name)(torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_windowed_ssim_f64():
    x, y = (a.astype(np.float64) for a in _pair(16, seed=1))
    with jax.enable_x64(True):
        want = np.asarray(jm.ssim_per_image(jnp.asarray(x), jnp.asarray(y)))
    got = tm.ssim_per_image(torch.as_tensor(x), torch.as_tensor(y))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_ssim_identical_images_is_one():
    x, _ = _pair(16)
    got = tm.ssim_per_image(torch.as_tensor(x), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), 1.0, rtol=1e-5)
