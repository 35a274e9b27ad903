"""The PyTorch port's layer primitives against the JAX package's, on the
same numpy inputs and weights (JAX layouts mapped by the weight bridge),
float32 at 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pivp_tpu.ops import layers as jl
from pivp_tpu_torch.ops import layers as tl
from pivp_tpu_torch.utils import weights

TOL = 1e-5


def _rng(seed=0):
    return np.random.RandomState(seed)


def _port(name, p):
    """JAX {'w', 'b'} numpy params -> the port's layout for layer `name`."""
    flat = {f"{name}/{k}": v for k, v in p.items()}
    return weights.from_jax_params(flat)[name]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d(k, stride):
    r = _rng(k * 10 + stride)
    x = r.randn(2, 16, 16, 6).astype(np.float32)
    p = {"w": r.randn(k, k, 6, 8).astype(np.float32) * 0.2,
         "b": r.randn(8).astype(np.float32)}
    want = jl.conv2d({n: jnp.asarray(v) for n, v in p.items()},
                     jnp.asarray(x), stride=stride)
    got = tl.conv2d(_port("enc0", p), torch.as_tensor(x), stride=stride)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("in_hw,out_hw,k,stride,pad,layer", [
    ((2, 2), (4, 4), 3, 2, 1, "enc4"),      # enc4: H/8 -> H/4
    ((4, 4), (8, 8), 3, 2, 1, "enc5"),      # enc5: H/4 -> H/2
    ((8, 8), (16, 16), 3, 2, 1, "enc6"),    # enc6: H/2 -> H
    ((16, 16), (16, 16), 1, 1, 0, "masks"),  # 1x1 masks / enc7
])
def test_deconv2d(in_hw, out_hw, k, stride, pad, layer):
    r = _rng(in_hw[0])
    x = r.randn(2, *in_hw, 5).astype(np.float32)
    p = {"w": r.randn(k, k, 5, 7).astype(np.float32) * 0.2,
         "b": r.randn(7).astype(np.float32)}
    want = jl.deconv2d({n: jnp.asarray(v) for n, v in p.items()},
                       jnp.asarray(x), stride=stride, padding=pad,
                       outsize=out_hw)
    got = tl.deconv2d(_port(layer, p), torch.as_tensor(x), stride=stride,
                      padding=pad, outsize=out_hw)
    assert tuple(got.shape) == (2, *out_hw, 7)
    _close(got, want)


def test_deconv2d_rejects_unreachable_outsize():
    p = {"w": torch.zeros(5, 7, 3, 3), "b": torch.zeros(7)}
    with pytest.raises(ValueError, match="unreachable"):
        tl.deconv2d(p, torch.zeros(1, 4, 4, 5), stride=2, padding=1,
                    outsize=(10, 10))


def test_layer_norm_flat():
    r = _rng(7)
    x = (r.randn(3, 8, 8, 4) * 3 + 1).astype(np.float32)
    p = {"scale": r.rand(8, 8, 4).astype(np.float32) + 0.5,
         "bias": r.randn(8, 8, 4).astype(np.float32)}
    want = jl.layer_norm_flat({n: jnp.asarray(v) for n, v in p.items()},
                              jnp.asarray(x), 1e-6)
    got = tl.layer_norm_flat({n: torch.as_tensor(v) for n, v in p.items()},
                             torch.as_tensor(x), 1e-6)
    _close(got, want)


def test_dense():
    r = _rng(9)
    x = r.randn(4, 10).astype(np.float32)
    p = {"w": r.randn(10, 5).astype(np.float32),
         "b": r.randn(5).astype(np.float32)}
    want = jl.dense({n: jnp.asarray(v) for n, v in p.items()},
                    jnp.asarray(x))
    got = tl.dense(_port("state_pred", p), torch.as_tensor(x))
    _close(got, want)


def test_glorot_bounds_and_determinism():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = tl.conv2d_init(g1, 6, 8, 3)["w"]
    b = tl.conv2d_init(g2, 6, 8, 3)["w"]
    assert a.shape == (8, 6, 3, 3) and torch.equal(a, b)
    limit = np.sqrt(6.0 / (6 * 9 + 8 * 9))
    assert float(a.abs().max()) <= limit
