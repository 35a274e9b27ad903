"""Checkpoints cross between the packages, and the port's serving
function and run_prediction agree with the JAX package's.

An npz written by the JAX package's save_npz loads through the port's
load_model with every tensor bit-identical, and the reverse. Then both
packages serve the same request from the same weights: the uint8 frames
differ by at most one level."""

import os

import jax
import numpy as np
import pytest
import torch

from pivp_tpu.config import ModelConfig as JConfig
from pivp_tpu.inference import export as jexport
from pivp_tpu.inference import predict as jpredict
from pivp_tpu.models import predictor as jpred
from pivp_tpu.utils import checkpoint as jckpt
from pivp_tpu_torch.config import ModelConfig as TConfig
from pivp_tpu_torch.inference import export as texport
from pivp_tpu_torch.inference import predict as tpredict
from pivp_tpu_torch.models import predictor as tpred
from pivp_tpu_torch.utils import checkpoint as tckpt
from pivp_tpu_torch.utils import weights

# Full channel widths (load_model builds the default plan) at 16x16
# frames and T=4 to stay cheap.
HW, T, CTX, B = 16, 4, 2, 2
LOAD = dict(image_height=HW, image_width=HW, sequence_length=T)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    cfg = JConfig(image_height=HW, image_width=HW, sequence_length=T)
    params = jax.device_get(jpred.init_params(jax.random.PRNGKey(1), cfg))
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    jckpt.save_npz(path, params)
    return path, params


@pytest.fixture(scope="module")
def request_data():
    r = np.random.RandomState(2)
    return (r.rand(CTX, B, HW, HW, 3).astype(np.float32),
            (r.randn(T - 1, B, 5) * 0.5).astype(np.float32),
            (r.randn(B, 5) * 0.5).astype(np.float32))


def test_jax_npz_loads_into_port(jax_ckpt):
    path, jparams = jax_ckpt
    cfg, params = tpredict.load_model(path, "CDNA", 10, CTX, True,
                                      device="cpu", **LOAD)
    assert cfg.use_kernel and cfg.use_kernel_gates
    want = jckpt.flatten_pytree(jparams)
    got = tckpt.flatten(params)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_port_npz_loads_into_jax(tmp_path):
    cfg = TConfig(**LOAD)
    params = tpred.init_params(torch.Generator().manual_seed(4), cfg,
                               device="cpu")
    path = str(tmp_path / "port.npz")
    tckpt.save_npz(path, params)
    _, jparams = jpredict.load_model(path, "CDNA", 10, CTX, True, **LOAD)
    want = weights.to_jax_params(params)
    got = jckpt.flatten_pytree(jax.device_get(jparams))
    assert set(got) == set(want) == set(tckpt.npz_keys(path))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_load_npz_into_rejects_shape_mismatch(jax_ckpt):
    path, _ = jax_ckpt
    template = tpred.init_params(torch.Generator(),
                                 TConfig(image_height=32, image_width=32,
                                         sequence_length=T), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.load_npz_into(path, template)


def test_serve_matches_jax(jax_ckpt, request_data):
    path, jparams = jax_ckpt
    jcfg = JConfig(image_height=HW, image_width=HW, sequence_length=T,
                   scheduled_sampling_k=-1.0)
    want = np.asarray(jexport.make_serve_fn(jparams, jcfg)(*request_data))
    cfg, params = tpredict.load_model(path, "CDNA", 10, CTX, True,
                                      device="cpu", **LOAD)
    got = texport.make_serve_fn(params, cfg)(*request_data)
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == want.shape == (T - CTX, B, HW, HW, 3)
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


def test_predict_and_render_on_cpu(jax_ckpt, tmp_path):
    """The predict pipeline on a processed dir made by the port's
    synthetic data writer, from the JAX package's checkpoint."""
    from pivp_tpu_torch.data import synthetic

    path, _ = jax_ckpt
    run = tmp_path / "models" / "00000000-000000-CDNA-2"
    run.mkdir(parents=True)
    os.symlink(path, run / "jax.npz")
    synthetic.write_processed_dir(str(tmp_path / "data"), 1, T, HW, HW)
    out = tpredict.predict_and_render(
        run.name, "jax.npz", 0, models_dir=str(tmp_path / "models"),
        data_dir=str(tmp_path / "data"), time_step=3, image_height=HW,
        image_width=HW, downscale_factor=0.1, device="cpu")
    assert out.endswith(".gif") and os.path.getsize(out) > 0
