"""Checkpoints of the DNA and STP models cross between the packages both
ways (with the per-mask STP projections, a list in JAX and keyed "0",
"1", ... in the port, under the same npz keys), and the port serves and
renders them as the JAX package does."""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from pivp_tpu.config import ModelConfig as JConfig
from pivp_tpu.inference import export as jexport
from pivp_tpu.models import predictor as jpred
from pivp_tpu.utils import checkpoint as jckpt
from pivp_tpu_torch.config import ModelConfig as TConfig
from pivp_tpu_torch.inference import export as texport
from pivp_tpu_torch.inference import predict as tpredict
from pivp_tpu_torch.models import predictor as tpred
from pivp_tpu_torch.utils import checkpoint as tckpt
from pivp_tpu_torch.utils import weights

# Full channel widths at 16x16 frames and T=4, as test_torch_serving.py.
HW, T, CTX, B = 16, 4, 2, 2
SIZE = dict(image_height=HW, image_width=HW, sequence_length=T)
HEADS = {"DNA": dict(model_type="DNA", num_masks=1),
         "STP": dict(model_type="STP", num_masks=10),
         "STP_per_mask": dict(model_type="STP", num_masks=10,
                              stp_shared_params=False)}


@functools.lru_cache(maxsize=None)
def _jax_params(head, seed=1):
    cfg = JConfig(**SIZE, **HEADS[head])
    return cfg, jax.device_get(jax.jit(jpred.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg))


@pytest.mark.parametrize("head", list(HEADS))
def test_jax_npz_loads_into_port(head, tmp_path):
    _, jparams = _jax_params(head)
    path = str(tmp_path / "jax.npz")
    jckpt.save_npz(path, jparams)
    template = tpred.init_params(torch.Generator(),
                                 TConfig(**SIZE, **HEADS[head]),
                                 device="cpu")
    got = tckpt.flatten(tckpt.load_npz_into(path, template))
    want = jckpt.flatten_pytree(jparams)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if head == "STP_per_mask":
        assert "head/identity_params/8/w" in got


@pytest.mark.parametrize("head", list(HEADS))
def test_port_npz_loads_into_jax(head, tmp_path):
    cfg = TConfig(**SIZE, **HEADS[head])
    params = tpred.init_params(torch.Generator().manual_seed(4), cfg,
                               device="cpu")
    path = str(tmp_path / "port.npz")
    tckpt.save_npz(path, params)
    shapes = jax.eval_shape(lambda k: jpred.init_params(
        k, JConfig(**SIZE, **HEADS[head])), jax.random.PRNGKey(0))
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    loaded = jckpt.load_npz_into(path, template)
    want = weights.to_jax_params(params)
    got = jckpt.flatten_pytree(loaded)
    assert set(got) == set(want) == set(tckpt.npz_keys(path))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.fixture(scope="module")
def request_data():
    r = np.random.RandomState(2)
    return (r.rand(CTX, B, HW, HW, 3).astype(np.float32),
            (r.randn(T - 1, B, 5) * 0.5).astype(np.float32),
            (r.randn(B, 5) * 0.5).astype(np.float32))


@pytest.mark.parametrize("head", ["DNA", "STP"])
def test_load_model_and_serve_match_jax(head, request_data, tmp_path):
    """A JAX-written npz through the port's load_model (the run
    directory names the head) and make_serve_fn, against JAX's serving
    function on the same weights: the uint8 frames within one level."""
    jcfg, jparams = _jax_params(head)
    run = tmp_path / f"00000000-000000-{head}-2"
    run.mkdir()
    jckpt.save_npz(str(run / "training-final.npz"), jparams)
    model_type = tpredict.infer_model_type(str(run))
    assert model_type == head
    cfg, params = tpredict.load_model(
        str(run / "training-final.npz"), model_type, jcfg.num_masks, CTX,
        True, device="cpu", **SIZE)
    assert cfg.model_type == head and cfg.use_kernel
    jcfg = JConfig(scheduled_sampling_k=-1.0, **SIZE, **HEADS[head])
    want = np.asarray(jexport.make_serve_fn(jparams, jcfg)(*request_data))
    got = texport.make_serve_fn(params, cfg)(*request_data)
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == want.shape == (T - CTX, B, HW, HW, 3)
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("head", ["DNA", "STP"])
def test_predict_and_render_infers_the_head(head, tmp_path):
    from pivp_tpu_torch.data import synthetic

    params = tpred.init_params(torch.Generator().manual_seed(5),
                               TConfig(**SIZE, **HEADS[head]),
                               device="cpu")
    run = tmp_path / "models" / f"00000000-000000-{head}-2"
    run.mkdir(parents=True)
    tckpt.save_npz(str(run / "training-final.npz"), params)
    synthetic.write_processed_dir(str(tmp_path / "data"), 1, T, HW, HW)
    out = tpredict.predict_and_render(
        run.name, "training-final.npz", 0,
        models_dir=str(tmp_path / "models"),
        data_dir=str(tmp_path / "data"), time_step=3,
        num_masks=HEADS[head]["num_masks"], image_height=HW,
        image_width=HW, downscale_factor=0.1, device="cpu")
    assert out.endswith(".gif") and os.path.getsize(out) > 0
