"""The PyTorch port's STP predictor against the JAX package's, end to end
on shared weights, with one shared affine projection (the reference's)
and with a projection per mask, which the port runs as one batched
(B, M-1, 2, 3) warp where JAX loops over the masks; with the captured
activations. Helpers and sizes as in test_torch_predictor_dna.py."""

import dataclasses

import numpy as np
import pytest

from pivp_tpu import config as jconfig
from pivp_tpu_torch import config as tconfig
from test_torch_predictor_dna import (B, SMALL, compare, compare_captures,
                                      jax_rollout, make_setup, port_rollout)

MODES = {"shared": dict(model_type="STP", num_masks=4),
         "per_mask": dict(model_type="STP", num_masks=4,
                          stp_shared_params=False)}


@pytest.fixture(scope="module", params=list(MODES))
def setup(request):
    kw = MODES[request.param]
    jcfg, params, data = make_setup(**kw)
    return kw, jcfg, params, data, jax_rollout(jcfg, params, data)


@pytest.mark.parametrize("merge", [True, False],
                         ids=["merged_conv", "own_conv"])
def test_stp_predict_matches_jax_f32(setup, merge):
    kw, _, params, data, want = setup
    tcfg = tconfig.ModelConfig(merge_output_convs=merge, **kw, **SMALL)
    got = port_rollout(tcfg, params, data)
    compare(want, got, img_tol=1e-4, psnr_tol=0.01, rtol=1e-4)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    # enc7 is the head's raw deconv (no ReLU before STP's sigmoid).
    assert got["conv_res"][7].shape == (B, 16, 16, 3)
    assert (got["conv_res"][7] < 0).any()
    compare_captures(want, got, rtol=1e-4)


def test_stp_predict_matches_jax_f64(setup):
    kw, jcfg, params, data, _ = setup
    jcfg = dataclasses.replace(jcfg, compute_dtype="float64",
                               lstm_gate_compute="compute")
    tcfg = tconfig.ModelConfig(compute_dtype="float64",
                               lstm_gate_compute="compute", **kw, **SMALL)
    want = jax_rollout(jcfg, params, data, x64=True)
    got = port_rollout(tcfg, params, data, np.float64)
    compare(want, got, img_tol=1e-9, psnr_tol=1e-9, rtol=1e-9)
    compare_captures(want, got, rtol=1e-9)


def test_stp_reference_literal_matches_jax():
    """The literal switches include the shared projection."""
    jcfg, params, data = make_setup(**MODES["shared"])
    jcfg = jconfig.as_reference_literal(jcfg)
    tcfg = tconfig.as_reference_literal(
        tconfig.ModelConfig(**MODES["per_mask"], **SMALL))
    assert tcfg.stp_shared_params and tcfg.chainer_mask_scramble
    want = jax_rollout(jcfg, params, data)
    got = port_rollout(tcfg, params, data)
    compare(want, got, img_tol=1e-4, psnr_tol=0.01, rtol=1e-4)
