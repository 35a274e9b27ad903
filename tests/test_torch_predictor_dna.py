"""The PyTorch port's DNA predictor against the JAX package's, end to end
on shared weights (JAX init_params -> weight bridge -> both rollouts on
the same numpy inputs), with the captured activations (`conv_res`,
`conv_res_all`; also those of the fused CDNA path). JAX runs the
local-apply Pallas kernel in interpret mode and the plain gate math;
the port runs on the CPU, where its kernel wrappers compute their plain
versions. The helpers here serve the STP files too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pivp_tpu import config as jconfig
from pivp_tpu.models import predictor as jpred
from pivp_tpu.utils.checkpoint import flatten_pytree
from pivp_tpu_torch import config as tconfig
from pivp_tpu_torch.models import predictor as tpred
from pivp_tpu_torch.utils import weights

SMALL = dict(image_height=16, image_width=16, sequence_length=4,
             scheduled_sampling_k=-1.0,
             enc_channels=(8, 8, 8, 8, 16, 8, 8),
             lstm_channels=(8, 8, 8, 8, 16, 8, 8))
T, B = 4, 2
DNA = dict(model_type="DNA", num_masks=1)
# The rollout's entries besides the frames, PSNRs and captures.
METRICS = ("loss", "gen_states", "recon_costs", "state_costs",
           "psnr_per_image", "ssim", "recon_mse_tb", "state_mse_tb",
           "ssim_tb")


def jax_cfg(**kw):
    return jconfig.ModelConfig(use_pallas=True, pallas_interpret=True,
                               use_pallas_gates=False, **dict(SMALL, **kw))


def make_setup(**kw):
    jcfg = jax_cfg(**kw)
    params = jax.device_get(jax.jit(jpred.init_params, static_argnums=1)(
        jax.random.PRNGKey(3), jcfg))
    rng = np.random.RandomState(0)
    data = (rng.rand(T, B, 16, 16, 3).astype(np.float32),
            (rng.randn(T, B, 5) * 0.5).astype(np.float32),
            (rng.randn(T, B, 5) * 0.5).astype(np.float32))
    return jcfg, params, data


def jax_rollout(jcfg, params, data, x64=False):
    """JAX's feed-self rollout with its captured activations, as numpy."""
    def run():
        dt = np.float64 if x64 else np.float32
        p = jax.tree_util.tree_map(lambda a: np.asarray(a, dt), params)
        fn = jax.jit(lambda p, *d: jpred.rollout(
            p, jcfg, *d, jnp.float32(0.0), jax.random.PRNGKey(0),
            train=False, capture=True))
        return jax.device_get(fn(p, *[jnp.asarray(a, dt) for a in data]))

    if x64:
        with jax.enable_x64(True):
            return run()
    return run()


def port_rollout(tcfg, params, data, dtype=np.float32):
    tparams = weights.from_jax_params(
        {k: np.asarray(v, dtype) for k, v in flatten_pytree(params).items()})
    with torch.no_grad():
        out = tpred.rollout(tparams, tcfg,
                            *[torch.as_tensor(np.asarray(a, dtype))
                              for a in data], capture=True)
    return jax.tree_util.tree_map(lambda v: v.numpy(), out)


def compare(want, got, img_tol, psnr_tol, rtol):
    assert set(got) == set(want)
    assert got["gen_images"].shape == (T - 1, B, 16, 16, 3)
    assert np.abs(got["gen_images"] - want["gen_images"]).max() < img_tol
    assert np.abs(got["psnrs"] - want["psnrs"]).max() < psnr_tol
    assert abs(got["psnr_all"] - want["psnr_all"]) < psnr_tol
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=rtol,
                                   err_msg=k)


def compare_captures(want, got, rtol):
    """enc0..enc7 of the last step and of every step."""
    assert len(got["conv_res"]) == len(want["conv_res"]) == 8
    for i, (g, w) in enumerate(zip(got["conv_res"], want["conv_res"])):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol,
                                   err_msg=f"conv_res {i}")
    for i, (g, w) in enumerate(zip(got["conv_res_all"],
                                   want["conv_res_all"])):
        assert g.shape == w.shape and g.shape[:2] == (T - 1, B)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol,
                                   err_msg=f"conv_res_all {i}")


@pytest.fixture(scope="module")
def setup():
    jcfg, params, data = make_setup(**DNA)
    return jcfg, params, data, jax_rollout(jcfg, params, data)


# (use_kernel, merge_output_convs): the kernel wrapper or the shifted
# stack, and enc7 as a strided slice of the merged conv or its own conv.
VARIANTS = {"kernel_merged": (True, True), "plain_merged": (False, True),
            "kernel_own_conv": (True, False)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dna_predict_matches_jax_f32(setup, variant):
    jcfg, params, data, want = setup
    use_kernel, merge = VARIANTS[variant]
    tcfg = tconfig.ModelConfig(use_kernel=use_kernel,
                               merge_output_convs=merge, **DNA, **SMALL)
    got = port_rollout(tcfg, params, data)
    # f32 through ~30 layers and 3 feedback steps: 1e-4 on [0,1] frames.
    compare(want, got, img_tol=1e-4, psnr_tol=0.01, rtol=1e-4)
    # The loss of the rollout, as in the training tests.
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


def test_dna_capture_matches_jax(setup):
    _, params, data, want = setup
    got = port_rollout(tconfig.ModelConfig(**DNA, **SMALL), params, data)
    # enc7 is the relu of the head's deconv: K*K = 25 channels.
    assert got["conv_res"][7].shape == (B, 16, 16, 25)
    compare_captures(want, got, rtol=1e-4)


def test_dna_predict_matches_jax_f64(setup):
    jcfg, params, data, _ = setup
    jcfg = dataclasses.replace(jcfg, compute_dtype="float64",
                               lstm_gate_compute="compute",
                               use_pallas=False)
    tcfg = tconfig.ModelConfig(compute_dtype="float64",
                               lstm_gate_compute="compute", **DNA, **SMALL)
    want = jax_rollout(jcfg, params, data, x64=True)
    got = port_rollout(tcfg, params, data, np.float64)
    assert got["gen_images"].dtype == np.float64
    compare(want, got, img_tol=1e-9, psnr_tol=1e-9, rtol=1e-9)
    compare_captures(want, got, rtol=1e-9)


def test_dna_reference_literal_matches_jax(setup):
    """dna_border_zero (with the mask scramble) takes the shifted stack's
    border-zeroed windows in both packages, bypassing the kernel."""
    jcfg, params, data, _ = setup
    jcfg = jconfig.as_reference_literal(jcfg)
    tcfg = tconfig.as_reference_literal(tconfig.ModelConfig(**DNA,
                                                            **SMALL))
    assert tcfg.dna_border_zero and tcfg.use_kernel
    want = jax_rollout(jcfg, params, data)
    got = port_rollout(tcfg, params, data)
    compare(want, got, img_tol=1e-4, psnr_tol=0.01, rtol=1e-4)


def test_cdna_capture_matches_jax():
    """The fused CDNA path captures the head's enc7 (relu of its deconv)
    as the candidate-stack heads do."""
    jcfg, params, data = make_setup(num_masks=4)
    want = jax_rollout(jcfg, params, data)
    got = port_rollout(tconfig.ModelConfig(num_masks=4, **SMALL), params,
                       data)
    assert got["conv_res"][7].shape == (B, 16, 16, 3)
    compare_captures(want, got, rtol=1e-4)
