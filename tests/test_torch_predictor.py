"""The PyTorch port's CDNA predict path against the JAX package's, end to
end on shared weights: JAX init_params -> weight bridge -> both
`predict`s on the same numpy inputs. JAX runs the local-apply Pallas
kernel in interpret mode; its gate kernel has no interpret switch on the
predictor path, so JAX keeps the plain gate math (the same function,
held against the kernel in test_torch_lstm_gates.py). The port runs on
the CPU, where its kernel wrappers compute their plain versions."""

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

SMALL = dict(image_height=16, image_width=16, num_masks=4,
             sequence_length=4, scheduled_sampling_k=-1.0,
             enc_channels=(8, 8, 8, 8, 16, 8, 8),
             lstm_channels=(8, 8, 8, 8, 16, 8, 8))
T, B = 4, 2


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfig.ModelConfig(use_pallas=True, pallas_interpret=True,
                               use_pallas_gates=False, **SMALL)
    # Under jit: one compile instead of an eager dispatch per layer.
    params = jax.device_get(jax.jit(jpred.init_params, static_argnums=1)(
        jax.random.PRNGKey(3), jcfg))
    rng = np.random.RandomState(0)
    data = (rng.rand(T, B, 16, 16, 3).astype(np.float32),
            (rng.randn(T, B, 5) * 0.5).astype(np.float32),
            (rng.randn(T, B, 5) * 0.5).astype(np.float32))
    return jcfg, params, data


def _jax_predict(jcfg, params, data, x64=False):
    def run():
        dt = np.float64 if x64 else np.float32
        p = jax.tree_util.tree_map(lambda a: np.asarray(a, dt), params)
        out = jpred.predict(p, jcfg, *[jnp.asarray(a, dt) for a in data])
        return {k: np.asarray(v) for k, v in out.items()}

    if x64:
        with jax.enable_x64(True):
            return run()
    return run()


def _port_predict(tcfg, params, data, dtype=np.float32):
    params = weights.from_jax_params(
        {k: np.asarray(v, dtype) for k, v in flatten_pytree(params).items()})
    out = tpred.predict(params, tcfg,
                        *[torch.as_tensor(np.asarray(a, dtype))
                          for a in data])
    return {k: v.numpy() for k, v in out.items()}


def _compare(want, got, img_tol, psnr_tol, rtol):
    assert set(got) == set(want)
    assert got["gen_images"].shape == (T - 1, B, 16, 16, 3)
    assert np.abs(got["gen_images"] - want["gen_images"]).max() < img_tol
    assert np.abs(got["psnrs"] - want["psnrs"]).max() < psnr_tol
    assert abs(got["psnr_all"] - want["psnr_all"]) < psnr_tol
    for k in ("loss", "gen_states", "recon_costs", "state_costs",
              "psnr_per_image", "ssim", "recon_mse_tb", "state_mse_tb",
              "ssim_tb"):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("literal", [False, True],
                         ids=["tf_intent", "reference_literal"])
def test_predict_matches_jax_f32(setup, literal):
    jcfg, params, data = setup
    tcfg = tconfig.ModelConfig(**SMALL)
    if literal:
        jcfg = jconfig.as_reference_literal(jcfg)
        tcfg = tconfig.as_reference_literal(tcfg)
    want = _jax_predict(jcfg, params, data)
    got = _port_predict(tcfg, params, data)
    # f32 through ~30 layers and 3 feedback steps: 1e-4 on [0,1] frames.
    _compare(want, got, img_tol=1e-4, psnr_tol=0.01, rtol=1e-4)


def test_predict_matches_jax_f64(setup):
    jcfg, params, data = setup
    jcfg = dataclasses.replace(jcfg, compute_dtype="float64",
                               lstm_gate_compute="compute",
                               use_pallas=False)
    tcfg = tconfig.ModelConfig(compute_dtype="float64",
                               lstm_gate_compute="compute", **SMALL)
    want = _jax_predict(jcfg, params, data, x64=True)
    got = _port_predict(tcfg, params, data, np.float64)
    assert got["gen_images"].dtype == np.float64
    # Same semantics in float64: only summation order differs.
    _compare(want, got, img_tol=1e-9, psnr_tol=1e-9, rtol=1e-9)


def test_unfused_cdna_matches_fused(setup):
    _, params, data = setup
    fused = _port_predict(tconfig.ModelConfig(**SMALL), params, data)
    unfused = _port_predict(
        tconfig.ModelConfig(fused_cdna=False, merge_output_convs=False,
                            **SMALL), params, data)
    _compare(fused, unfused, img_tol=1e-5, psnr_tol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("head", [dict(model_type="DNA", num_masks=1),
                                  dict(model_type="STP"),
                                  dict(model_type="STP",
                                       stp_shared_params=False)],
                         ids=["DNA", "STP", "STP_per_mask"])
def test_train_rollout_of_every_head_gives_finite_losses(setup, head):
    # The scheduled-sampling rollout of the DNA and STP heads on the
    # CPU, from the port's own init, with gradients through it.
    _, _, data = setup
    cfg = tconfig.ModelConfig(**dict(SMALL, scheduled_sampling_k=900.0,
                                     **head))
    params = tpred.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    flat = weights.flatten(params)
    for p in flat.values():
        p.requires_grad_(True)
    out = tpred.rollout(params, cfg, *[torch.as_tensor(a) for a in data],
                        train=True, iter_num=100)
    loss = out["loss"].detach()
    assert out["gen_images"].shape == (T - 1, B, 16, 16, 3)
    assert bool(torch.isfinite(loss)) and float(loss) > 0
    grads = dict(zip(flat, torch.autograd.grad(out["loss"],
                                               list(flat.values()))))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["head/enc7/w"].abs().sum()) > 0
