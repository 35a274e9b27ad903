"""The port's training loop: the train CLI's run-directory contract on
the CPU, its weights and optimizer state crossing to the JAX package and
back, and its exact validation sweep against the JAX package's."""

import json
import os

import jax
import numpy as np
import pytest
from click.testing import CliRunner

from pivp_tpu import config as jconfig
from pivp_tpu.models import predictor as jpred
from pivp_tpu.parallel import train_step as jts
from pivp_tpu.training import loop as jloop
from pivp_tpu.utils import checkpoint as jckpt
from pivp_tpu_torch import config as tconfig
from pivp_tpu_torch.data import synthetic
from pivp_tpu_torch.models import predictor as tpred
from pivp_tpu_torch.parallel import train_step as tts
from pivp_tpu_torch.training import loop as tloop
from pivp_tpu_torch.training import train_cli
from pivp_tpu_torch.utils import checkpoint as tckpt
from pivp_tpu_torch.utils import weights

H = W = 16
T = 4
CURVES = ("training-global_losses", "training-global_psnr_all",
          "training-global_losses_valid", "training-global_psnr_all_valid")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two iterations at batch 2 on 6 synthetic sequences split 3/3: the
    second batch closes epoch 1, which flushes, validates and saves."""
    out = tmp_path_factory.mktemp("train")
    models = str(out / "models")
    result = CliRunner().invoke(train_cli.main, [
        "--device", "cpu", "--synthetic", "6", "--num_iterations", "2",
        "--batch_size", "2", "--sequence_length", str(T),
        "--image_height", str(H), "--image_width", str(W),
        "--train_val_split", "0.5", "--validation_interval", "1",
        "--save_interval", "1", "--output_dir", models,
        "--event_log_dir", models, "--run_name", "run"],
        standalone_mode=False, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    return result.return_value


def _jax_cfg():
    return jconfig.ModelConfig(image_height=H, image_width=W,
                               sequence_length=T)


def _jax_template(cfg):
    shapes = jax.eval_shape(lambda k: jpred.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


def test_cli_writes_the_run_directory_contract(run):
    save_dir = run["save_dir"]
    assert os.path.basename(save_dir) == "run"
    for tag in ("1", "final"):
        for kind in ("training", "state"):
            assert os.path.exists(os.path.join(save_dir,
                                               f"{kind}-{tag}.npz"))
    curves = {n: np.load(os.path.join(save_dir, n + ".npy"))
              for n in CURVES}
    for name, curve in curves.items():
        assert curve.shape == (1, 5), name        # [mean,std,min,max,median]
        assert np.isfinite(curve).all(), name
    assert curves["training-global_losses"][0, 0] > 0
    with open(os.path.join(os.path.dirname(save_dir),
                           "run-events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    assert [e.get("split", "train") for e in events] == ["train",
                                                          "validation"]
    assert events[0]["iteration"] == 2 and events[0]["summaries"]
    assert run["state"].step == 2


def test_final_weights_load_into_the_jax_package(run):
    cfg = _jax_cfg()
    loaded = jckpt.load_npz_into(
        os.path.join(run["save_dir"], "training-final.npz"),
        _jax_template(cfg))
    want = weights.to_jax_params(run["state"].params)
    got = jckpt.flatten_pytree(loaded)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_optimizer_state_crosses_both_ways(run, tmp_path):
    cfg = _jax_cfg()
    template = _jax_template(cfg)
    opt = jts.make_optimizer(1e-3)
    # Port -> JAX: state-final.npz into a ChainerAdamState template.
    jstate = jckpt.load_npz_into(
        os.path.join(run["save_dir"], "state-final.npz"),
        opt.init(template))
    assert int(jstate.count) == 2
    want = weights.to_jax_params(tts.opt_state_tree(run["state"]))
    got = jckpt.flatten_pytree(jstate)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # A deconv moment keeps the deconv layout (its parameter's), not a
    # conv permutation.
    enc4 = run["state"].params["enc4"]["w"]
    assert got["mu/enc4/w"].shape == tuple(enc4.permute(2, 3, 0, 1).shape)

    # JAX -> port: a JAX-written state with distinct moments per tensor.
    r = np.random.RandomState(0)
    jmu = jax.tree_util.tree_map(
        lambda a: r.randn(*a.shape).astype(np.float32), template)
    jnu = jax.tree_util.tree_map(
        lambda a: r.rand(*a.shape).astype(np.float32), template)
    path = str(tmp_path / "state-jax.npz")
    jckpt.save_npz(path, jts.ChainerAdamState(np.int32(7), jmu, jnu))
    state = tts.create_train_state(
        tpred.map_params(lambda p: p.detach().clone(), run["state"].params),
        tts.make_optimizer(1e-3))
    tts.load_opt_state_tree(state, tckpt.load_npz_into(
        path, tts.opt_state_tree(state)))
    back = weights.to_jax_params(tts.opt_state_tree(state))
    assert int(back["count"]) == 7
    for k, v in jckpt.flatten_pytree(jmu).items():
        np.testing.assert_array_equal(back["mu/" + k], v, err_msg=k)
    for k, v in jckpt.flatten_pytree(jnu).items():
        np.testing.assert_array_equal(back["nu/" + k], v, err_msg=k)


def test_warm_start_restores_weights_and_optimizer_state(run, tmp_path):
    save_dir = run["save_dir"]
    cfg = tconfig.TrainConfig(
        device="cpu", num_iterations=0, sequence_length=T, image_height=H,
        image_width=W, output_dir=str(tmp_path), event_log_dir="",
        pretrained_model=os.path.join(save_dir, "training-final.npz"),
        pretrained_state=os.path.join(save_dir, "state-final.npz"))
    arrays = synthetic.generate_sequences(2, T, H, W)
    out = tloop.run_training(cfg, arrays=arrays, run_name="warm")
    for kind in ("training", "state"):
        with np.load(os.path.join(save_dir, f"{kind}-final.npz")) as a, \
                np.load(os.path.join(out["save_dir"],
                                     f"{kind}-final.npz")) as b:
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


SMALL = dict(image_height=H, image_width=W, num_masks=4, sequence_length=T,
             enc_channels=(8, 8, 8, 8, 16, 8, 8),
             lstm_channels=(8, 8, 8, 8, 16, 8, 8))


@pytest.fixture(scope="module")
def val_setup():
    jcfg = jconfig.ModelConfig(use_pallas=True, pallas_interpret=True,
                               use_pallas_gates=False, **SMALL)
    params = jax.device_get(jax.jit(jpred.init_params, static_argnums=1)(
        jax.random.PRNGKey(5), jcfg))
    arrays = synthetic.generate_sequences(5, T, H, W, seed=1)
    return jcfg, params, arrays


@pytest.mark.parametrize("batch_size", [2, 4])
def test_run_validation_matches_jax(val_setup, batch_size):
    jcfg, params, arrays = val_setup
    want = jloop.run_validation(jts.make_eval_step(jcfg), params, arrays,
                                batch_size, jcfg.state_cost_weight,
                                u8_transfer=True)
    tcfg = tconfig.ModelConfig(**SMALL)
    tparams = weights.from_jax_params(jckpt.flatten_pytree(params))
    got = tloop.run_validation(tts.make_eval_step(tcfg), tparams, arrays,
                               batch_size, tcfg.state_cost_weight,
                               u8_transfer=True, device="cpu")
    assert got["n_sequences"] == want["n_sequences"] == 5
    # f32 through ~30 layers and feedback steps, as the predict parity.
    for k in ("loss", "ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for k in ("psnr_all", "psnr_per_image"):
        assert abs(got[k] - want[k]) < 0.01, k
