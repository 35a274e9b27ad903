"""The port's training CLI with the DNA and STP heads on the CPU (the
tiny run of the verify recipe): the run directory, finite curves, and
the final weights and optimizer state loading into the JAX package; and
the per-mask STP optimizer state crossing both ways."""

import os

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from pivp_tpu import config as jconfig
from pivp_tpu.models import predictor as jpred
from pivp_tpu.parallel import train_step as jts
from pivp_tpu.utils import checkpoint as jckpt
from pivp_tpu_torch import config as tconfig
from pivp_tpu_torch.models import predictor as tpred
from pivp_tpu_torch.parallel import train_step as tts
from pivp_tpu_torch.utils import checkpoint as tckpt
from pivp_tpu_torch.utils import weights

H = W = 16
T = 4
CLI_HEADS = {"DNA": ["--model_type", "DNA", "--num_masks", "1"],
             "STP": ["--model_type", "STP"]}


def _jax_template(tree_fn):
    shapes = jax.eval_shape(tree_fn, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


@pytest.mark.parametrize("head", list(CLI_HEADS))
def test_train_cli_trains_the_head_on_cpu(head, tmp_path):
    from pivp_tpu_torch.training import train_cli

    models = str(tmp_path / "models")
    result = CliRunner().invoke(train_cli.main, [
        "--device", "cpu", "--synthetic", "8", "--num_iterations", "4",
        "--batch_size", "2", "--sequence_length", str(T),
        "--image_height", str(H), "--image_width", str(W),
        "--train_val_split", "0.5", "--validation_interval", "1",
        "--save_interval", "1", "--output_dir", models,
        "--event_log_dir", models] + CLI_HEADS[head],
        standalone_mode=False, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    run = result.return_value
    assert run["model_config"].model_type == head
    assert os.path.basename(run["save_dir"]).endswith(f"-{head}-2")
    losses = np.load(os.path.join(run["save_dir"],
                                  "training-global_losses.npy"))
    assert losses.shape == (2, 5) and np.isfinite(losses).all()
    assert run["state"].step == 4

    jcfg = jconfig.ModelConfig(image_height=H, image_width=W,
                               sequence_length=T,
                               num_masks=run["model_config"].num_masks,
                               model_type=head)
    template = _jax_template(lambda k: jpred.init_params(k, jcfg))
    loaded = jckpt.load_npz_into(
        os.path.join(run["save_dir"], "training-final.npz"), template)
    got = jckpt.flatten_pytree(loaded)
    want = weights.to_jax_params(run["state"].params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jstate = jckpt.load_npz_into(
        os.path.join(run["save_dir"], "state-final.npz"),
        jts.make_optimizer(1e-3).init(template))
    assert int(jstate.count) == 4


def test_per_mask_stp_optimizer_state_crosses_both_ways(tmp_path):
    kw = dict(model_type="STP", num_masks=3, stp_shared_params=False,
              image_height=H, image_width=W, sequence_length=T,
              enc_channels=(8, 8, 8, 8, 16, 8, 8),
              lstm_channels=(8, 8, 8, 8, 16, 8, 8))
    tcfg = tconfig.ModelConfig(**kw)
    state = tts.create_train_state(
        tpred.init_params(torch.Generator().manual_seed(0), tcfg,
                          device="cpu"), tts.make_optimizer(1e-3))
    r = np.random.RandomState(0)
    batch = (torch.as_tensor(r.rand(T, 2, H, W, 3).astype(np.float32)),
             torch.as_tensor(r.randn(T, 2, 5).astype(np.float32)),
             torch.as_tensor(r.randn(T, 2, 5).astype(np.float32)))
    state, _ = tts.make_train_step(tcfg)(state, batch, 0,
                                         torch.Generator().manual_seed(0))
    path = str(tmp_path / "state-port.npz")
    tckpt.save_npz(path, tts.opt_state_tree(state))

    jcfg = jconfig.ModelConfig(**kw)
    template = _jax_template(lambda k: jpred.init_params(k, jcfg))
    assert isinstance(template["head"]["identity_params"], list)
    jstate = jckpt.load_npz_into(path, jts.make_optimizer(1e-3).init(
        template))
    want = weights.to_jax_params(tts.opt_state_tree(state))
    got = jckpt.flatten_pytree(jstate)
    assert int(jstate.count) == 1 and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.abs(got["mu/head/identity_params/1/w"]).sum() > 0

    # JAX -> port: moments distinct per tensor, the list's order kept.
    jmu = jax.tree_util.tree_map(
        lambda a: r.randn(*a.shape).astype(np.float32), template)
    jnu = jax.tree_util.tree_map(
        lambda a: r.rand(*a.shape).astype(np.float32), template)
    jpath = str(tmp_path / "state-jax.npz")
    jckpt.save_npz(jpath, jts.ChainerAdamState(np.int32(5), jmu, jnu))
    tts.load_opt_state_tree(state, tckpt.load_npz_into(
        jpath, tts.opt_state_tree(state)))
    back = weights.to_jax_params(tts.opt_state_tree(state))
    assert int(back["count"]) == 5
    for k, v in jckpt.flatten_pytree(jmu).items():
        np.testing.assert_array_equal(back["mu/" + k], v, err_msg=k)
    for k, v in jckpt.flatten_pytree(jnu).items():
        np.testing.assert_array_equal(back["nu/" + k], v, err_msg=k)
