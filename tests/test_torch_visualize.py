"""The port's visualization against the JAX package's, on the CPU:
`project_activation` (the deconv projection of a stage's activations back
to pixel space) in float64 to 1e-9, and the visualize CLI writing the
loss curves and the enc0..enc7 activation grids and projections under
the file names the JAX package's `plot_loss_curves` and
`visualize_model` write for the same checkpoint and curves."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from pivp_tpu.inference import predict as jpredict
from pivp_tpu.models import predictor as jpred
from pivp_tpu.visualization import visualize as jviz
from pivp_tpu_torch.config import ModelConfig
from pivp_tpu_torch.data import synthetic
from pivp_tpu_torch.inference import predict
from pivp_tpu_torch.models import predictor
from pivp_tpu_torch.utils import checkpoint as ckpt_lib
from pivp_tpu_torch.utils import weights
from pivp_tpu_torch.visualization import visualize, visualize_cli

RUN = "00000000-000000-CDNA-2"
H = W = 16


# (layer, its input channels, activation (h, w, C_out), stride, pad)
PROJECTIONS = {"enc0": (3, (8, 8, 32), 2, 2),
               "enc1": (32, (4, 4, 32), 2, 1)}


@pytest.mark.parametrize("layer", list(PROJECTIONS))
def test_project_activation_matches_jax_f64(layer):
    c_in, act_shape, stride, pad = PROJECTIONS[layer]
    rng = np.random.RandomState(0)
    k = 5 if layer == "enc0" else 3
    conv_w = rng.randn(k, k, c_in, act_shape[-1])       # JAX (kh,kw,in,out)
    act = rng.randn(2, *act_shape)
    with jax.enable_x64(True):
        want = jviz.project_activation(conv_w, jnp.asarray(act), stride,
                                       pad, (act_shape[0] * 2,
                                             act_shape[1] * 2))
    port_w = weights.from_jax_params({f"{layer}/w": conv_w})[layer]["w"]
    got = visualize.project_activation(port_w, torch.from_numpy(act),
                                       stride, pad,
                                       (act_shape[0] * 2, act_shape[1] * 2))
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory with a CDNA checkpoint (random weights) and the
    four curve files, and a processed-data directory."""
    root = tmp_path_factory.mktemp("viz")
    models = root / "models"
    save_dir = models / RUN
    os.makedirs(save_dir)
    cfg = ModelConfig(image_height=H, image_width=W, sequence_length=4)
    params = predictor.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    ckpt_lib.save_npz(str(save_dir / "training-final"), params)
    rng = np.random.RandomState(1)
    for name in ("losses", "psnr_all", "losses_valid", "psnr_all_valid"):
        np.save(save_dir / f"training-global_{name}.npy",
                np.abs(rng.randn(3, 5)))
    synthetic.write_processed_dir(str(root / "data"), 2, 4, H, W, seed=2)
    return root


def test_visualize_cli_writes_the_jax_packages_files(run_dir, monkeypatch):
    root = run_dir
    result = CliRunner().invoke(visualize_cli.main, [
        RUN, "--model_name", "training-final.npz", "--models_dir",
        str(root / "models"), "--data_dir", str(root / "data"),
        "--time_step", "2", "--out_dir", str(root / "port"),
        "--device", "cpu"], standalone_mode=False, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    port = sorted(os.listdir(root / "port"))
    assert all(os.path.getsize(root / "port" / f) > 0 for f in port)
    for i in range(8):
        assert f"enc{i}-activation.png" in port
    assert "enc0-projected-t0-output.png" in port
    assert "training-global_losses_valid.png" in port

    # The JAX package's files for the same checkpoint and curves. Its
    # file names come from its own code; its checkpoint load, rollout and
    # drawing are replaced (by the npz's arrays, the port's rollout of
    # the same checkpoint, and nothing): run eagerly here they take half
    # a minute, and the names depend only on the captured shapes.
    npz = str(root / "models" / RUN / "training-final.npz")
    cfg, params = predict.load_model(npz, "CDNA", 10, 2, True, -1.0, H, W,
                                     4, device="cpu")

    def port_rollout(_, __, images, actions, states, *args, **kw):
        def tensor(a):
            return torch.tensor(np.asarray(a, np.float32))
        with torch.no_grad():
            out = predictor.rollout(params, cfg, tensor(images),
                                    tensor(actions), tensor(states),
                                    capture=True)
        return {"gen_images": out["gen_images"].numpy(),
                "conv_res": [a.numpy() for a in out["conv_res"]],
                "conv_res_all": [a.numpy() for a in out["conv_res_all"]]}

    monkeypatch.setattr(jpredict, "load_model", lambda path, *a, **kw: (
        None, weights.unflatten(dict(np.load(path)))))
    monkeypatch.setattr(jpred, "rollout", port_rollout)
    monkeypatch.setattr(jviz.Visualizer, "_grid",
                        lambda self, tiles, title, path, cmap=None: path)
    monkeypatch.setattr(jviz.Visualizer, "plot_output",
                        lambda self, images, name: os.path.join(
                            self.out_dir, f"{name}-output.png"))
    written = jviz.plot_loss_curves(str(root / "models" / RUN),
                                    str(root / "jax"))
    image, _, _, action, state = jpredict.get_data_info(str(root / "data"),
                                                        0)
    written += jviz.visualize_model(npz, "CDNA", image[:4], action[:4, 0],
                                    state[:4, 0], str(root / "jax"))
    assert port == sorted(os.path.basename(w) for w in written)


def test_model_activations_need_no_matplotlib(run_dir, monkeypatch):
    """The numbers the figures draw come without matplotlib (a GPU host
    may lack it); drawing then raises instead of passing silently."""
    root = run_dir
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    image, _, _, action, state = predict.get_data_info(str(root / "data"),
                                                       0)
    acts = visualize.model_activations(
        str(root / "models" / RUN / "training-final.npz"), "CDNA",
        image[:4], action[:4, 0], state[:4, 0], device="cpu")
    assert [a.shape[:2] for a in acts["conv_res_all"]] == [(3, 1)] * 8
    assert acts["steps"] == [0, 1, 2]
    assert acts["projected"][0].shape == (H, W, 3)
    with pytest.raises(ImportError):
        visualize.plot_loss_curves(str(root / "models" / RUN),
                                   str(root / "none"))
