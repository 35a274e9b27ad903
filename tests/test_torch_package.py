"""Guards of the PyTorch port's boundaries: it imports neither JAX nor
the JAX package, and its entry points never carry on on the CPU unless
asked to."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from click.testing import CliRunner

from pivp_tpu_torch.config import ModelConfig, TrainConfig
from pivp_tpu_torch.inference import predict
from pivp_tpu_torch.models import predictor
from pivp_tpu_torch.ops.kernels import build
from pivp_tpu_torch.training import loop, train_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import pivp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pivp_tpu_torch.__path__,
                                               "pivp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == "pivp_tpu" or m.startswith("pivp_tpu."))
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 31


def test_importing_kernels_builds_nothing():
    # build.load() runs only at the first launch on a CUDA tensor.
    assert build._loaded is None or torch.cuda.is_available()


def test_entry_points_raise_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = ModelConfig(image_height=16, image_width=16, sequence_length=3,
                      enc_channels=(8, 8, 8, 8, 16, 8, 8),
                      lstm_channels=(8, 8, 8, 8, 16, 8, 8))
    params = predictor.init_params(torch.Generator(), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.run_prediction(cfg, params,
                               np.zeros((3, 16, 16, 3), np.float32),
                               np.zeros((3, 5), np.float32),
                               np.zeros((3, 5), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.load_model(str(tmp_path / "missing.npz"), "CDNA", 10, 2,
                           True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predictor.init_params(torch.Generator(), cfg)
    arrays = tuple(np.zeros((2, 3) + s, np.float32)
                   for s in ((16, 16, 3), (5,), (5,)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.run_training(TrainConfig(output_dir=str(tmp_path)),
                          arrays=arrays)
    result = CliRunner().invoke(train_cli.main, [
        "--synthetic", "2", "--num_iterations", "1",
        "--output_dir", str(tmp_path)])
    assert isinstance(result.exception, RuntimeError)
    assert "no CUDA device" in str(result.exception)
    assert not os.listdir(tmp_path)


def test_run_validation_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    arrays = tuple(np.zeros((2, 3) + s, np.float32)
                   for s in ((16, 16, 3), (5,), (5,)))

    def eval_step(params, batch):
        raise AssertionError("validation ran on the CPU")

    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.run_validation(eval_step, {}, arrays, 2, 1e-4)


@pytest.mark.parametrize("head", [dict(model_type="DNA", num_masks=1),
                                  dict(model_type="STP"),
                                  dict(model_type="STP",
                                       stp_shared_params=False)],
                         ids=["DNA", "STP", "STP_per_mask"])
def test_every_head_builds_its_params_on_the_cpu(head):
    cfg = ModelConfig(**head)
    params = predictor.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    assert params["enc0"]["w"].device.type == "cpu"
    if cfg.is_dna:
        assert set(params["head"]) == {"enc7"}
        assert params["head"]["enc7"]["w"].shape == (64, 25, 1, 1)
    else:
        ip = params["head"]["identity_params"]
        per_mask = {str(i) for i in range(cfg.num_masks - 1)}
        assert (set(ip) == per_mask) != cfg.stp_shared_params


def test_unknown_heads_and_dna_with_masks_are_refused():
    with pytest.raises(ValueError, match="No network specified"):
        ModelConfig(model_type="ConvLSTM")
    with pytest.raises(ValueError, match="Only one mask"):
        ModelConfig(model_type="DNA", num_masks=10)
    with pytest.raises(ValueError, match="Only one mask"):
        TrainConfig(model_type="DNA").model_config()
