"""The port's training loop around the train step, on the CPU at a small
size: K steps a dispatch, the prefetch thread and per-batch reads from
disk leave the epoch curves and the parameters bit for bit as one step a
dispatch leaves them; the prefetch thread is retired after a NaN abort;
a run preempted at a dispatch boundary (mid-epoch) and relaunched with
the same run name under `--checkpointer torch` ends bit for bit where
the uninterrupted run ends, curves included (the JAX package's
tests/test_resume.py); the signal handlers; and `--profile_dir`."""

import dataclasses
import functools
import glob
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from pivp_tpu_torch import config as tconfig
from pivp_tpu_torch.data import dataset, synthetic
from pivp_tpu_torch.training import loop, preemption, train_cli
from pivp_tpu_torch.utils import profiling

NARROW = dict(enc_channels=(8, 8, 8, 8, 16, 8, 8),
              lstm_channels=(8, 8, 8, 8, 16, 8, 8))
T = 4
CURVES = ("training-global_losses", "training-global_psnr_all",
          "training-global_losses_valid", "training-global_psnr_all_valid")


def _cfg(tmp_path, tag, **kw):
    base = dict(num_iterations=7, batch_size=2, sequence_length=T,
                image_height=16, image_width=16, num_masks=4,
                train_val_split=0.75, validation_interval=2,
                save_interval=100, output_dir=str(tmp_path / tag),
                event_log_dir="", device="cpu", prefetch=0,
                model_overrides=tuple(NARROW.items()))
    base.update(kw)
    return tconfig.TrainConfig(**base)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """8 sequences on disk: 6 train (3 batches an epoch), 2 validation."""
    path = str(tmp_path_factory.mktemp("data"))
    synthetic.write_processed_dir(path, 8, T, 16, 16, seed=3)
    return path


@pytest.fixture(scope="module")
def baseline(data_dir, tmp_path_factory):
    """One step a dispatch, no prefetch, data in RAM: 7 steps, with
    epochs closing at steps 3 and 6 and a validation sweep at epoch 2."""
    out = loop.run_training(
        _cfg(tmp_path_factory.mktemp("base"), "base"),
        arrays=dataset.load_sequences(data_dir), run_name="run")
    return out


VARIANTS = {
    "steps_per_call4": dict(steps_per_call=4),
    "prefetch2": dict(prefetch=2),
    "steps_per_call2_prefetch2": dict(steps_per_call=2, prefetch=2),
    "lazy_load": dict(lazy_load=True, steps_per_call=4),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loop_is_bit_identical_across_dispatch_options(
        variant, baseline, data_dir, tmp_path):
    """K steps a dispatch (epochs close mid-dispatch, the last dispatch
    is short), the prefetch thread and per-batch reads from disk change
    neither the epoch curves nor the final parameters by a bit."""
    kw = VARIANTS[variant]
    arrays = None if kw.get("lazy_load") else dataset.load_sequences(
        data_dir)
    out = loop.run_training(_cfg(tmp_path, variant, data_dir=data_dir,
                                 **kw), arrays=arrays, run_name="run")
    assert out["global_losses"].shape == (2, 5)
    np.testing.assert_array_equal(out["global_losses"],
                                  baseline["global_losses"])
    np.testing.assert_array_equal(out["global_psnr_all"],
                                  baseline["global_psnr_all"])
    for x, y in zip(out["state"].leaves(), baseline["state"].leaves()):
        assert torch.equal(x, y)
    assert out["state"].step == 7


def test_lazy_sequences_read_what_load_sequences_holds(data_dir):
    lazy = dataset.lazy_sequences(data_dir)
    eager = dataset.load_sequences(data_dir)
    for a, b in zip(lazy, eager):
        assert a.shape == b.shape and len(a) == 8
        np.testing.assert_array_equal(a[np.array([5, 1, 5])], b[[5, 1, 5]])
        np.testing.assert_array_equal(a[2:7][1], b[3])
        assert a[2:7].shape == b[2:7].shape


def test_prefetch_thread_retired_after_nan_abort(tmp_path):
    arrays = synthetic.generate_sequences(6, T, 16, 16)
    cfg = _cfg(tmp_path, "nan", num_iterations=40, steps_per_call=3,
               prefetch=2, train_val_split=1.0, learning_rate=1e18)
    with pytest.raises(FloatingPointError):
        loop.run_training(cfg, arrays=arrays, run_name="run")
    deadline = time.time() + 10.0
    while time.time() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.name == "pivp-input-prefetch" and t.is_alive()]
        if not alive:
            break
        time.sleep(0.1)
    assert not alive, "prefetch producer still alive after the abort"
    assert (tmp_path / "nan" / "run" / "training-nan-epoch1.npz").exists()


def test_steps_per_call_auto_is_one_step_a_dispatch(tmp_path, caplog):
    arrays = synthetic.generate_sequences(4, T, 16, 16)
    with caplog.at_level("INFO", logger=loop.__name__):
        out = loop.run_training(
            _cfg(tmp_path, "auto", num_iterations=1, train_val_split=1.0),
            arrays=arrays, run_name="run")
    assert "steps_per_call: 1 (auto)" in caplog.text
    assert out["state"].step == 1
    with pytest.raises(ValueError, match="checkpointer"):
        dataclasses.replace(_cfg(tmp_path, "x"), checkpointer="orbax")


def _saved(save_dir, name):
    return np.load(os.path.join(save_dir, name + ".npy"))


def _request_at_boundary(monkeypatch, n: int):
    """Set the preemption flag at the n-th dispatch boundary, as the
    SIGTERM handler would mid-run."""
    calls = {"n": 0}
    real = preemption.requested

    def fake():
        calls["n"] += 1
        if calls["n"] == n:
            preemption.request()
        return real()

    monkeypatch.setattr(loop.preemption, "requested", fake)


PREEMPT = {
    # (steps_per_call, prefetch, dispatch boundary of the request): the
    # run stops at iteration 2 (epoch 1 is steps 0-2) or 4 (epoch 2 is
    # steps 3-5, which has the validation sweep).
    "k1_itr2": (1, 0, 2),
    "k2_prefetch_itr4": (2, 2, 2),
}


@pytest.mark.parametrize("case", list(PREEMPT))
def test_preempted_run_resumes_bit_for_bit(case, baseline, data_dir,
                                            tmp_path, monkeypatch):
    k, prefetch, boundary = PREEMPT[case]
    arrays = dataset.load_sequences(data_dir)
    cfg = _cfg(tmp_path, "pre", steps_per_call=k, prefetch=prefetch,
               checkpointer="torch")
    before = signal.getsignal(signal.SIGTERM)
    _request_at_boundary(monkeypatch, boundary)
    try:
        out = loop.run_training(cfg, arrays=arrays, run_name="run")
    finally:
        monkeypatch.undo()
        preemption.clear()
    stop = k * boundary
    assert out["preempted"] is True and out["state"].step == stop
    assert signal.getsignal(signal.SIGTERM) is before
    save_dir = out["save_dir"]
    assert os.path.exists(os.path.join(save_dir,
                                       f"training-preempt-itr{stop}.npz"))
    assert os.path.exists(os.path.join(save_dir, "full-state.pt"))
    assert not glob.glob(os.path.join(save_dir, "*.tmp*"))

    resumed = loop.run_training(cfg, arrays=arrays, run_name="run")
    assert resumed["preempted"] is False and resumed["state"].step == 7
    for x, y in zip(resumed["state"].leaves(), baseline["state"].leaves()):
        assert torch.equal(x, y)
    # Every curve row, the epoch that straddles the preemption included.
    for name in CURVES:
        np.testing.assert_array_equal(
            _saved(resumed["save_dir"], name),
            _saved(baseline["save_dir"], name), err_msg=name)
    want = np.load(os.path.join(baseline["save_dir"], "state-final.npz"))
    got = np.load(os.path.join(resumed["save_dir"], "state-final.npz"))
    assert set(got.files) == set(want.files)
    for key in want.files:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_full_state_round_trips(baseline, tmp_path):
    """What `load_full_state` restores is what `save_full_state` wrote:
    the parameters, the Adam state, the iteration, curves and the
    partial epoch's step metrics."""
    state = baseline["state"]
    curves = ([[1.0, 2.0, 3.0, 4.0, 5.0]], [], [[0.5] * 5], [])
    stream = [(torch.tensor([0.25, 0.5]), torch.tensor([30.0, 31.0]), 1)]
    loop.save_full_state(str(tmp_path), state, 11, curves, stream)
    fresh = loop.ts_lib.create_train_state(
        loop.predictor.init_params(torch.Generator().manual_seed(9),
                                   baseline["model_config"], device="cpu"),
        loop.ts_lib.make_optimizer(1e-3))
    back = loop.load_full_state(str(tmp_path), fresh)
    assert back["itr"] == 11 and fresh.step == 11
    assert back["curves"] == tuple(list(c) for c in curves)
    np.testing.assert_array_equal(back["partial"][0], [0.25])
    np.testing.assert_array_equal(back["partial"][1], [30.0])
    for x, y in zip(fresh.leaves(), state.leaves()):
        assert torch.equal(x, y)
    want = loop.ts_lib.opt_state_tree(state)
    got = loop.ts_lib.opt_state_tree(fresh)
    assert int(got["count"]) == int(want["count"]) == 7
    assert torch.equal(got["mu"]["enc0"]["w"], want["mu"]["enc0"]["w"])
    assert loop.load_full_state(str(tmp_path / "none"), fresh) is None


def test_stale_preemption_flag_cleared_at_install(tmp_path):
    """A flag left set by an earlier preempted run in this process does
    not stop the next run after one dispatch: install() clears it."""
    arrays = synthetic.generate_sequences(4, T, 16, 16)
    preemption.request()
    try:
        out = loop.run_training(
            _cfg(tmp_path, "stale", num_iterations=2, train_val_split=1.0),
            arrays=arrays, run_name="run")
    finally:
        preemption.clear()
    assert out["preempted"] is False and out["state"].step == 2


def test_preemption_handler_sets_flag_and_restores():
    preemption.clear()
    before = signal.getsignal(signal.SIGTERM)
    restore = preemption.install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        # Python runs the handler at the next bytecode boundary.
        for _ in range(1000):
            if preemption.requested():
                break
        assert preemption.requested()
    finally:
        restore()
        preemption.clear()
    assert signal.getsignal(signal.SIGTERM) is before


def test_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    """--profile_dir traces the whole train_cli run with torch.profiler
    (on the CPU: its ops, among them the train step's)."""
    monkeypatch.setattr(train_cli, "TrainConfig", functools.partial(
        tconfig.TrainConfig, model_overrides=tuple(NARROW.items())))
    trace_dir = tmp_path / "trace"
    result = CliRunner().invoke(train_cli.main, [
        "--device", "cpu", "--synthetic", "2", "--num_iterations", "1",
        "--batch_size", "2", "--sequence_length", str(T),
        "--image_height", "16", "--image_width", "16",
        "--train_val_split", "1.0", "--output_dir", str(tmp_path / "m"),
        "--event_log_dir", "", "--run_name", "run",
        "--profile_dir", str(trace_dir)],
        standalone_mode=False, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    traces = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        text = f.read()
    assert "aten::convolution" in text


def test_step_timer_and_nan_debugging():
    timer = profiling.StepTimer("cpu")
    for _ in range(3):
        timer.start()
        timer.stop()
    summary = timer.summary()
    assert summary["steps"] == 3 and summary["min_s"] >= 0.0
    timer.clear()
    assert timer.summary() == {}
    profiling.enable_nan_debugging()
    try:
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
