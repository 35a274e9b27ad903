"""The rollout and gradient agreement checks of chip_smoke.py, on the
CPU at a tiny size: they pass when every rollout or step is float32 of
the same model; the card-vs-CPU rollout check fails a card whose
rollout drifts from the CPU's float64 one even when its kernel and
plain paths drift together, and the card-vs-float64 gradient check a
card whose gradient drifts; replaying the STP sampler's recorded cells
reproduces a step."""

import dataclasses

import pytest
import torch

import chip_smoke
from pivp_tpu_torch.config import ModelConfig
from pivp_tpu_torch.data import synthetic
from pivp_tpu_torch.inference import export
from pivp_tpu_torch.models import predictor
from pivp_tpu_torch.ops import sampling
from pivp_tpu_torch.parallel import train_step as ts

HEADS = {"CDNA": {}, "DNA": dict(model_type="DNA", num_masks=1),
         "STP": dict(model_type="STP"),
         "STP_per_mask": dict(model_type="STP", stp_shared_params=False)}


def _setup(head: str):
    cfg = ModelConfig(**HEADS[head], image_height=16, image_width=16,
                      sequence_length=4)
    arrays = synthetic.generate_sequences(4, 4, 16, 16, seed=0)
    batch = tuple(torch.as_tensor(a.swapaxes(0, 1).copy()) for a in arrays)
    params = predictor.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    images, actions, states = batch
    frames = export.make_serve_fn(params, cfg)(
        images[:cfg.context_frames], actions[:cfg.sequence_length - 1],
        states[0])
    return cfg, params, batch, frames


@pytest.mark.parametrize("head", list(HEADS))
def test_check_rollouts_passes_float32_rollouts_of_one_model(head, capsys):
    cfg, params, batch, frames = _setup(head)
    chip_smoke.check_rollouts(params, cfg, *batch, frames)
    out = capsys.readouterr().out
    assert "kernels vs plain ops" in out and "card vs CPU" in out


def test_check_rollouts_fails_a_card_that_drifts_from_float64(
        monkeypatch, capsys):
    """The "card" (the params object the check is given) rolls out 1e-3
    off through both its kernel and its plain path, so the two agree
    and only the card-vs-CPU check, whose limit the CPU's rollouts set,
    can see it."""
    cfg, params, batch, frames = _setup("STP")
    predict = predictor.predict

    def drifting(p, c, *args):
        out = predict(p, c, *args)
        if p is params:
            out = dict(out, gen_images=out["gen_images"] + 1e-3)
        return out

    monkeypatch.setattr(predictor, "predict", drifting)
    with pytest.raises(SystemExit):
        chip_smoke.check_rollouts(params, cfg, *batch, frames)
    assert "card vs CPU" in capsys.readouterr().out
    # The same card without the drift passes.
    monkeypatch.setattr(predictor, "predict", predict)
    chip_smoke.check_rollouts(params, dataclasses.replace(cfg), *batch,
                              frames)


def _trainable(params):
    return predictor.map_params(lambda p: p.detach().requires_grad_(),
                                params)


def _grads(params, cfg, batch, it=6000):
    return ts.grads_and_metrics(params, cfg, batch, it,
                                sampling.generator(1, it))[0]


@pytest.mark.parametrize("head", ["STP", "STP_per_mask"])
def test_sampler_cells_replayed_reproduce_the_step(head):
    cfg, params, batch, _ = _setup(head)
    params = _trainable(params)
    cells = []
    with chip_smoke.sampler_cells(cells) as moved:
        want = _grads(params, cfg, batch)
    # One x and one y cell per sampled pixel, warp and timestep.
    warps = 1 if cfg.stp_shared_params else cfg.num_masks - 1
    assert len(cells) == 2 * (cfg.sequence_length - 1) and not moved
    assert sum(c.numel() for c in cells) == (
        2 * (cfg.sequence_length - 1) * 4 * warps * 16 * 16)
    with chip_smoke.sampler_cells(cells, replay=True) as moved:
        got = _grads(params, cfg, batch)
    assert chip_smoke.count(moved) == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # Cells a pixel off move every cell of the first step (whose own
    # cells are the recorded ones), and the gradient with them.
    shifted = [c + 1 for c in cells]
    with chip_smoke.sampler_cells(shifted, replay=True) as moved:
        off = _grads(params, cfg, batch)
    assert int(moved[0]) == cells[0].numel()
    assert not all(torch.allclose(a, b) for a, b in zip(off, want))


@pytest.mark.parametrize("head", list(HEADS))
def test_check_step_grads_passes_float32_steps_of_one_model(head, capsys):
    cfg, params, batch, _ = _setup(head)
    chip_smoke.check_step_grads(_trainable(params), cfg, batch, 1, (6000,))
    out = capsys.readouterr().out
    assert "kernels vs plain ops" in out
    assert ("sampler cells" in out) == cfg.is_stp


def test_check_card_vs_float64_fails_a_card_whose_gradient_drifts(
        monkeypatch, capsys):
    """The "card" (the params object the check is given) gets a gradient
    1e-3 off; the limit comes from the CPU's float32 step, which the
    drift does not reach."""
    cfg, params, batch, _ = _setup("STP")
    params = _trainable(params)
    grads_and_metrics = ts.grads_and_metrics

    def drifting(p, *args):
        grads, metrics = grads_and_metrics(p, *args)
        if p is params:
            grads = [g * (1 + 1e-3) for g in grads]
        return grads, metrics

    monkeypatch.setattr(ts, "grads_and_metrics", drifting)
    with pytest.raises(SystemExit):
        chip_smoke.check_card_vs_float64(params, cfg, batch, 1)
    assert "card vs float64" in capsys.readouterr().out
    # The same card without the drift passes.
    monkeypatch.setattr(ts, "grads_and_metrics", grads_and_metrics)
    chip_smoke.check_card_vs_float64(params, cfg, batch, 1)
