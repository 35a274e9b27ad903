"""The training loop on one device.

Counterpart of `pivp_tpu/training/loop.py` without its mesh, multi-host,
orbax, K-step dispatch and prefetch branches. It keeps the reference
training loop's contract:
  * map.csv in-RAM dataset, leading-fraction train/val split and a
    seeded shuffled epoch stream;
  * Adam (Chainer's rule), warm start from `pretrained_model` (weights)
    and `pretrained_state` (optimizer state);
  * per-epoch [mean, std, min, max, median] rows of the step losses and
    PSNRs, exact validation sweeps every `validation_interval` epochs,
    npz checkpoints and metric curves every `save_interval` epochs and
    at the end, a JSONL event log, and a NaN guard that saves an
    emergency checkpoint and stops.

Scheduled sampling draws each step's uniforms from a generator seeded
from (seed + 1, absolute iteration), so the sampling stream does not
depend on where a run starts. Frames travel to the device as uint8 when
`u8_transfer` is on and are dequantized there. Step metrics stay device
tensors until the epoch flush, so no step waits on the device.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pivp_tpu_torch.config import TrainConfig
from pivp_tpu_torch.data import dataset as dataset_lib
from pivp_tpu_torch.models import predictor
from pivp_tpu_torch.ops import sampling
from pivp_tpu_torch.parallel import train_step as ts_lib
from pivp_tpu_torch.utils import checkpoint as ckpt_lib
from pivp_tpu_torch.utils import logging_utils, weights
from pivp_tpu_torch.utils.device import resolve_device, to_device

logger = logging.getLogger(__name__)


def run_training(cfg: TrainConfig,
                 arrays: Optional[Tuple[np.ndarray, ...]] = None,
                 run_name: Optional[str] = None) -> Dict[str, object]:
    """Train a model on `cfg.device`; returns a dict with the final
    TrainState, save_dir, run_name and the epoch curves.

    `arrays` overrides on-disk data with in-memory (images, actions,
    states) of shape (N, T, ...)."""
    mcfg = cfg.model_config()
    device = resolve_device(cfg.device)

    if arrays is None:
        arrays = dataset_lib.load_sequences(cfg.data_dir)
    n_total = arrays[0].shape[0]
    train_arrays, val_arrays = dataset_lib.train_val_split(
        arrays, cfg.train_val_split)
    logger.info(
        "Data set contains %d sequences: %d train / %d validation",
        n_total, train_arrays[0].shape[0], val_arrays[0].shape[0])

    params = predictor.init_params(torch.Generator().manual_seed(cfg.seed),
                                   mcfg, device=device)
    state = ts_lib.create_train_state(
        params, ts_lib.make_optimizer(cfg.learning_rate))
    if cfg.pretrained_model:
        loaded = weights.flatten(ckpt_lib.load_npz_into(
            cfg.pretrained_model, state.params))
        with torch.no_grad():
            for key, p in weights.flatten(state.params).items():
                p.copy_(loaded[key])
        logger.info("Loaded pretrained model %s", cfg.pretrained_model)
    if cfg.pretrained_state:
        ts_lib.load_opt_state_tree(state, ckpt_lib.load_npz_into(
            cfg.pretrained_state, ts_lib.opt_state_tree(state)))
        logger.info("Loaded pretrained optimizer state %s",
                    cfg.pretrained_state)

    train_step = ts_lib.make_train_step(mcfg, remat=cfg.remat,
                                        grad_accum=cfg.grad_accum)
    eval_step = ts_lib.make_eval_step(mcfg)

    if run_name is None:
        run_name = "{0}-{1}-{2}".format(
            time.strftime("%Y%m%d-%H%M%S"), cfg.model_type, cfg.batch_size)
    save_dir = None
    batcher = dataset_lib.EpochBatcher(train_arrays, cfg.batch_size,
                                       seed=cfg.seed)
    global_losses: List[List[float]] = []
    global_psnr_all: List[List[float]] = []
    global_losses_valid: List[List[float]] = []
    global_psnr_all_valid: List[List[float]] = []
    curves = (global_losses, global_psnr_all, global_losses_valid,
              global_psnr_all_valid)
    last_metrics = None

    def flush_epoch(epoch: int, losses_np: np.ndarray,
                    psnr_np: np.ndarray, elapsed: float) -> None:
        nonlocal save_dir
        if cfg.nan_guard and not np.isfinite(losses_np).all():
            save_dir = ckpt_lib.prepare_run_dir(cfg.output_dir, run_name)
            _save_checkpoint(save_dir, f"nan-epoch{epoch}", state, *curves)
            raise FloatingPointError(
                f"non-finite training loss at epoch {epoch}; emergency "
                f"checkpoint saved to {save_dir}")
        global_losses.append(logging_utils.epoch_stats(list(losses_np)))
        global_psnr_all.append(logging_utils.epoch_stats(list(psnr_np)))
        logger.info("[TRAIN] Epoch #: %d (%.2fs)  loss: %.6f  psnr: %.3f",
                    epoch, elapsed, losses_np.mean(), psnr_np.mean())
        summaries = logging_utils.frame_summaries(
            "train", {k: v.cpu().numpy() for k, v in last_metrics.items()})
        _write_event(cfg.event_log_dir, run_name, {
            "epoch": epoch, "iteration": itr + 1,
            "train_loss": logging_utils.epoch_stats(list(losses_np)),
            "train_psnr": logging_utils.epoch_stats(list(psnr_np)),
            "elapsed_s": elapsed,
            "summaries": summaries,
        })

        if (epoch % cfg.validation_interval == 0
                and val_arrays[0].shape[0] > 0):
            v = run_validation(eval_step, state.params, val_arrays,
                               cfg.batch_size, mcfg.state_cost_weight,
                               u8_transfer=cfg.u8_transfer, device=device)
            global_losses_valid.append(
                logging_utils.epoch_stats([v["loss"]]))
            global_psnr_all_valid.append(
                logging_utils.epoch_stats([v["psnr_all"]]))
            logger.info(
                "[VALID] Epoch #: %d  loss: %.6f  psnr: %.3f  "
                "per-image-psnr: %.3f dB  ssim: %.4f  (n=%d)",
                epoch, v["loss"], v["psnr_all"], v["psnr_per_image"],
                v["ssim"], v["n_sequences"])
            _write_event(cfg.event_log_dir, run_name, {
                "epoch": epoch, "iteration": itr + 1, "split": "validation",
                "loss": logging_utils.epoch_stats([v["loss"]]),
                "psnr_all": logging_utils.epoch_stats([v["psnr_all"]]),
                "psnr_per_image": v["psnr_per_image"],
                "ssim": v["ssim"],
                "n_sequences": v["n_sequences"],
            })

        if epoch % cfg.save_interval == 0:
            save_dir = ckpt_lib.prepare_run_dir(cfg.output_dir, run_name)
            _save_checkpoint(save_dir, epoch, state, *curves)

    # (loss, psnr_all) device scalars of the steps since the last flush.
    stream: List[Tuple[torch.Tensor, torch.Tensor]] = []
    epoch_start = time.time()
    for itr in range(cfg.num_iterations):
        images, actions, states = batcher.next()
        if cfg.u8_transfer:
            images = _quantize_images(images)
        batch = tuple(to_device(torch.from_numpy(a), device)
                      for a in (images, actions, states))
        state, metrics = train_step(state, batch, itr,
                                    sampling.generator(cfg.seed + 1, itr))
        stream.append((metrics["loss"], metrics["psnr_all"]))
        last_metrics = metrics
        if cfg.debug and (itr < 3 or itr % 50 == 0):
            logger.info("iter %d: loss=%.6f psnr=%.3f", itr,
                        float(metrics["loss"]), float(metrics["psnr_all"]))
        if batcher.is_new_epoch:
            losses_np, psnr_np = (
                torch.stack(col).to(torch.float64).cpu().numpy()
                for col in zip(*stream))
            stream = []
            flush_epoch(batcher.epoch, losses_np, psnr_np,
                        time.time() - epoch_start)
            epoch_start = time.time()

    save_dir = ckpt_lib.prepare_run_dir(cfg.output_dir, run_name)
    _save_checkpoint(save_dir, "final", state, *curves)
    return {
        "state": state,
        "save_dir": save_dir,
        "run_name": run_name,
        "global_losses": np.asarray(global_losses),
        "global_psnr_all": np.asarray(global_psnr_all),
        "last_metrics": last_metrics,
        "model_config": mcfg,
    }


def run_validation(eval_step, params, val_arrays, batch_size: int,
                   state_cost_weight: float, u8_transfer: bool = False,
                   device="cuda") -> Dict[str, float]:
    """One exact validation sweep, on `device` (the GPU unless the caller
    asks for the CPU; raises on a host without one).

    Aggregates the per-(frame, sequence) metric matrices of the eval
    step, masking the padded duplicate rows of the final partial batch,
    so every metric is independent of batch_size."""
    device = resolve_device(device)
    recon_cols, state_cols, ssim_cols = [], [], []
    for vbatch, n_valid in dataset_lib.eval_batches(val_arrays,
                                                    batch_size):
        if u8_transfer:
            vbatch = (_quantize_images(vbatch[0]), vbatch[1], vbatch[2])
        vbatch = tuple(to_device(torch.from_numpy(a), device)
                       for a in vbatch)
        out = eval_step(params, vbatch)
        recon_cols.append(out["recon_mse_tb"].cpu().numpy()[:, :n_valid])
        state_cols.append(out["state_mse_tb"].cpu().numpy()[:, :n_valid])
        ssim_cols.append(out["ssim_tb"].cpu().numpy()[:, :n_valid])
    recon = np.concatenate(recon_cols, axis=1)       # (T-ctx, N_val)
    state_mse = np.concatenate(state_cols, axis=1)
    ssim_tb = np.concatenate(ssim_cols, axis=1)
    num_pred = recon.shape[0]
    frame_mse = recon.mean(axis=1)
    loss = float((frame_mse.sum()
                  + state_cost_weight * state_mse.mean(axis=1).sum())
                 / num_pred)
    return {
        "loss": loss,
        # Reference batch-PSNR convention, over the full val set.
        "psnr_all": float(np.sum(10.0 * np.log10(1.0 / frame_mse))),
        "psnr_per_image": float(np.mean(10.0 * np.log10(1.0 / recon))),
        "ssim": float(ssim_tb.mean()),
        "n_sequences": int(recon.shape[1]),
    }


def _quantize_images(images: np.ndarray) -> np.ndarray:
    """[0,1] float frames -> uint8 for the host->device transfer
    (dequantized on the device in the rollout); the rounding and
    clipping of ops/transforms.quantize_frames_u8."""
    return np.clip(images * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


def _write_event(event_log_dir: str, run_name: str, record: Dict) -> None:
    """Append one JSON line of epoch telemetry to
    `<event_log_dir>/<run_name>-events.jsonl`."""
    if not event_log_dir:
        return
    os.makedirs(event_log_dir, exist_ok=True)
    path = os.path.join(event_log_dir, f"{run_name}-events.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


_CURVE_FILES = ("training-global_losses", "training-global_psnr_all",
                "training-global_losses_valid",
                "training-global_psnr_all_valid")


def _save_checkpoint(save_dir: str, tag, state: ts_lib.TrainState,
                     *curves) -> None:
    """Write `training-<tag>.npz` (weights), `state-<tag>.npz` (optimizer
    state) and the four metric-curve `.npy` files, in the JAX package's
    layouts."""
    ckpt_lib.save_npz(os.path.join(save_dir, f"training-{tag}"),
                      state.params)
    ckpt_lib.save_npz(os.path.join(save_dir, f"state-{tag}"),
                      ts_lib.opt_state_tree(state))
    for name, curve in zip(_CURVE_FILES, curves):
        np.save(os.path.join(save_dir, name), np.asarray(curve))
    logger.info("Saved checkpoint %s to %s", tag, save_dir)
