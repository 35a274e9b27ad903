"""Visualization and reporting: loss-curve plots, conv-filter grids and
layer-activation maps.

Counterpart of `pivp_tpu/visualization/visualize.py`, with the same
figures and file names:
  * `Visualizer` with the `plot_filters` / `plot_activation` /
    `plot_output` grid renderers;
  * the training and validation curves from the saved
    `training-global_losses*.npy` / `*psnr_all*.npy` stat arrays;
  * a checkpoint reloaded, a short feed-self rollout with its stage
    activations captured (`rollout(capture=True)`, which runs the
    forward kernels on the GPU), and per-layer activation grids.
Figures are rendered with matplotlib's Agg backend. matplotlib is
imported when a figure is drawn, so the numeric part
(`model_activations`) runs where it is not installed.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from pivp_tpu_torch.ops import layers

logger = logging.getLogger(__name__)


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


class Visualizer:
    """Grid renderers for filters, activations and outputs."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def _grid(self, tiles: np.ndarray, title: str, path: str,
              cmap: str = "viridis") -> str:
        """The tiles in a near-square grid, each scaled to its own range
        as a per-tile `imshow` would, drawn as one image (one axes per
        tile made a 128-channel grid take seconds)."""
        n, th, tw = tiles.shape
        cols = int(math.ceil(math.sqrt(n)))
        rows = int(math.ceil(n / cols))
        mosaic = np.full((rows * (th + 1) - 1, cols * (tw + 1) - 1),
                         np.nan)
        for i, tile in enumerate(tiles.astype(np.float64)):
            lo, hi = tile.min(), tile.max()
            r, c = divmod(i, cols)
            mosaic[r * (th + 1):r * (th + 1) + th,
                   c * (tw + 1):c * (tw + 1) + tw] = (
                (tile - lo) / (hi - lo) if hi > lo else 0.0)
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(1.0 + cols * 0.6, 1.0 + rows * 0.6))
        ax.axis("off")
        ax.imshow(mosaic, cmap=cmap, vmin=0.0, vmax=1.0,
                  interpolation="nearest")
        fig.suptitle(title)
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path

    def plot_filters(self, weights: np.ndarray, name: str) -> str:
        """Conv kernel grid. weights: the port's conv layout (out, in,
        kh, kw); one tile per output channel (mean over the input
        channels)."""
        return self._grid(weights.mean(axis=1), f"{name} filters",
                          os.path.join(self.out_dir,
                                       f"{name}-filters.png"))

    def plot_activation(self, activation: np.ndarray, name: str,
                        sample: int = 0) -> str:
        """Feature-map grid. activation: (B, H, W, C); one tile per
        channel of one sample."""
        tiles = np.transpose(activation[sample], (2, 0, 1))
        return self._grid(tiles, f"{name} activations",
                          os.path.join(self.out_dir,
                                       f"{name}-activation.png"))

    def plot_output(self, images: np.ndarray, name: str) -> str:
        """RGB frame strip. images: (N, H, W, C) in [0, 1]."""
        imgs = np.clip(images, 0.0, 1.0)
        plt = _pyplot()
        fig, axes = plt.subplots(1, len(imgs),
                                 figsize=(len(imgs) * 1.8, 2.0))
        for ax, img in zip(np.atleast_1d(axes).ravel(), imgs):
            ax.axis("off")
            ax.imshow(img)
        path = os.path.join(self.out_dir, f"{name}-output.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path


def plot_loss_curves(save_dir: str, out_dir: Optional[str] = None
                     ) -> List[str]:
    """Plot the mean +- std train (and validation, if present) loss and
    PSNR curves from the stat arrays the trainer writes (rows of [mean,
    std, min, max, median])."""
    out_dir = out_dir or save_dir
    os.makedirs(out_dir, exist_ok=True)
    plt = _pyplot()
    written = []
    curves = {
        "training-global_losses.npy": "train loss",
        "training-global_losses_valid.npy": "validation loss",
        "training-global_psnr_all.npy": "train PSNR",
        "training-global_psnr_all_valid.npy": "validation PSNR",
    }
    for fname, label in curves.items():
        path = os.path.join(save_dir, fname)
        if not os.path.exists(path):
            continue
        arr = np.load(path)
        if arr.size == 0:
            continue
        mean, std = arr[:, 0], arr[:, 1]
        x = np.arange(len(mean))
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(x, mean, label=label)
        ax.fill_between(x, mean - std, mean + std, alpha=0.25)
        ax.set_xlabel("epoch")
        ax.set_ylabel(label)
        ax.legend()
        fig.tight_layout()
        out = os.path.join(out_dir, fname.replace(".npy", ".png"))
        fig.savefig(out, dpi=120)
        plt.close(fig)
        written.append(out)
    return written


ENC_NAMES = ("enc0", "enc1", "enc2", "enc3", "enc4", "enc5", "enc6",
             "enc7")


def project_activation(conv_w: torch.Tensor, activation: torch.Tensor,
                       stride: int, padding: int,
                       outsize) -> torch.Tensor:
    """Deconv-project a (B, h, w, C_out) activation back to the input
    pixel space through the conv's own weights: the adjoint of the conv,
    the reference's deconv-projection helper (`deconvolution_2d(x,
    conv.W, stride, pad, outsize)`). Returns (B, H, W, C_in).

    conv_w is the port's conv layout (out, in, kh, kw), which is already
    the transposed conv's (in, out, kh, kw) layout for a deconv from the
    activation's channels back to the conv's input channels."""
    w = conv_w.to(activation.dtype)
    p = {"w": w, "b": w.new_zeros((w.shape[1],))}
    return layers.deconv2d(p, activation, stride=stride, padding=padding,
                           outsize=tuple(outsize))


@torch.no_grad()
def model_activations(checkpoint_path: str, model_type: str,
                      images: np.ndarray, actions: np.ndarray,
                      states: np.ndarray, num_masks: int = 10,
                      context_frames: int = 2, use_state: bool = True,
                      all_timesteps: bool = False,
                      reference_literal: bool = False,
                      device="cuda") -> Dict[str, object]:
    """The numbers `visualize_model` draws: reload a checkpoint and run a
    short feed-self rollout of one sequence with its stage activations
    captured, on `device` (the forward kernels on the GPU). Returns
    numpy arrays: "conv_res" (enc0..enc7 of the last step),
    "conv_res_all" (each (T-1, 1, h, w, C)), "steps" (the rendered
    timesteps: first, middle and last, or all with `all_timesteps`),
    "projected" (enc0 of each rendered step projected back to pixels,
    (H, W, C)), "gen_images" (T-1, H, W, C) and "filters" (the
    enc0..enc2 conv weights, (out, in, kh, kw))."""
    from pivp_tpu_torch.inference import predict as predict_lib
    from pivp_tpu_torch.models import predictor

    t = images.shape[0]
    cfg, params = predict_lib.load_model(
        checkpoint_path, model_type, num_masks, context_frames,
        use_state, -1.0, images.shape[1], images.shape[2], t,
        reference_literal=reference_literal, device=device)
    dev = params["enc0"]["w"].device

    def seq(a):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=dev).reshape(t, 1, -1)

    out = predictor.rollout(
        params, cfg,
        torch.as_tensor(np.asarray(images, np.float32), device=dev)[:, None],
        seq(actions), seq(states), train=False, capture=True)
    n_steps = int(out["gen_images"].shape[0])
    steps = (list(range(n_steps)) if all_timesteps
             else sorted({0, n_steps // 2, n_steps - 1}))
    h, w = images.shape[1], images.shape[2]
    enc0_all = out["conv_res_all"][0]
    return {
        "conv_res": [a.cpu().numpy() for a in out["conv_res"]],
        "conv_res_all": [a.cpu().numpy() for a in out["conv_res_all"]],
        "steps": steps,
        "projected": {ti: project_activation(
            params["enc0"]["w"], enc0_all[ti], stride=2, padding=2,
            outsize=(h, w))[0].cpu().numpy() for ti in steps},
        "gen_images": out["gen_images"][:, 0].float().cpu().numpy(),
        "filters": {name: params[name]["w"].cpu().numpy()
                    for name in ("enc0", "enc1", "enc2")},
    }


def visualize_model(checkpoint_path: str, model_type: str,
                    images: np.ndarray, actions: np.ndarray,
                    states: np.ndarray, out_dir: str,
                    num_masks: int = 10, context_frames: int = 2,
                    use_state: bool = True,
                    all_timesteps: bool = False,
                    reference_literal: bool = False,
                    device="cuda") -> List[str]:
    """Reload a checkpoint, run a short feed-self rollout with activation
    capture on `device` (`model_activations`) and render per-layer
    activation grids: the last timestep (the reference's Model.conv_res
    view) plus per-timestep grids (first, middle and last by default,
    every step with `all_timesteps`), the enc0 activations projected
    back to pixel space, the predicted frames and the trunk's filters."""
    acts = model_activations(
        checkpoint_path, model_type, images, actions, states,
        num_masks=num_masks, context_frames=context_frames,
        use_state=use_state, all_timesteps=all_timesteps,
        reference_literal=reference_literal, device=device)
    viz = Visualizer(out_dir)
    written = []
    for name, act in zip(ENC_NAMES, acts["conv_res"]):
        written.append(viz.plot_activation(act, name))
    for name, per_step in zip(ENC_NAMES, acts["conv_res_all"]):
        for ti in acts["steps"]:
            written.append(viz.plot_activation(per_step[ti],
                                               f"{name}-t{ti}"))
    for ti, proj in acts["projected"].items():
        lo, hi = proj.min(), proj.max()
        if hi > lo:
            proj = (proj - lo) / (hi - lo)
        written.append(viz.plot_output(proj[None],
                                       f"enc0-projected-t{ti}"))
    written.append(viz.plot_output(acts["gen_images"], "prediction"))
    for name, weight in acts["filters"].items():
        written.append(viz.plot_filters(weight, name))
    return written
