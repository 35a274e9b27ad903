"""The serving function of the feed-self prediction rollout.

Counterpart of `make_serve_fn` in `pivp_tpu/inference/export.py`, with
the same contract:

  serve(images (ctx, B, H, W, C) f32 [0,1],
        actions (T-1, B, A) — one action per predicted transition,
        state0 (B, S) — the initial end-effector state)
    -> predicted frames (T-ctx, B, H, W, C) uint8

Only the context frames are image input: after the warm start the
rollout feeds back its own frames and states. Frames are quantized to
uint8 on the device. The serialized artifact of the JAX package (a
`jax.export` module) has no counterpart yet.
"""

from __future__ import annotations

import torch

from pivp_tpu_torch.models import predictor
from pivp_tpu_torch.ops import transforms


def make_serve_fn(params, cfg):
    """Build serve(images, actions, state0) with params closed over. It
    runs on the params' device; inputs may be numpy arrays or tensors,
    the output is a uint8 tensor on that device."""
    ctx = cfg.context_frames
    t = cfg.sequence_length
    device = params["enc0"]["w"].device

    @torch.inference_mode()
    def serve(images, actions, state0):
        images = torch.as_tensor(images, device=device).to(torch.float32)
        actions = torch.as_tensor(actions, device=device).to(torch.float32)
        state0 = torch.as_tensor(state0, device=device).to(torch.float32)
        # The rollout reads length-T stacks; under feed-self only the
        # context frames, the T-1 actions and state0 matter, so the rest
        # is zero padding.
        full = torch.cat([images, images.new_zeros(
            (t - ctx,) + tuple(images.shape[1:]))])
        acts = torch.cat([actions, actions.new_zeros(
            (1,) + tuple(actions.shape[1:]))])
        stas = state0.new_zeros((t,) + tuple(state0.shape))
        stas[0] = state0
        gen, _ = predictor.rollout_frames(params, cfg, full, acts, stas)
        return transforms.quantize_frames_u8(gen[ctx - 1:])

    return serve
