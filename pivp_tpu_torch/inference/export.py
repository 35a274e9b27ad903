"""The serving function of the feed-self prediction rollout, and its
serialized artifact.

Counterpart of `pivp_tpu/inference/export.py`, with the same contract:

  serve(images (ctx, B, H, W, C) f32 [0,1],
        actions (T-1, B, A) — one action per predicted transition,
        state0 (B, S) — the initial end-effector state)
    -> predicted frames (T-ctx, B, H, W, C) uint8

Only the context frames are image input: after the warm start the
rollout feeds back its own frames and states. Frames are quantized to
uint8 on the device.

`export_serving_artifact` writes the rollout, with its weights baked in
and its batch fixed, as a `torch.export` program (`.pt2`), which
`load_serving_artifact` loads without the model code. The port's CUDA
kernels are dispatcher ops (`torch.ops.pivp.*`, ops/kernels/), so the
program holds each launch as a node and replays it. The one difference
from the JAX package's `jax.export` artifact: loading needs those ops
registered, that is `pivp_tpu_torch.ops.kernels` importable, where a
StableHLO module needs nothing of the package.
"""

from __future__ import annotations

import collections
import logging
import os
from typing import Dict, NamedTuple, Tuple

import torch

from pivp_tpu_torch.utils import weights
from pivp_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def _serve(params, cfg, images, actions, state0) -> torch.Tensor:
    """The rollout on float32 inputs: the length-T stacks it reads are
    zero-padded around the serving inputs (under feed-self only the
    context frames, the T-1 actions and state0 matter), then the
    predicted frames are quantized."""
    from pivp_tpu_torch.models import predictor
    from pivp_tpu_torch.ops import transforms

    ctx, t = cfg.context_frames, cfg.sequence_length
    full = torch.cat([images, images.new_zeros(
        (t - ctx,) + tuple(images.shape[1:]))])
    acts = torch.cat([actions, actions.new_zeros(
        (1,) + tuple(actions.shape[1:]))])
    stas = torch.cat([state0[None], state0.new_zeros(
        (t - 1,) + tuple(state0.shape))])
    gen, _ = predictor.rollout_frames(params, cfg, full, acts, stas)
    return transforms.quantize_frames_u8(gen[ctx - 1:])


def make_serve_fn(params, cfg):
    """Build serve(images, actions, state0) with params closed over. It
    runs on the params' device; inputs may be numpy arrays or tensors,
    the output is a uint8 tensor on that device."""
    device = params["enc0"]["w"].device

    @torch.inference_mode()
    def serve(images, actions, state0):
        return _serve(params, cfg, *(
            torch.as_tensor(a, device=device).to(torch.float32)
            for a in (images, actions, state0)))

    return serve


class ServingModule(torch.nn.Module):
    """`make_serve_fn`'s rollout as a module: the parameters are buffers
    (named by their '/'-joined keys with '/' as '__'), the config fixed."""

    def __init__(self, params, cfg):
        super().__init__()
        self.cfg = cfg
        self.names = {}
        for key, tensor in weights.flatten(params).items():
            self.names[key] = key.replace("/", "__")
            self.register_buffer(self.names[key], tensor.detach())

    def forward(self, images, actions, state0):
        params = weights.unflatten({k: getattr(self, n)
                                    for k, n in self.names.items()})
        return _serve(params, self.cfg, images, actions, state0)


class InputSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg, batch: int) -> Tuple[InputSpec, ...]:
    """The shapes and types of (images, actions, state0) at `batch`."""
    ctx, t = cfg.context_frames, cfg.sequence_length
    return (InputSpec((ctx, batch, cfg.image_height, cfg.image_width,
                       cfg.color_channels), torch.float32),
            InputSpec((t - 1, batch, cfg.action_dim), torch.float32),
            InputSpec((batch, cfg.state_dim), torch.float32))


def export_serving_artifact(params, cfg, batch: int, path: str) -> None:
    """Serialize the serving rollout at `batch`, weights baked in, to
    `path` (a `.pt2` file of `torch.export.save`). The rollout is traced
    on the params' device by `torch.export` under `torch.no_grad` (not
    `inference_mode`, which export does not take), with no
    decompositions run, so the convolutions stay convolutions and each
    kernel launch is a `torch.ops.pivp` node."""
    device = params["enc0"]["w"].device
    example = tuple(torch.zeros(s.shape, dtype=s.dtype, device=device)
                    for s in input_specs(cfg, batch))
    with torch.no_grad():
        program = torch.export.export(ServingModule(params, cfg), example)
    torch.export.save(program, path)
    logger.info("Exported %s serving artifact (%d bytes, batch %d, %s) "
                "to %s", cfg.model_type, os.path.getsize(path), batch,
                device, path)


def kernel_nodes(program) -> Dict[str, int]:
    """How many nodes of each `torch.ops.pivp` op the program's graph
    holds, by op name (e.g. "local_apply_fwd")."""
    found = collections.Counter()
    for node in program.graph.nodes:
        if (node.op == "call_function"
                and isinstance(node.target, torch._ops.OpOverload)
                and node.target.namespace == "pivp"):
            found[node.target.name().split("::")[1]] += 1
    return dict(found)


def load_serving_artifact(path: str):
    """Load an artifact written by `export_serving_artifact`; returns a
    callable f(images, actions, state0) -> uint8 frames on the
    artifact's device, which takes numpy arrays or tensors. It exposes
    the input specs as `f.in_specs` (InputSpecs of (images, actions,
    state0)), the program as `f.exported` and its device as `f.device`.

    Imports the port's kernel ops (not its model code) and resolves the
    artifact's device as every entry point does: a CUDA artifact raises
    without a GPU, and TF32 goes off, as for `make_serve_fn`."""
    # Importing the kernel modules registers the pivp ops.
    from pivp_tpu_torch.ops.kernels import local_apply, lstm_gates  # noqa: F401

    program = torch.export.load(path)
    device = resolve_device(next(iter(program.state_dict.values())).device)
    signature = program.graph_signature
    specs = tuple(
        InputSpec(tuple(node.meta["val"].shape), node.meta["val"].dtype)
        for node in program.graph.nodes
        if node.op == "placeholder" and node.name in signature.user_inputs)
    module = program.module()

    @torch.no_grad()
    def call(images, actions, state0):
        return module(*(torch.as_tensor(a, device=device).to(s.dtype)
                        for a, s in zip((images, actions, state0), specs)))

    call.in_specs = specs
    call.exported = program
    call.device = device
    return call
