"""Scheduled sampling.

Counterpart of `pivp_tpu/ops/sampling.py`: exactly `num_ground_truth`
uniformly random rows of the batch take the ground-truth frame, the rest
the generated one, through a random ranking and a `torch.where`, so the
mix stays on the device and differentiable through the generated rows.

The count is computed on the host from the Python iteration number, so
no step waits on the device for it; a captured train step reads it from
a device tensor that the host fills. The uniforms come from an explicit
`torch.Generator`; torch cannot reproduce `jax.random`'s streams, so the
two packages agree on the mix only where it is deterministic (no
sampling, n_gt = 0 or n_gt = B).
"""

from __future__ import annotations

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def num_ground_truth(batch_size: int, k: float, iter_num: float) -> int:
    """Inverse-sigmoid decay round(B * k / (k + exp(iter/k))), in float32
    with round-half-to-even, as the JAX package computes it."""
    f32 = np.float32
    with np.errstate(over="ignore"):
        frac = f32(k) / (f32(k) + np.exp(f32(iter_num) / f32(k)))
    return int(np.round(f32(batch_size) * frac))


def scheduled_sample(uniforms: torch.Tensor, ground_truth: torch.Tensor,
                     generated: torch.Tensor, n_ground_truth,
                     detach_sampled: bool = False) -> torch.Tensor:
    """Mix exactly `n_ground_truth` rows of ground truth (those whose
    uniform ranks below it) with generated rows for the rest. The count
    is an int, or a 0-d tensor on the uniforms' device (what a captured
    train step reads).

    uniforms: (B,), or (B_global,) for a data-parallel rank's share of
    a global batch: the ranking then runs over the whole global batch,
    whose uniforms come rotated so that this rank's B rows lead, and
    the first B decisions are this batch's (parallel/train_step.
    step_sampling); ground_truth / generated: (B, ...).
    `detach_sampled=True` blocks gradients through the mixed result (the
    reference's CPU round-trip side effect)."""
    rank = torch.argsort(torch.argsort(uniforms))[:ground_truth.shape[0]]
    is_gt = (rank < n_ground_truth).to(ground_truth.device)
    shape = (ground_truth.shape[0],) + (1,) * (ground_truth.ndim - 1)
    mixed = torch.where(is_gt.reshape(shape), ground_truth, generated)
    return mixed.detach() if detach_sampled else mixed


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data), in the role of
    `jax.random.fold_in`: the splitmix64 finalizer of their mix, so
    nearby inputs give unrelated seeds."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def generator(seed: int, *fold: int) -> torch.Generator:
    """A CPU generator seeded from `seed` folded with each of `fold`."""
    for data in fold:
        seed = fold_in(seed, data)
    return torch.Generator().manual_seed(seed)
