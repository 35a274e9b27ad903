#!/usr/bin/env python3
"""Why two float32 gradients of one STP train step differ, on the GPU.

For each head (STP with a shared projection, STP with one per mask) at
the size of `chip_smoke.py`'s train phases (batch 32, 64x64x3, T=10, 2
context frames; params from each of --seeds, the batch from seed+1),
each of --states train states is made as `chip_smoke.py` makes its
own: 9 train steps at iterations 0-8 with cuDNN's default algorithms,
whose run-to-run change gives each state its own rounding. At each of
--iterations, with cudnn.deterministic on as in the smoke's checks, the
gradient of one step is taken through

  kernels      the CUDA kernels (the cells the STP sampler takes, the
               floor of each source coordinate, are recorded)
  plain        both kernel switches off
  plain@k      the plain ops, sampling the kernels' cells
  f64          the plain ops in float64, on the GPU
  f64@k        the same, sampling the kernels' cells

and printed as whole-gradient relative Frobenius distances (with the
worst tensor), beside how many of the plain and float64 steps' own
cells differ from the kernels' (out of the cells of the step). With
--two, the same for chip_smoke's 2-sequence step at iteration 6000:
the GPU against the float64 step on the CPU, on its own cells and on
the GPU's.

Usage: python3 tools/torch_grad_precision.py [--seeds 0] [--states 4]
           [--heads STP,STP-pm] [--iterations 0,6000,20000] [--two]
Needs a GPU; TF32 stays off, as in the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from pivp_tpu_torch.models import predictor  # noqa: E402
from pivp_tpu_torch.ops import sampling  # noqa: E402
from pivp_tpu_torch.ops.kernels import build  # noqa: E402
from pivp_tpu_torch.parallel import train_step as ts  # noqa: E402
from pivp_tpu_torch.utils import weights  # noqa: E402
from pivp_tpu_torch.utils.device import resolve_device  # noqa: E402


def train_state(cfg, seed: int, batch) -> dict:
    """The params after chip_smoke's warm-up, counted, timed and
    profiled steps (iterations 0-8), with cuDNN's default algorithms."""
    params = predictor.init_params(torch.Generator().manual_seed(seed),
                                   cfg, device="cuda")
    state = ts.create_train_state(params, ts.make_optimizer(1e-3))
    step = ts.make_train_step(cfg)
    for it in range(9):
        step(state, batch, it, sampling.generator(seed + 1, it))
    torch.cuda.synchronize()
    return state.params


def grads(params, cfg, batch, it: int, seed: int, cells=None,
          replay: bool = False, float64: bool = False):
    """One step's gradient, recording the sampler's cells into `cells`
    (or replaying them); returns (grads, cells that replay moved)."""
    cells = [] if cells is None else cells
    with chip_smoke.sampler_cells(cells, replay) as moved:
        if float64:
            g = chip_smoke.grads_float64(ts, predictor, sampling, params,
                                         cfg, batch, it, seed)
        else:
            g, _ = ts.grads_and_metrics(params, cfg, batch, it,
                                        sampling.generator(seed, it))
    return g, moved


def line(keys, name: str, got, want) -> str:
    diffs, whole = chip_smoke.norms_of_difference(keys, got, want)
    worst = max(diffs, key=diffs.get)
    return f"{name} {whole:.3e} ({worst} {diffs[worst]:.3e})"


def compare(keys, params, cfg, batch, it: int, seed: int) -> None:
    plain = dataclasses.replace(cfg, use_kernel=False,
                                use_kernel_gates=False)
    with chip_smoke.deterministic_cudnn():
        cells_k, cells_p = [], []
        g_k, _ = grads(params, cfg, batch, it, seed, cells_k)
        g_p, _ = grads(params, plain, batch, it, seed, cells_p)
        g_pk, moved_p = grads(params, plain, batch, it, seed, cells_k, True)
        g_64, _ = grads(params, cfg, batch, it, seed, [], float64=True)
        g_64k, moved_64 = grads(params, cfg, batch, it, seed, cells_k, True,
                                float64=True)
    n_cells = sum(c.numel() for c in cells_k)
    n_gt = sampling.num_ground_truth(batch[0].shape[1],
                                     cfg.scheduled_sampling_k, it)
    print(f"  iteration {it} (n_gt {n_gt}): cells of the kernels' step "
          f"{n_cells}, the plain step's own differ in "
          f"{chip_smoke.count(moved_p)}, float64's own in "
          f"{chip_smoke.count(moved_64)}; kernels vs "
          + "; ".join([line(keys, "plain", g_k, g_p),
                       line(keys, "plain@k", g_k, g_pk),
                       line(keys, "f64", g_k, g_64),
                       line(keys, "f64@k", g_k, g_64k)])
          + "; plain vs " + "; ".join([line(keys, "f64", g_p, g_64),
                                       line(keys, "f64@k", g_pk, g_64k)]),
          flush=True)


def compare_two(keys, params, cfg, batch, seed: int) -> None:
    """chip_smoke's 2-sequence step at iteration 6000: the GPU against
    the float64 step on the CPU, on its own cells and on the GPU's."""
    it = 6000
    two = tuple(a[:, :2] for a in batch)
    cpu_params = predictor.map_params(
        lambda p: p.detach().cpu().requires_grad_(), params)
    cpu_two = tuple(a.cpu() for a in two)
    cells_d = []
    with chip_smoke.deterministic_cudnn():
        g_d, _ = grads(params, cfg, two, it, seed, cells_d)
    g_c, _ = grads(cpu_params, cfg, cpu_two, it, seed)
    g_64, _ = grads(cpu_params, cfg, cpu_two, it, seed, float64=True)
    g_64d, moved = grads(cpu_params, cfg, cpu_two, it, seed, cells_d, True,
                         float64=True)
    n_cells = sum(c.numel() for c in cells_d)
    print(f"  2 sequences, iteration {it}: cells {n_cells}, float64's "
          f"own differ from the GPU's in "
          f"{chip_smoke.count(moved)}; GPU vs "
          + "; ".join([line(keys, "f64", g_d, g_64),
                       line(keys, "f64@gpu", g_d, g_64d)])
          + "; CPU float32 vs " + line(keys, "f64", g_c, g_64), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0",
                    help="comma-separated seeds of params and data")
    ap.add_argument("--states", type=int, default=4,
                    help="train states made per seed and head")
    ap.add_argument("--heads", default="STP,STP-pm")
    ap.add_argument("--iterations", default="0,6000,20000")
    ap.add_argument("--two", action="store_true",
                    help="also the 2-sequence step against float64")
    args = ap.parse_args()
    resolve_device("cuda")                       # TF32 off
    build.load()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{chip_smoke.card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, cuDNN {torch.backends.cudnn.version()}",
          flush=True)
    iterations = [int(x) for x in args.iterations.split(",")]
    for seed, head in itertools.product(
            [int(x) for x in args.seeds.split(",")], args.heads.split(",")):
        cfg = chip_smoke.head_config(head.replace("-pm", ""))
        if head.endswith("-pm"):
            cfg = dataclasses.replace(cfg, stp_shared_params=False)
        batch = chip_smoke.synthetic_batch(seed + 1)
        for s in range(args.states):
            t0 = time.perf_counter()
            params = train_state(cfg, seed, batch)
            keys = list(weights.flatten(params))
            print(f"{chip_smoke.label(cfg)} b{batch[0].shape[1]}, seed "
                  f"{seed}, state {s}, whole-gradient distance:", flush=True)
            for it in iterations:
                compare(keys, params, cfg, batch, it, seed + 1)
            if args.two:
                compare_two(keys, params, cfg, batch, seed + 1)
            print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
            del params
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
