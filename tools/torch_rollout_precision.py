#!/usr/bin/env python3
"""Where a float32 feed-self rollout of the PyTorch port departs from
float64, on the GPU and on the CPU.

For each head (CDNA, STP with a shared projection, STP with one per
mask) at the size of `chip_smoke.py`'s serve phases (batch 32, 64x64x3,
T=10, 2 context frames; params and synthetic data from each of
--seeds, as there from --seed), the rollout through the plain ops in
float64 on the CPU is the reference. Each float32 rollout is printed
against it:

  cpu          the CPU (the plain path), batch 32
  cpu b2       the CPU, the first 2 sequences alone
  gpu kernels  the GPU through the kernels, cuDNN's default algorithms
               (twice, to show the change between two runs)
  gpu plain    the GPU, both kernel switches off
  gpu det      as gpu plain, with cudnn.deterministic
  gpu no-cudnn as gpu plain, with cuDNN off (PyTorch's own convolutions)

For each: the max abs frame distance of each sequence (median, 90th
percentile and max over the sequences, each also over the CPU's, and in
how many sequences the rollout is further than the CPU's), the mean abs
frame distance, the distance from the CPU's float32 rollout, the step-0
stage activations enc0..enc7 (max abs distance over max abs value), and
for STP the affine parameters theta at step 0 and over all steps (max
abs distance).

Usage: python3 tools/torch_rollout_precision.py [--seeds 0,1]
                                                [--heads CDNA,STP,STP-pm]
Needs a GPU; TF32 stays off, as in the port.
"""

from __future__ import annotations

import argparse
import contextlib
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
from pivp_tpu_torch.ops import transforms  # noqa: E402
from pivp_tpu_torch.utils.device import resolve_device  # noqa: E402

_thetas: list = []
_stp_apply = transforms.stp_apply


def _recording_stp_apply(prev_image, theta, *args, **kwargs):
    _thetas.append(theta.detach())
    return _stp_apply(prev_image, theta, *args, **kwargs)


transforms.stp_apply = _recording_stp_apply


@contextlib.contextmanager
def cudnn_mode(deterministic: bool = False, enabled: bool = True):
    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled)
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.enabled = enabled
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.enabled) = prev


def rollout(params, cfg, images, actions, states) -> dict:
    """gen_images (T-1, B, H, W, C), the step-0 stage activations and
    theta (T-1, B, ...) for STP, all on the CPU in float64."""
    _thetas.clear()
    with torch.inference_mode():
        out = predictor.rollout(params, cfg, images, actions, states,
                                capture=True, keys=("gen_images",))
    to64 = lambda x: x.detach().double().cpu()  # noqa: E731
    return {"gen": to64(out["gen_images"]),
            "encs": [to64(e[0]) for e in out["conv_res_all"]],
            "theta": (torch.stack([to64(t) for t in _thetas])
                      if _thetas else None)}


def report(name: str, got: dict, ref: dict, cpu=None) -> dict:
    n = got["gen"].shape[1]
    diff = (got["gen"] - ref["gen"][:, :n]).abs()
    per_seq = diff.amax(dim=(0, 2, 3, 4))
    stats = {"median": float(per_seq.median()),
             "p90": float(per_seq.quantile(0.9)),
             "max": float(per_seq.max()), "mean": float(diff.mean()),
             "per_seq": per_seq, "gen": got["gen"]}
    line = (f"  {name:12s} frames, max abs a sequence: median "
            f"{stats['median']:.3e}, p90 {stats['p90']:.3e}, max "
            f"{stats['max']:.3e} (sequence {int(per_seq.argmax())}), first "
            f"2 {float(per_seq[:2].max()):.3e}; mean abs {stats['mean']:.3e}")
    if cpu is not None and n == cpu["per_seq"].shape[0]:
        line += "; over the CPU's: " + ", ".join(
            f"{k} x{stats[k] / cpu[k]:.2f}"
            for k in ("median", "p90", "max", "mean"))
        line += (f", further in {int((per_seq > cpu['per_seq']).sum())} of "
                 f"{n}; vs the CPU's float32 "
                 f"{float((got['gen'] - cpu['gen']).abs().max()):.3e}")
    rel = [float((a - b[:n]).abs().max() / b[:n].abs().max().clamp_min(1e-30))
           for a, b in zip(got["encs"], ref["encs"])]
    line += "; step-0 enc0..enc7 " + " ".join(f"{r:.1e}" for r in rel)
    if got["theta"] is not None:
        d = (got["theta"] - ref["theta"][:, :n]).abs()
        line += (f"; theta step 0 {float(d[0].max()):.3e}, step 1 "
                 f"{float(d[1].max()):.3e}, all {float(d.max()):.3e}")
    print(line, flush=True)
    return stats


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0",
                    help="comma-separated seeds of params and data")
    ap.add_argument("--heads", default="CDNA,STP,STP-pm")
    args = ap.parse_args()
    resolve_device("cuda")                       # TF32 off
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{chip_smoke.card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, cuDNN {torch.backends.cudnn.version()}, "
          f"{torch.get_num_threads()} CPU threads", flush=True)
    for seed, head in itertools.product(
            [int(x) for x in args.seeds.split(",")], args.heads.split(",")):
        t0 = time.perf_counter()
        images, actions, states = chip_smoke.synthetic_batch(seed)
        cpu_batch = tuple(a.cpu() for a in (images, actions, states))
        cfg = chip_smoke.head_config(head.replace("-pm", ""))
        if head.endswith("-pm"):
            cfg = dataclasses.replace(cfg, stp_shared_params=False)
        params = predictor.init_params(
            torch.Generator().manual_seed(seed), cfg, device="cuda")
        cpu_params = predictor.map_params(lambda p: p.cpu(), params)
        plain = dataclasses.replace(cfg, use_kernel=False,
                                    use_kernel_gates=False)
        cfg64 = dataclasses.replace(plain, compute_dtype="float64",
                                    lstm_gate_compute="compute")
        ref = rollout(predictor.map_params(lambda p: p.double(), cpu_params),
                      cfg64, *(a.double() for a in cpu_batch))
        print(f"{chip_smoke.label(cfg)} b{images.shape[1]}, seed {seed}, "
              f"distance from the CPU's float64 rollout:", flush=True)
        cpu = report("cpu", rollout(cpu_params, cfg, *cpu_batch), ref)
        report("cpu b2", rollout(cpu_params, cfg,
                                 *(a[:, :2] for a in cpu_batch)), ref)
        report("gpu kernels", rollout(params, cfg, images, actions, states),
               ref, cpu)
        report("gpu kernels", rollout(params, cfg, images, actions, states),
               ref, cpu)
        report("gpu plain", rollout(params, plain, images, actions, states),
               ref, cpu)
        with cudnn_mode(deterministic=True):
            report("gpu det", rollout(params, plain, images, actions,
                                      states), ref, cpu)
        with cudnn_mode(enabled=False):
            report("gpu no-cudnn", rollout(params, plain, images, actions,
                                           states), ref, cpu)
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
