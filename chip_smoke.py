#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pivp_tpu_torch) on one NVIDIA GPU.

Drives the port's prediction and training paths at full width (channel
plans (32,32,64,64,128,96,64) / (32,32,64,64,128,64,32), 64x64x3 frames,
T=10, 2 context frames, use_state, float32 with TF32 off, batch 32;
training with scheduled sampling k=900 and Chainer Adam at lr 1e-3)
with random weights and synthetic data made from --seed: the CDNA head
(10 masks), then the DNA head (1 mask) and the STP head (10 masks, one
shared affine projection, then one per mask), in phases:

  1. device   a CUDA device is required; prints its name and power limit
  2. build    compiles every CUDA kernel from pivp_tpu_torch/csrc
  3. kernels  each kernel, forward and backward, against its plain
              PyTorch version on the card, at the main paths' shapes,
              with times (warm and cold, below) and bounds, and a device
              copy of the local-apply kernels' bytes as a yardstick
  4. serve    CDNA: seeded params -> save_npz -> load_model (the run
              directory names the head) -> make_serve_fn, --requests
              requests of batch 32; the launch counters must show every
              forward kernel launched on that path; the rollout with
              both kernel switches off, and a small batch on the CPU,
              must agree with it
  5. predict  predict_and_render on a synthetic processed-data dir
              renders the contact-sheet GIF
  6. train    CDNA: train_cli (in process) runs --train_steps iterations
              at batch 32 on synthetic sequences, across an epoch
              boundary with one validation sweep and one checkpoint; the
              launch counters must show every kernel launched on that
              path, and one train step must launch each local-apply
              kernel 9 times and each gate kernel 63 times; one step's
              gradients through the backward kernels must agree with the
              same step through their plain versions, tensor by tensor
              (within float32's own run-to-run change where that is
              larger), and with the plain ops' (at iterations 0 and
              6000) over the whole gradient, and the card's gradient of
              a 2-sequence step with the float64 gradient of that step
              (see GRAD_TOL); the median time and peak device memory of
              a train step and one profiled step
  7. DNA      phases 4 and 6 for the DNA head (HEAD_REQUESTS requests,
              the gradient checks at iteration 6000): its steps launch
              the local-apply kernels as CDNA's do, 9/9/9/63/63 a step
  8. STP      the same for the STP head: no local-apply launch, 63 of
              each gate kernel a step; the plain and float64 steps that
              the kernels' step is held to sample at its sampler cells
  9. per-mask the same for STP with a projection per mask, reached
              through the API: no npz round trip and no train_cli, whose
              flags do not select it
 10. deploy   CDNA: seeded params -> export_reference_npz (the Chainer
              layout) -> convert_cli import, equal to the params bit for
              bit -> export_cli (a torch.export artifact) -> the example
              HTTP server (examples/serve_http_torch.py), which loads it:
              its graph's kernel nodes (9 / 63), its frames against
              make_serve_fn's, bit for bit with cudnn.deterministic (the
              count under cuDNN's default algorithms, which differ from
              run to run in the transposed convolutions, is printed),
              the launches of --requests requests by counter and of one
              by the profiler, the medians of the artifact and
              make_serve_fn in turns, and one b32 POST (its round trip,
              its frames, and a 400 for a malformed body and for a wrong
              batch); then DNA (9 / 63) and STP shared (0 / 63), exported
              and loaded through the API, with the same checks but the
              profile and HTTP. Artifact sizes and export and load
              seconds are printed; the artifacts are deleted.
 11. driver   the rest of the training driver. (a) For CDNA at b32 and
              DNA and STP (shared) at b8: from one seeded state, 4
              replays of the captured train step (make_train_multi, a
              CUDA graph) equal 4 eager steps bit for bit under
              cudnn.deterministic and torch.use_deterministic_algorithms
              (warn only; the ops without a deterministic implementation
              are printed): params, Adam mu/nu/count, per-step loss and
              PSNR; a replay launches 9/63/9/9/63 kernels (STP
              0/63/0/0/63); then, at b32 for each head, the graphed and
              eager step medians, the capture seconds, the graph pool's
              bytes, and one profiled dispatch (its launches 4x a
              replay's) and eager step. (b) train_cli --steps_per_call 4
              --prefetch 2 --checkpointer torch on 200 synthetic
              sequences on disk (24 iterations, epochs of 5): the run in
              process (launches counted), a train_cli process that gets
              a SIGTERM after its first epoch, checkpoints, exits 0 and
              is started again with the same --run_name (final npz and
              curves bit for bit equal to the run in process), and
              --lazy_load 1 (equal too). (c) --profile_dir on a
              3-iteration run: the trace holds the five kernels. (d)
              visualize_cli on (b)'s run directory: loss curves and the
              enc0..enc7 grids and projections; the captured activations
              through the kernels within FRAME_TOL of the plain ops'.
 12. data     the data path. (a) 24 raw TFRecord shards of 4 records
              (T=10 JPEG frames of 640x512, moving squares drawn with
              PIL from --seed, 5-float actions and states under the push
              dataset's keys), written by the port's writer. (b) python
              -m pivp_tpu_torch.data.make_dataset_cli --sequences_per_file
              0: 96 map.csv rows, the npy shapes, 24 native scanner calls;
              then the default --sequences_per_file 1 on four shards: 4
              rows. (c) build_features writes features.json. (d)
              train_cli on the converted directory, CDNA b32,
              --steps_per_call 4 --prefetch 2, 8 iterations, as a world-1
              NCCL process group (--coordinator_address 127.0.0.1:<port>
              --num_processes 1 --process_id 0): 9/9/9/63/63 launches a
              step, 2 native assembler calls, and final npz and curves
              equal to the same run without the group, bit for bit under
              phase 11's deterministic settings. (e) Two gloo ranks on
              the card (spawned), b16 each, one step of the b32 global
              batch with the same sampling inputs: their all-reduced
              gradient within GRAD_TOL of the one-rank b32 step's over
              the whole gradient. (f) utils/flops' count of the CDNA b32
              train step beside rollout_flops's, and the float32 peak
              share of phase 11's graphed step.

Each phase prints its seconds. Any failure exits non-zero. The last
lines are a `kernels` JSON line (the forward kernels' launches are the
CDNA serve phase's, the backward kernels' the CDNA train phase's; the
other heads' counts are on their own log lines), the card's name and
power limit, and `{"ok": true, "device": ...}`.

Each kernel is timed twice at the main path's shapes: warm (`ms`: 200
calls on the same inputs, which stay in the 50 MB L2) and cold
(`cold_ms`: the calls go round input sets larger than twice the L2, each
writing its own output). The cold time is the one to hold against the
bound, which counts every byte from and to device memory.

Phase 3 also runs the library call that computes each gate kernel's
function, aten's fused LSTM cell (`_thnn_fused_lstm_cell` and its
backward) on the gates permuted to its (i, f, g, o) order, checks it
against the kernel and times it warm and cold (`library_ms`,
`library_cold_ms`).

Usage: python3 chip_smoke.py [--seed 0] [--requests 3] [--train_steps 3]
                             [--out DIR] [--kernels_only] [--driver_only]
                             [--data_only] [--bwd_x_rows 2,4,8]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import warnings

# cuBLAS is reproducible under torch.use_deterministic_algorithms only
# with a fixed workspace, which has to be set before its first use
# (phase 11 runs under those settings).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# Phase 12's process groups are on this host: NCCL's bootstrap on the
# loopback interface.
os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the
# float32 rate outside the tensor cores, which these kernels use.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# The heads driven, as ModelConfig fields over the defaults, and the
# timed requests of the DNA and STP serve phases.
HEADS = {"CDNA": {}, "DNA": dict(model_type="DNA", num_masks=1),
         "STP": dict(model_type="STP")}
HEAD_REQUESTS = 2
# Main-path shapes at batch 32: the fused CDNA tap application, and the
# ConvLSTM cells of one timestep as (count, H, W, C).
BATCH = 32
LOCAL_APPLY_SHAPE = (BATCH, 64, 64, 3)
GATE_CELLS = ((3, 32, 32, 32), (3, 16, 16, 64), (1, 8, 8, 128))
GATE_LAUNCHES_PER_STEP = sum(n for n, _, _, _ in GATE_CELLS)
# Timesteps of one rollout (T - 1) and predicted frames of one sequence.
STEPS, PREDICTED = 9, 8
# Gradient agreement, per-tensor relative Frobenius difference. It
# gates the backward kernels: one step through the kernels against the
# same step with the same forward kernels and the plain backward
# versions, so both share every activation and every ReLU decision, with
# cudnn.deterministic on. A tensor whose float32 gradient is a sum of
# large cancelling terms (lstm1/w) moves by about this much under any
# rounding change: the plain ops run twice with cuDNN's default
# (run-order dependent) algorithms show it, and each tensor's limit is
# the larger of GRAD_TOL and twice that measured change. Two steps
# through different forward arithmetic (kernels vs plain ops, the card
# vs the float64 step) are held to GRAD_TOL over the whole gradient, and
# each tensor is reported: a unit whose pre-activation lies within
# float32 rounding of zero takes the other side of its ReLU on one of
# them, which moves the small gradients of the first stages by about
# GRAD_TOL, on either side (the float64 distances are printed for such
# tensors). The STP sampler's derivative in theta is one-sided at
# integer source coordinates: a cell (the floor of a coordinate) that
# two forwards round to different sides switches that pixel's gradient
# to its neighbour's difference. In a per-mask STP step the plain ops
# take ~650 of the kernels' 21.2 M cells on the other side, which moved
# the whole gradient by up to 6.8e-5 (more than 1e-4 in one run), and
# 2.2e-6 to 1.1e-5 once the plain step took the kernels' cells
# (tools/torch_grad_precision.py on the H100); so the plain and float64
# steps of the kernels-vs-plain check sample at the kernels' cells. The
# card is held to the float64 step, not to the CPU's float32 one, whose
# own flips would fail a correct card; within GRAD_TOL, or twice the
# CPU float32's distance from the float64 step where that is larger,
# since a flip that both float32 devices take moves both (1.12e-4 on
# each, in one of four STP states measured).
GRAD_TOL = 1e-4
# Frame agreement, max abs over [0, 1] frames, against the float64
# rollout of the plain ops on the CPU. The STP warp reads the frame at
# (W-1)/2 = 31.5 pixels per unit of theta, so across a sharp edge a
# rounding change in theta moves a pixel about 30x as much, and the
# fed-back frames carry it on: a float32 STP rollout lies 1e-4 to 5e-3
# from float64 at b32, CDNA's and DNA's ~2e-6, on the card and on the
# CPU alike (tools/torch_rollout_precision.py on the H100). Kernels vs
# plain ops on the card: FRAME_TOL, or twice the plain ops' own distance
# from float64 where that is larger (if the kernels are no further from
# float64 than the plain ops, the triangle inequality keeps the two
# within it). The card vs the CPU: each float32 rollout of the 32
# sequences against the float64 one; the card's 90th percentile over
# the sequences of each sequence's distance within FRAME_TOL, or twice
# the CPU float32's 90th percentile where that is larger. Not the
# maximum: in a few sequences STP's feedback makes every float32
# rollout diverge (1.3e-3 to 5.3e-3 from float64 in one sequence of
# seed 1), and there the card's kernels and the CPU differ by up to 4x
# by chance; over all 32, the card's 90th percentile lay within 1.31x
# the CPU's in every rollout measured.
FRAME_TOL = 1e-4
# The CUDA function that each counted kernel wrapper launches, in the
# order of `_counted()` and of the `kernels` line.
CUDA_NAMES = ("local_apply_fwd_kernel", "lstm_gates_fwd_kernel",
              "local_apply_bwd_w_kernel", "local_apply_bwd_x_kernel",
              "lstm_gates_bwd_kernel")
# Phase 11: K steps a dispatch; the graphed-vs-eager checks start at an
# iteration where 17 of 32 rows take ground truth (num_ground_truth), so
# the steps read the sampling stream. Phase 11's train_cli runs train on
# DRIVER_SEQUENCES synthetic sequences on disk, 160 for training (5
# batches an epoch at b32) and 40 for validation (every 2 epochs), for
# DRIVER_ITERS iterations: the dispatch boundaries 4, 8, 12, 16 and 24
# fall inside an epoch.
DRIVER_K = 4
DRIVER_ITER0 = 6000
DRIVER_SEQUENCES, DRIVER_SPLIT, DRIVER_ITERS = 200, "0.8", 24
DRIVER_EPOCH = 5
# Each head's graphed-vs-eager check runs at this batch (the step times
# are taken at BATCH for all three).
DRIVER_CHECK_BATCH = {"CDNA": BATCH, "DNA": 8, "STP": 8}
# A train_cli process with phase 11's determinism settings (see
# `deterministic`), its arguments after -c.
DRIVER_CHILD = (
    "import sys, torch; torch.backends.cudnn.deterministic = True; "
    "torch.use_deterministic_algorithms(True, warn_only=True); "
    "from pivp_tpu_torch.training import train_cli; "
    "train_cli.main(sys.argv[1:])")


# Phase 12: DATA_SHARDS raw shards of DATA_PER_SHARD records, each of
# T=10 frames at the push dataset's 640x512 (JPEG) with 5-float actions
# and states under its keys; DATA_ITERS iterations of CDNA b32 on the
# converted directory, K = DRIVER_K.
DATA_SHARDS, DATA_PER_SHARD = 24, 4
DATA_FRAME = (512, 640)                       # (height, width)
DATA_ITERS = 8
# Numbers measured by one phase that a later one prints beside its own.
MEASURED = {}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _events_ms(run, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(fn, iters: int = 200, warmup: int = 20,
            graph: bool = False) -> float:
    """Mean time of one call of `fn`, from CUDA events around `iters`
    back-to-back calls after `warmup` calls. Called from Python, a short
    kernel is paced by the host's launch overhead; with `graph=True` the
    `iters` calls are captured in one CUDA graph and replayed, which
    leaves the device time alone. Every call reads the same inputs, so
    whatever fits in the L2 stays there (warm)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not graph:
        def run():
            for _ in range(iters):
                fn()
        return _events_ms(run, iters)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return _events_ms(g.replay, iters)


def cold_ms(fn, make_inputs, input_bytes: int, iters: int = 200) -> float:
    """Mean device time of one call of `fn(*inputs)` with a cold L2: the
    `iters` calls, captured in one CUDA graph, go round N input sets
    from `make_inputs()` whose inputs together exceed twice the L2, and
    every call writes an output of its own (all are held until the
    timing ends). So a set's lines are evicted before it comes back, and
    each call reads its inputs from device memory and writes its outputs
    back to it, as the bound assumes."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    n = min(iters, 2 * l2 // input_bytes + 1)
    sets = [make_inputs() for _ in range(n)]
    for s in sets[:3]:                                   # warm-up
        fn(*s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(g):
        for i in range(iters):
            outs.append(fn(*sets[i % n]))
    g.replay()
    torch.cuda.synchronize()
    ms = _events_ms(g.replay, iters)
    del g, outs, sets
    torch.cuda.empty_cache()
    return ms


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def close(a: torch.Tensor, b: torch.Tensor, tol: float) -> bool:
    """|a - b| <= tol + tol * |b| everywhere (the JAX package's kernel
    tests use the same rtol = atol form)."""
    return torch.allclose(a.float(), b.float(), rtol=tol, atol=tol)


def la_inputs(shape, k: int, dtype, gen: torch.Generator) -> tuple:
    """x in [0, 1), a cotangent g and normalised per-pixel kernels w."""
    x = torch.rand(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w = torch.rand(shape[:3] + (k * k,), generator=gen, device="cuda")
    return x, g, (w / w.sum(-1, keepdim=True)).to(dtype)


def time_line(what: str, ms: float, cold: float, plain_ms: float,
              bms: float, by: str, call_ms: float) -> str:
    return (f"{what}, device time per call (CUDA graph): kernel "
            f"{ms * 1e3:.2f} us warm, {cold * 1e3:.2f} us cold "
            f"({100 * bms / cold:.1f}% of bound), plain "
            f"{plain_ms * 1e3:.2f} us, bound {bms * 1e3:.2f} us ({by}); "
            f"kernel called from Python {call_ms * 1e3:.2f} us per call")


def check_local_apply(gen: torch.Generator) -> dict:
    from pivp_tpu_torch.ops.kernels import local_apply as la

    cases = [  # (shape, K, dtype, tolerance)
        (LOCAL_APPLY_SHAPE, 5, torch.float32, 1e-5),
        (LOCAL_APPLY_SHAPE, 5, torch.bfloat16, 2e-2),
        ((4, 256, 256, 3), 5, torch.float32, 1e-5),
        (LOCAL_APPLY_SHAPE, 3, torch.float32, 1e-5),
    ]
    main_err = None
    for shape, k, dtype, tol in cases:
        x = torch.rand(shape, generator=gen, device="cuda").to(dtype)
        w = torch.rand(shape[:3] + (k * k,), generator=gen, device="cuda")
        w = (w / w.sum(-1, keepdim=True)).to(dtype)
        got = la.local_kernel_apply(x, w)
        want = la.local_kernel_apply_plain(x, w)
        torch.cuda.synchronize()
        err = max_err(got, want)
        log(f"local_apply {shape} K={k} {dtype}: max|kernel-plain| "
            f"{err:.3e} (tol {tol:g})")
        if not close(got, want, tol):
            fail(f"local_apply {shape} K={k} {dtype}: {err} > {tol}")
        if main_err is None:
            main_err = err
            ms = cuda_ms(lambda: la.local_kernel_apply(x, w), graph=True)
            b, h, wd, c = shape
            cold = cold_ms(la.local_kernel_apply,
                           lambda: la_inputs(shape, k, dtype, gen)[::2],
                           (b * h * wd * c + b * h * wd * k * k) * 4)
            plain_ms = cuda_ms(lambda: la.local_kernel_apply_plain(x, w),
                               graph=True)
            call_ms = cuda_ms(lambda: la.local_kernel_apply(x, w))
            nbytes = (2 * b * h * wd * c + b * h * wd * k * k) * 4
            bms, by = bound_ms(nbytes, 2 * k * k * c * b * h * wd)
    log(time_line(f"local_apply {LOCAL_APPLY_SHAPE}x25 f32", ms, cold,
                  plain_ms, bms, by, call_ms))
    # A yardstick for the three local-apply kernels, which each move
    # `nbytes`: a device copy that reads half of them and writes the
    # other half, timed the same two ways.
    half = torch.empty(nbytes // 8, device="cuda")
    copy_ms = cuda_ms(half.clone, graph=True)
    copy_cold = cold_ms(torch.clone, lambda: (torch.rand_like(half),),
                        nbytes // 2)
    log(f"device copy moving the same {nbytes / 1e6:.1f} MB: "
        f"{copy_ms * 1e3:.2f} us warm, {copy_cold * 1e3:.2f} us cold")
    return {"name": "local_kernel_apply", "route": "cuda",
            "source": "pivp_tpu_torch/csrc/local_apply.cu",
            "replaces": "pivp_tpu/ops/pallas/local_apply.py:106",
            "max_abs_err": main_err, "ms": ms, "cold_ms": cold,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "library_cold_ms": None}


def gate_inputs(shape, dtype, gen: torch.Generator, n: int) -> tuple:
    """Gate pre-activations (B, H, W, 4C), then n (B, H, W, C) tensors
    (the carry c, then the cotangents of new_c and new_h)."""
    gates = torch.randn(shape[:3] + (4 * shape[3],), generator=gen,
                        device="cuda") * 1.5
    return (gates.to(dtype),) + tuple(
        torch.randn(shape, generator=gen, device="cuda").to(dtype)
        for _ in range(n))


def ifgo_rows(gates: torch.Tensor) -> torch.Tensor:
    """Gate pre-activations (..., 4C) in the port's (j, i, f, o) blocks
    as the rows x 4C (i, f, g, o) blocks of aten's fused LSTM cell (g is
    j, the candidate): what permuting the gate conv's output channels
    once at load would make the conv write."""
    j, i, f, o = gates.chunk(4, dim=-1)
    return torch.cat([i, f, j, o], dim=-1).reshape(-1, gates.shape[-1])


def jifo(grad_rows: torch.Tensor, shape) -> torch.Tensor:
    """aten's (i, f, g, o) gate gradients back in the (j, i, f, o)
    blocks of `shape`."""
    i, f, g, o = grad_rows.chunk(4, dim=-1)
    return torch.cat([g, i, f, o], dim=-1).reshape(shape)


def lstm_cell_biases(c: int, forget_bias: float) -> tuple:
    """aten's (input_bias, hidden_bias) for the port's forget bias: fb on
    the f block of the first, zeros (its CUDA kernel takes both biases
    or neither)."""
    bias = torch.zeros(4 * c, device="cuda")
    bias[c:2 * c] = forget_bias
    return bias, torch.zeros_like(bias)


def aten_cell(gates: torch.Tensor, c: torch.Tensor) -> tuple:
    """(input_gates, hidden_gates (zeros), cx, input_bias, hidden_bias)
    of aten's fused LSTM cell for the port's gates (B, H, W, 4C) and
    carry c (forget bias 1)."""
    ig = ifgo_rows(gates).contiguous()
    return ((ig, torch.zeros_like(ig), c.reshape(ig.shape[0], -1))
            + lstm_cell_biases(c.shape[-1], 1.0))


def aten_cell_inputs(shape, gen: torch.Generator) -> tuple:
    """aten_cell's inputs for one port cell of `shape` (B, H, W, C)."""
    return aten_cell(*gate_inputs(shape, torch.float32, gen, 1))


def aten_cell_bwd_inputs(shape, gen: torch.Generator) -> tuple:
    """(grad_hy, grad_cy, cx, cy, workspace) of aten's fused LSTM cell
    backward, the forward run on the inputs of `aten_cell_inputs`."""
    inputs = aten_cell_inputs(shape, gen)
    cx = inputs[2]
    _, cy, ws = torch.ops.aten._thnn_fused_lstm_cell(*inputs)
    g_c, g_h = (torch.randn(cx.shape, generator=gen, device="cuda")
                for _ in range(2))
    return g_h, g_c, cx, cy, ws


def aten_cell_bwd(g_h, g_c, cx, cy, ws):
    return torch.ops.aten._thnn_fused_lstm_cell_backward_impl(
        g_h, g_c, cx, cy, ws, False)


def check_lstm_gates(gen: torch.Generator) -> dict:
    from pivp_tpu_torch.ops.kernels import lstm_gates as lg

    worst = 0.0
    step_ms = step_cold = step_plain_ms = step_call_ms = 0.0
    step_bytes = step_ops = 0.0
    lib_ms = lib_cold = 0.0
    for n_cells, h, w, c in GATE_CELLS:
        for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
            gates, cc = gate_inputs((BATCH, h, w, c), dtype, gen, 1)
            for fb in (1.0, 0.0):
                got = lg.fused_lstm_gates(gates, cc, fb)
                want = lg.fused_lstm_gates_plain(gates, cc, fb)
                torch.cuda.synchronize()
                err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
                log(f"lstm_gates ({BATCH},{h},{w},{c}) {dtype} fb={fb}: "
                    f"max|kernel-plain| {err:.3e} (tol {tol:g})")
                if not (close(got[0], want[0], tol)
                        and close(got[1], want[1], tol)):
                    fail(f"lstm_gates {(h, w, c)} {dtype} fb={fb}: "
                         f"{err} > {tol}")
                if dtype == torch.float32:
                    worst = max(worst, err)
            if dtype == torch.float32:
                elems = BATCH * h * w * c
                step_ms += n_cells * cuda_ms(
                    lambda: lg.fused_lstm_gates(gates, cc, 1.0), graph=True)
                step_cold += n_cells * cold_ms(
                    lambda gs, cs: lg.fused_lstm_gates(gs, cs, 1.0),
                    lambda: gate_inputs((BATCH, h, w, c), dtype, gen, 1),
                    5 * elems * 4)
                step_plain_ms += n_cells * cuda_ms(
                    lambda: lg.fused_lstm_gates_plain(gates, cc, 1.0),
                    graph=True)
                step_call_ms += n_cells * cuda_ms(
                    lambda: lg.fused_lstm_gates(gates, cc, 1.0))
                step_bytes += n_cells * 7 * elems * 4
                # Per element: 3 sigmoids (negate, exp, add, divide), 2
                # tanh, the forget-bias add and 4 multiply/adds.
                step_ops += n_cells * 19 * elems
                # The library's fused LSTM cell on the permuted gates
                # (hidden gates zero, the forget bias as its input bias):
                # the same new_c and new_h first, then its times.
                lib = aten_cell(gates, cc)
                hy, cy, _ = torch.ops.aten._thnn_fused_lstm_cell(*lib)
                new_c, new_h = lg.fused_lstm_gates(gates, cc, 1.0)
                torch.cuda.synchronize()
                err = max(max_err(cy, new_c.reshape(cy.shape)),
                          max_err(hy, new_h.reshape(hy.shape)))
                log(f"lstm_gates ({BATCH},{h},{w},{c}): aten "
                    f"_thnn_fused_lstm_cell vs the kernel on the permuted "
                    f"gates: max abs {err:.3e} (tol 1e-6)")
                if not (close(cy, new_c.reshape(cy.shape), 1e-6)
                        and close(hy, new_h.reshape(hy.shape), 1e-6)):
                    fail(f"aten fused LSTM cell differs from lstm_gates at "
                         f"{(h, w, c)}: {err}")
                lib_ms += n_cells * cuda_ms(
                    lambda: torch.ops.aten._thnn_fused_lstm_cell(*lib),
                    graph=True)
                lib_cold += n_cells * cold_ms(
                    lambda *a: torch.ops.aten._thnn_fused_lstm_cell(*a),
                    lambda: aten_cell_inputs((BATCH, h, w, c), gen),
                    9 * elems * 4)
    bms, by = bound_ms(step_bytes, step_ops)
    log(time_line(f"lstm_gates, the {GATE_LAUNCHES_PER_STEP} cells of one "
                  f"timestep at b{BATCH} f32 (sums)", step_ms, step_cold,
                  step_plain_ms, bms, by, step_call_ms))
    log(f"lstm_gates: library call aten::_thnn_fused_lstm_cell, the "
        f"{GATE_LAUNCHES_PER_STEP} cells (sums): {lib_ms * 1e3:.2f} us warm, "
        f"{lib_cold * 1e3:.2f} us cold; kernel {step_ms * 1e3:.2f} / "
        f"{step_cold * 1e3:.2f} us ({step_cold / lib_cold:.2f}x the "
        f"library's cold time)")
    return {"name": "fused_lstm_gates", "route": "cuda",
            "source": "pivp_tpu_torch/csrc/lstm_gates.cu",
            "replaces": "pivp_tpu/ops/pallas/lstm_gates.py:107",
            "max_abs_err": worst, "ms": step_ms, "cold_ms": step_cold,
            "plain_ms": step_plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_cold_ms": lib_cold}


def check_local_apply_bwd(gen: torch.Generator) -> list:
    from pivp_tpu_torch.ops.kernels import local_apply as la

    cases = [  # (shape, K, dtype, tolerance)
        (LOCAL_APPLY_SHAPE, 5, torch.float32, 1e-5),
        (LOCAL_APPLY_SHAPE, 5, torch.bfloat16, 2e-2),
        ((4, 256, 256, 3), 5, torch.float32, 1e-5),
        (LOCAL_APPLY_SHAPE, 3, torch.float32, 1e-5),
        # Unaligned bfloat16 spans, and column strips of a wide frame.
        ((2, 37, 13, 3), 5, torch.bfloat16, 2e-2),
        ((1, 4, 2048, 3), 5, torch.float32, 1e-5),
    ]
    rows = {}
    for shape, k, dtype, tol in cases:
        x, g, w = la_inputs(shape, k, dtype, gen)
        got_dw = la.local_kernel_apply_bwd_w(x, g, k)
        got_dx = la.local_kernel_apply_bwd_x(w, g)
        want_dx, want_dw = la.local_kernel_apply_bwd_plain(x, w, g)
        torch.cuda.synchronize()
        for name, got, want in (("dW", got_dw, want_dw),
                                ("dX", got_dx, want_dx)):
            err = max_err(got, want)
            log(f"local_apply {name} {shape} K={k} {dtype}: "
                f"max|kernel-plain| {err:.3e} (tol {tol:g})")
            if not close(got, want, tol):
                fail(f"local_apply {name} {shape} K={k} {dtype}: "
                     f"{err} > {tol}")
            if name not in rows:
                b, h, wd, c = shape
                nbytes = (2 * b * h * wd * c + b * h * wd * k * k) * 4
                if name == "dW":
                    kern = lambda: la.local_kernel_apply_bwd_w(x, g, k)  # noqa: E731
                    plain = lambda: la.local_kernel_apply_bwd_w_plain(x, g, k)  # noqa: E731
                    cold = cold_ms(
                        lambda xs, gs: la.local_kernel_apply_bwd_w(xs, gs, k),
                        lambda: la_inputs(shape, k, dtype, gen)[:2],
                        2 * b * h * wd * c * 4)
                else:
                    kern = lambda: la.local_kernel_apply_bwd_x(w, g)  # noqa: E731
                    plain = lambda: la.local_kernel_apply_bwd_x_plain(w, g)  # noqa: E731
                    cold = cold_ms(
                        la.local_kernel_apply_bwd_x,
                        lambda: la_inputs(shape, k, dtype, gen)[:0:-1],
                        (b * h * wd * c + b * h * wd * k * k) * 4)
                ms = cuda_ms(kern, graph=True)
                plain_ms = cuda_ms(plain, graph=True)
                call_ms = cuda_ms(kern)
                bms, by = bound_ms(nbytes, 2 * k * k * c * b * h * wd)
                log(time_line(f"local_apply {name} {shape}x{k * k} f32", ms,
                              cold, plain_ms, bms, by, call_ms))
                rows[name] = dict(err=err, ms=ms, cold_ms=cold,
                                  plain_ms=plain_ms, bms=bms, by=by)
    return [
        {"name": f"local_kernel_apply_bwd_{name[1].lower()}", "route": "cuda",
         "source": "pivp_tpu_torch/csrc/local_apply.cu",
         "replaces": f"pivp_tpu/ops/pallas/local_apply.py:{line}",
         "max_abs_err": rows[name]["err"], "ms": rows[name]["ms"],
         "cold_ms": rows[name]["cold_ms"],
         "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bms"],
         "bound_by": rows[name]["by"], "library_ms": None,
         "library_cold_ms": None}
        for name, line in (("dW", 247), ("dX", 293))]


def sweep_bwd_x(gen: torch.Generator, heights) -> None:
    """dX at the main shape in float32 with tiles of each of `heights`
    rows (the rest of the plan as tile_plan_bwd_x makes it): agreement
    with the plain version, and warm and cold times, to choose the plan."""
    from pivp_tpu_torch.ops.kernels import local_apply as la

    shape, k = LOCAL_APPLY_SHAPE, 5
    b, h, wd, c = shape
    _, g, w = la_inputs(shape, k, torch.float32, gen)
    want = la.local_kernel_apply_bwd_x_plain(w, g)
    for rows in heights:
        plan = la.tile_plan_bwd_x(shape, k, torch.float32, rows=rows)

        def run(ws, gs, plan=plan):
            dx = torch.empty_like(gs)
            la._launch("pivp_local_apply_bwd_x", ws, gs, dx, shape, k, plan)
            return dx

        err = max_err(run(w, g), want)
        if not close(run(w, g), want, 1e-5):
            fail(f"dX with tiles of {rows} rows: {err} > 1e-5")
        ms = cuda_ms(lambda: run(w, g), graph=True)
        cold = cold_ms(run, lambda: la_inputs(shape, k, torch.float32,
                                              gen)[:0:-1],
                       (b * h * wd * c + b * h * wd * k * k) * 4)
        log(f"dX plan: tiles of {plan.rows} rows x {plan.cols} columns, "
            f"{int(np.prod(plan.grid))} blocks, {plan.smem} bytes of shared "
            f"memory: max|kernel-plain| {err:.3e}; {ms * 1e3:.2f} us warm, "
            f"{cold * 1e3:.2f} us cold")


def check_lstm_gates_bwd(gen: torch.Generator) -> dict:
    from pivp_tpu_torch.ops.kernels import lstm_gates as lg

    worst = 0.0
    step_ms = step_cold = step_plain_ms = step_call_ms = 0.0
    step_bytes = step_ops = 0.0
    lib_ms = lib_cold = 0.0
    for n_cells, h, w, c in GATE_CELLS:
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            shape = (BATCH, h, w, c)
            gates, cc, g_c, g_h = gate_inputs(shape, dtype, gen, 3)
            # Autograd passes None for the unused new_c of the last step.
            for gc in (g_c, None):
                got = lg.fused_lstm_gates_bwd(gates, cc, gc, g_h, 1.0)
                want = lg.fused_lstm_gates_bwd_plain(gates, cc, gc, g_h, 1.0)
                torch.cuda.synchronize()
                err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
                log(f"lstm_gates bwd {shape} {dtype} g_c "
                    f"{'given' if gc is not None else 'None'}: "
                    f"max|kernel-plain| {err:.3e} (tol {tol:g})")
                if not (close(got[0], want[0], tol)
                        and close(got[1], want[1], tol)):
                    fail(f"lstm_gates bwd {shape} {dtype}: {err} > {tol}")
                if dtype == torch.float32:
                    worst = max(worst, err)
            if dtype == torch.float32:
                elems = BATCH * h * w * c
                step_ms += n_cells * cuda_ms(
                    lambda: lg.fused_lstm_gates_bwd(gates, cc, g_c, g_h, 1.0),
                    graph=True)
                step_cold += n_cells * cold_ms(
                    lambda *a: lg.fused_lstm_gates_bwd(*a, 1.0),
                    lambda: gate_inputs(shape, dtype, gen, 3),
                    7 * elems * 4)
                step_plain_ms += n_cells * cuda_ms(
                    lambda: lg.fused_lstm_gates_bwd_plain(gates, cc, g_c,
                                                          g_h, 1.0),
                    graph=True)
                step_call_ms += n_cells * cuda_ms(
                    lambda: lg.fused_lstm_gates_bwd(gates, cc, g_c, g_h, 1.0))
                # Reads gates (4), c, g_c, g_h; writes dgates (4) and dc.
                step_bytes += n_cells * 12 * elems * 4
                # Per element: the forward's 19 operations again, then
                # dct (4), the four gate derivatives (12) and dc (1).
                step_ops += n_cells * 36 * elems
                # The library's backward of its fused cell, from its
                # forward's workspace: the kernel's dgates and dc first.
                fwd = aten_cell(gates, cc)
                cx = fwd[2]
                _, cy, ws = torch.ops.aten._thnn_fused_lstm_cell(*fwd)
                lib = (g_h.reshape(cx.shape), g_c.reshape(cx.shape), cx, cy,
                       ws)
                dg_lib, dc_lib, _ = aten_cell_bwd(*lib)
                dg, dc = lg.fused_lstm_gates_bwd(gates, cc, g_c, g_h, 1.0)
                dg_lib = jifo(dg_lib, dg.shape)
                torch.cuda.synchronize()
                err = max(max_err(dg_lib, dg), max_err(dc_lib,
                                                       dc.reshape(cx.shape)))
                log(f"lstm_gates bwd {shape}: aten "
                    f"_thnn_fused_lstm_cell_backward_impl vs the kernel: max "
                    f"abs {err:.3e} (tol 1e-6)")
                if not (close(dg_lib, dg, 1e-6)
                        and close(dc_lib, dc.reshape(cx.shape), 1e-6)):
                    fail(f"aten fused LSTM cell backward differs from "
                         f"lstm_gates bwd at {(h, w, c)}: {err}")
                lib_ms += n_cells * cuda_ms(lambda: aten_cell_bwd(*lib),
                                            graph=True)
                lib_cold += n_cells * cold_ms(
                    aten_cell_bwd,
                    lambda: aten_cell_bwd_inputs(shape, gen),
                    8 * elems * 4)
    bms, by = bound_ms(step_bytes, step_ops)
    log(time_line(f"lstm_gates bwd, the {GATE_LAUNCHES_PER_STEP} cells of one "
                  f"timestep at b{BATCH} f32 (sums)", step_ms, step_cold,
                  step_plain_ms, bms, by, step_call_ms))
    log(f"lstm_gates bwd: library call aten::"
        f"_thnn_fused_lstm_cell_backward_impl, the {GATE_LAUNCHES_PER_STEP} "
        f"cells (sums): {lib_ms * 1e3:.2f} us warm, {lib_cold * 1e3:.2f} us "
        f"cold; kernel {step_ms * 1e3:.2f} / {step_cold * 1e3:.2f} us "
        f"({step_cold / lib_cold:.2f}x the library's cold time)")
    return {"name": "fused_lstm_gates_bwd", "route": "cuda",
            "source": "pivp_tpu_torch/csrc/lstm_gates.cu",
            "replaces": "pivp_tpu/ops/pallas/lstm_gates.py:140",
            "max_abs_err": worst, "ms": step_ms, "cold_ms": step_cold,
            "plain_ms": step_plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_cold_ms": lib_cold}


def profile_request(serve, request, trace_path, what="request") -> tuple:
    """One call of `serve(*request)` under torch.profiler: the device's
    busy share of its wall time and the kernels that take it; the trace
    goes to `trace_path` unless it is None. Returns the launches of each
    port kernel in the trace, in the order of `_counted()`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(*request)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    # A record_function range (torch.optim's "Optimizer.step#...") also
    # appears as a device-side span around the kernels it covers, which
    # are counted on their own.
    spans = {e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in spans]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"profiled {what}: wall {wall_us / 1e3:.3f} ms under the "
        f"profiler, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}%), {sum(e.count for e in kernels)}"
        f" kernel launches"
        + (f"; trace {trace_path}" if trace_path is not None else ""))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total:10.1f} us  x{e.count:<4d} "
            f"{e.key[:100]}")
    # The port's kernels, which the list above rarely reaches, matched by
    # their CUDA function names (each type and size is a key of its own).
    launches = []
    for fn, cuda_name in zip(_counted(), CUDA_NAMES):
        found = [e for e in kernels if f"{cuda_name}<" in e.key]
        us = sum(e.self_device_time_total for e in found)
        n = sum(e.count for e in found)
        launches.append(n)
        log(f"  in the {what}: {fn.__name__} ({cuda_name}) "
            + (f"{us:.1f} us in {n} launches, {us / n:.2f} us per launch"
               if n else "not in the trace"))
    return tuple(launches)


def rollout_layer_flops(params, cfg, batch: int) -> dict:
    """Operations (2 per multiply-add) of the convs, deconvs and dense
    layers of one feed-self rollout of T-1 steps, by layer, from the
    weight shapes: a conv is counted over its output grid, a transposed
    conv over its input grid, a dense layer once per sample. (The local
    apply and STP's sampler products are not counted.)"""
    h, w = cfg.image_height, cfg.image_width
    r0, r1, r2, r3 = (h * w, h * w // 4, h * w // 16, h * w // 64)
    grid = {"enc0": r1, "enc1": r2, "enc2": r3, "enc3": r3, "enc4": r3,
            "enc5": r2, "enc6": r1, "lstm1": r1, "lstm2": r1, "lstm3": r2,
            "lstm4": r2, "lstm5": r3, "lstm6": r2, "lstm7": r1,
            "masks": r0, "head/enc7": r0, "state_pred": 1,
            "head/cdna_kerns": 1, "head/stp_input": 1,
            "head/identity_params": 1}
    from pivp_tpu_torch.utils import weights

    out = {}
    for k, v in weights.flatten(params).items():
        if k.endswith("/w"):
            layer = k[:-2]
            # A per-mask STP projection is keyed head/identity_params/<i>.
            if layer.startswith("head/identity_params/"):
                layer = "head/identity_params"
            out[layer] = out.get(layer, 0) + (2 * batch * grid[layer]
                                              * v.numel()
                                              * (cfg.sequence_length - 1))
    return out


def rollout_flops(params, cfg, batch: int) -> float:
    """`rollout_layer_flops` summed over the layers."""
    return sum(rollout_layer_flops(params, cfg, batch).values())


def _counted():
    """The kernel wrappers with a launch counter, in the order of the
    `kernels` line."""
    from pivp_tpu_torch.ops.kernels import local_apply as la
    from pivp_tpu_torch.ops.kernels import lstm_gates as lg

    return (la.local_kernel_apply, lg.fused_lstm_gates,
            la.local_kernel_apply_bwd_w, la.local_kernel_apply_bwd_x,
            lg.fused_lstm_gates_bwd)


def reset_counters() -> None:
    for fn in _counted():
        fn.launches = 0


def read_counters() -> tuple:
    return tuple(fn.launches for fn in _counted())


def check_counters(what: str, fwd_rollouts: int, bwd_rollouts: int = 0,
                   steps: int = STEPS, local_apply: bool = True) -> tuple:
    """Each forward kernel launches once per rollout step, each backward
    kernel once per step of a differentiated rollout; the gate kernels
    once per ConvLSTM cell of a step. The local-apply kernels run in the
    CDNA and DNA heads' steps (`local_apply`), not in STP's."""
    got = read_counters()
    la = int(local_apply)
    want = (la * fwd_rollouts * steps,
            fwd_rollouts * steps * GATE_LAUNCHES_PER_STEP,
            la * bwd_rollouts * steps, la * bwd_rollouts * steps,
            bwd_rollouts * steps * GATE_LAUNCHES_PER_STEP)
    names = [fn.__name__ for fn in _counted()]
    log(f"{what}: launches " + ", ".join(
        f"{n} {g} (expected {w})" for n, g, w in zip(names, got, want)))
    if got != want:
        fail(f"{what}: launch counts {got} != {want}")
    return got


def label(cfg) -> str:
    """The head of `cfg` as the log lines name it."""
    per_mask = cfg.is_stp and not cfg.stp_shared_params
    return cfg.model_type + (" per-mask" if per_mask else "")


def head_config(head: str):
    from pivp_tpu_torch.config import ModelConfig

    return ModelConfig(**HEADS[head])


def run_name(head: str) -> str:
    return f"00000000-000000-{head}-{BATCH}"


def synthetic_batch(seed: int) -> tuple:
    """(images, actions, states), time-major, on the card."""
    from pivp_tpu_torch.config import ModelConfig
    from pivp_tpu_torch.data import synthetic

    cfg = ModelConfig()
    arrays = synthetic.generate_sequences(
        BATCH, cfg.sequence_length, cfg.image_height, cfg.image_width,
        seed=seed)
    return tuple(torch.as_tensor(a.swapaxes(0, 1).copy(), device="cuda")
                 for a in arrays)


def time_requests(serve, request, n: int) -> tuple:
    """Seconds of each of `n` requests, each ended by a synchronize."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        frames = serve(*request)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, frames


def float64_rollout(params, cfg, images, actions, states) -> torch.Tensor:
    """The frames of the feed-self rollout through the plain ops in
    float64, on the CPU."""
    from pivp_tpu_torch.models import predictor

    cfg64 = dataclasses.replace(cfg, compute_dtype="float64",
                                lstm_gate_compute="compute",
                                use_kernel=False, use_kernel_gates=False)
    p64 = predictor.map_params(lambda p: p.detach().cpu().double(), params)
    return predictor.predict(p64, cfg64, *(a.cpu().double() for a in (
        images, actions, states)))["gen_images"]


def check_rollouts(params, cfg, images, actions, states, frames) -> None:
    """The feed-self rollout through the kernels against the same rollout
    with both kernel switches off, on the same card; the served uint8
    frames against it; and the card's rollout against the CPU's, each
    held to the CPU's float64 rollout (see FRAME_TOL)."""
    from pivp_tpu_torch.models import predictor
    from pivp_tpu_torch.ops import transforms

    ctx = cfg.context_frames
    out_k = predictor.predict(params, cfg, images, actions, states)
    plain_cfg = dataclasses.replace(cfg, use_kernel=False,
                                    use_kernel_gates=False)
    out_p = predictor.predict(params, plain_cfg, images, actions, states)
    gen_k, gen_p = out_k["gen_images"], out_p["gen_images"]
    if not bool(torch.isfinite(gen_k).all()):
        fail(f"{label(cfg)}: non-finite predicted frames")
    d_serve = int((frames.int() - transforms.quantize_frames_u8(
        gen_k[ctx - 1:]).int()).abs().max())
    if d_serve > 1:
        fail(f"{label(cfg)}: served frames differ from the predict "
             f"rollout by {d_serve}")
    # The CPU's rollouts, where the wrappers take the plain path.
    cpu_params = predictor.map_params(lambda p: p.cpu(), params)
    gen_c = predictor.predict(cpu_params, cfg, images.cpu(), actions.cpu(),
                              states.cpu())["gen_images"].double()
    gen_64 = float64_rollout(params, cfg, images, actions, states)
    gen_k, gen_p = gen_k.cpu().double(), gen_p.cpu().double()

    def per_sequence(a):
        """Each sequence's max abs distance from the float64 rollout."""
        return (a - gen_64).abs().amax(dim=(0, 2, 3, 4))

    d_img = max_err(gen_k, gen_p)
    e_k, e_p, e_c = (per_sequence(g) for g in (gen_k, gen_p, gen_c))
    limit = max(FRAME_TOL, 2 * float(e_p.max()))
    d_psnr = float((out_k["psnrs"] - out_p["psnrs"]).abs().max())
    by_frame = [max_err(a, b) for a, b in zip(gen_k, gen_p)]
    log(f"{label(cfg)}: kernels vs plain ops, b{images.shape[1]} rollout: "
        f"max|dframe| {d_img:.3e} (tol {limit:.3e}), max|dPSNR| "
        f"{d_psnr:.3e} dB (tol 0.01); from the float64 rollout: kernels "
        f"{float(e_k.max()):.3e}, plain ops {float(e_p.max()):.3e}; "
        f"max|dframe| by step " + " ".join(f"{e:.1e}" for e in by_frame)
        + f"; PSNR {float(out_k['psnr_all']):.4f} dB summed, SSIM "
        f"{float(out_k['ssim']):.5f}")
    if not (d_img <= limit and d_psnr <= 0.01):
        fail(f"{label(cfg)}: kernel rollout disagrees with the "
             f"plain-op rollout")

    q_k, q_c = float(e_k.quantile(0.9)), float(e_c.quantile(0.9))
    limit = max(FRAME_TOL, 2 * q_c)
    log(f"{label(cfg)}: card vs CPU, b{images.shape[1]}, each sequence's "
        f"max|dframe| from the float64 rollout: 90th percentile card "
        f"{q_k:.3e} (tol {limit:.3e}), CPU {q_c:.3e}; median card "
        f"{float(e_k.median()):.3e}, CPU {float(e_c.median()):.3e}; max "
        f"card {float(e_k.max()):.3e}, CPU {float(e_c.max()):.3e}; the "
        f"card further in {int((e_k > e_c).sum())} of {e_k.numel()}; "
        f"card vs CPU max|dframe| {max_err(gen_k, gen_c):.3e}")
    if not q_k <= limit:
        fail(f"{label(cfg)}: the card's rollout is further from float64 "
             f"than the CPU's allows")


def serve_phase(args, card: str, cfg, requests: int,
                round_trip: bool = True) -> tuple:
    """Seeded params of `cfg` (with `round_trip`: -> save_npz ->
    load_model from a run directory that names the head) ->
    make_serve_fn, `requests` timed requests at b32 with their launch
    counts, one profiled request (CDNA's trace is written), and the
    agreement checks."""
    from pivp_tpu_torch.inference import export
    from pivp_tpu_torch.inference import predict as predict_lib
    from pivp_tpu_torch.models import predictor
    from pivp_tpu_torch.utils import checkpoint

    head, cdna = label(cfg), cfg.is_cdna
    t, ctx = cfg.sequence_length, cfg.context_frames
    params = predictor.init_params(torch.Generator().manual_seed(args.seed),
                                   cfg, device="cuda")
    if round_trip:
        run_dir = os.path.join(args.out, "models", run_name(head))
        os.makedirs(run_dir, exist_ok=True)
        ckpt = os.path.join(run_dir, "smoke-params.npz")
        checkpoint.save_npz(ckpt, params)
        cfg, params = predict_lib.load_model(
            ckpt, predict_lib.infer_model_type(run_dir), cfg.num_masks, ctx,
            cfg.use_state, image_height=cfg.image_height,
            image_width=cfg.image_width, sequence_length=t, device="cuda")
        if not (cfg.use_kernel and cfg.use_kernel_gates):
            fail("the kernel switches are off by default")
        if cfg.model_type != head:
            fail(f"load_model built a {cfg.model_type} model from {run_dir}")
        if not cdna:
            os.remove(ckpt)

    images, actions, states = synthetic_batch(args.seed)
    serve = export.make_serve_fn(params, cfg)
    request = (images[:ctx], actions[:t - 1], states[0])
    serve(*request)                                   # warm-up
    torch.cuda.synchronize()

    reset_counters()
    times, frames = time_requests(serve, request, requests)
    launches = check_counters(f"{head} serve ({requests} requests)",
                              requests, local_apply=not cfg.is_stp)
    profile_request(serve, request,
                    os.path.join(args.out, "serve_trace.json")
                    if cdna else None, what=f"{head} request")
    if frames.shape != (t - ctx, BATCH, cfg.image_height, cfg.image_width,
                        cfg.color_channels) or frames.dtype != torch.uint8:
        fail(f"{head} serve output {tuple(frames.shape)} {frames.dtype}")
    ms = [x * 1e3 for x in times]
    n_frames = (t - ctx) * BATCH
    log(f"{head} serve b{BATCH}: ms/request {ms} (median "
        f"{np.median(ms):.3f}); predicted frames/s "
        f"{n_frames / np.median(times):.1f} on {card}")
    flops = rollout_flops(params, cfg, BATCH)
    log(f"{head} serve b{BATCH}: convs, deconvs and dense layers "
        f"{flops / 1e9:.1f} GFLOP per request, "
        f"{flops / PEAK_F32_OPS_PER_S * 1e3:.2f} ms at the float32 peak")
    check_rollouts(params, cfg, images, actions, states, frames)
    return launches


def predict_phase(args) -> None:
    from pivp_tpu_torch.data import synthetic
    from pivp_tpu_torch.inference import predict as predict_lib

    data_dir = os.path.join(args.out, "data")
    synthetic.write_processed_dir(data_dir, 2, 10, 64, 64, seed=args.seed)
    reset_counters()
    path = predict_lib.predict_and_render(
        run_name("CDNA"), "smoke-params.npz", 0,
        models_dir=os.path.join(args.out, "models"), data_dir=data_dir,
        time_step=8, downscale_factor=0.25, device="cuda")
    torch.cuda.synchronize()
    check_counters("predict_and_render", 1)
    if not (os.path.exists(path) and os.path.getsize(path) > 0):
        fail(f"no prediction image at {path}")
    log(f"predict_and_render wrote {path} ({os.path.getsize(path)} bytes)")


def rel_frobenius(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / (b.norm() + 1e-30))


def norms_of_difference(keys, got, want) -> tuple:
    """Per-tensor relative differences and that of the whole gradient."""
    diffs, num, den = {}, 0.0, 0.0
    for k, a, b in zip(keys, got, want):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        d2, n2 = float((a - b).square().sum()), float(b.square().sum())
        diffs[k] = (d2 / (n2 + 1e-60)) ** 0.5
        num, den = num + d2, den + n2
    return diffs, (num / (den + 1e-60)) ** 0.5


@contextlib.contextmanager
def deterministic_cudnn():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


@contextlib.contextmanager
def plain_backward():
    """The kernels' autograd Functions with their backward through the
    plain versions (the forward kernels unchanged)."""
    from pivp_tpu_torch.ops.kernels import local_apply as la
    from pivp_tpu_torch.ops.kernels import lstm_gates as lg

    saved = (la.local_kernel_apply_bwd_w, la.local_kernel_apply_bwd_x,
             lg.fused_lstm_gates_bwd)
    la.local_kernel_apply_bwd_w = la.local_kernel_apply_bwd_w_plain
    la.local_kernel_apply_bwd_x = la.local_kernel_apply_bwd_x_plain
    lg.fused_lstm_gates_bwd = lg.fused_lstm_gates_bwd_plain
    try:
        yield
    finally:
        (la.local_kernel_apply_bwd_w, la.local_kernel_apply_bwd_x,
         lg.fused_lstm_gates_bwd) = saved


@contextlib.contextmanager
def sampler_cells(cells: list, replay: bool = False):
    """The STP samplers' cells (floor of each source coordinate, in call
    order): recorded into `cells`, or with `replay` taken from `cells`
    in place of the path's own. Yields a list that collects, per call,
    how many of the replayed cells differ from the path's own."""
    from pivp_tpu_torch.ops import transforms

    own_cell, moved = transforms._cell, []
    source = iter(cells) if replay else None

    def cell(coord):
        own = own_cell(coord)
        if not replay:
            cells.append(own.detach())
            return own
        took = next(source).to(own)
        moved.append((took != own).sum())
        return took

    transforms._cell = cell
    try:
        yield moved
    finally:
        transforms._cell = own_cell


def count(moved: list) -> int:
    return int(sum(int(m) for m in moved))


def check_grads(what: str, keys, got, want, noise=None,
                exact=None, limit: float = GRAD_TOL) -> None:
    """`got` against `want`. With `noise` (each tensor's run-to-run
    change), every tensor within the larger of GRAD_TOL and twice its
    noise; without it, the whole gradient within `limit`. The tensors
    beyond GRAD_TOL are listed, with both sides' distance from `exact`
    (the float64 gradient of the plain ops) when it is given."""
    diffs, whole = norms_of_difference(keys, got, want)
    worst = max(diffs, key=diffs.get)
    beyond = [k for k in keys if diffs[k] > GRAD_TOL]
    notes = []
    for k in beyond:
        note = f"{k} {diffs[k]:.3e}"
        if noise is not None:
            note += f" (run-to-run {noise[k]:.3e})"
        if exact is not None:
            i = keys.index(k)
            note += (f" (vs float64: {rel_frobenius(got[i], exact[i]):.3e}"
                     f", other side {rel_frobenius(want[i], exact[i]):.3e})")
        notes.append(note)
    log(f"{what}: whole gradient {whole:.3e}"
        + ("" if noise is not None else f" (tol {limit:.3e})")
        + f", worst tensor {worst} "
        f"{diffs[worst]:.3e}; {len(keys) - len(beyond)} of {len(keys)} "
        f"tensors within {GRAD_TOL:g}"
        + ("; beyond it: " + "; ".join(notes) if notes else ""))
    if noise is not None:
        bad = [k for k in beyond if diffs[k] > 2 * noise[k]]
    else:
        bad = ["whole gradient"] if whole > limit else []
    if bad:
        fail(f"{what}: {bad} disagree beyond the limit")


def grads_float64(ts, predictor, sampling, params, cfg, batch, it, seed):
    """The gradient of the same step through the plain ops in float64."""
    cfg64 = dataclasses.replace(cfg, compute_dtype="float64",
                                lstm_gate_compute="compute",
                                use_kernel=False, use_kernel_gates=False)
    p64 = predictor.map_params(
        lambda p: p.detach().double().requires_grad_(), params)
    grads, _ = ts.grads_and_metrics(p64, cfg64,
                                    tuple(a.double() for a in batch), it,
                                    sampling.generator(seed, it))
    return grads


def check_step_grads(state_params, cfg, batch, seed: int,
                     iterations) -> None:
    """One step's gradients at each of `iterations`: the backward kernels
    against their plain versions on the same forward, tensor by tensor
    (within twice the plain ops' own run-to-run change where that is
    larger than GRAD_TOL), and the kernels against the plain ops over
    the whole gradient, with the float64 distances of the tensors beyond
    GRAD_TOL. The plain and float64 steps sample at the kernels' STP
    sampler cells (see GRAD_TOL); the plain step on its own cells is
    printed, not gated."""
    from pivp_tpu_torch.models import predictor
    from pivp_tpu_torch.ops import sampling
    from pivp_tpu_torch.parallel import train_step as ts
    from pivp_tpu_torch.utils import weights

    keys = list(weights.flatten(state_params))
    plain_cfg = dataclasses.replace(cfg, use_kernel=False,
                                    use_kernel_gates=False)
    head = label(cfg)
    for it in iterations:
        n_gt = sampling.num_ground_truth(BATCH, cfg.scheduled_sampling_k, it)

        def grads(c):
            return ts.grads_and_metrics(state_params, c, batch, it,
                                        sampling.generator(seed, it))

        noise, whole_noise = norms_of_difference(
            keys, grads(plain_cfg)[0], grads(plain_cfg)[0])
        worst = max(noise, key=noise.get)
        log(f"{head} iteration {it}: the plain ops run twice with cuDNN's "
            f"default algorithms differ by up to {noise[worst]:.3e} "
            f"({worst}), {whole_noise:.3e} over the whole gradient")
        with deterministic_cudnn():
            cells = []
            with sampler_cells(cells):
                g_k, m_k = grads(cfg)
            with plain_backward():
                g_b, _ = grads(cfg)
            with sampler_cells(cells, replay=True) as moved:
                g_p, m_p = grads(plain_cfg)
            with sampler_cells(cells, replay=True):
                g_64 = grads_float64(ts, predictor, sampling, state_params,
                                     cfg, batch, it, seed)
            if cells:
                g_own, _ = grads(plain_cfg)
        log(f"{head} iteration {it} (n_gt {n_gt} of {BATCH}): loss kernels "
            f"{float(m_k['loss']):.8f}, plain {float(m_p['loss']):.8f}")
        if cells:
            _, whole_own = norms_of_difference(keys, g_k, g_own)
            log(f"{head} iteration {it}: the plain ops' own sampler cells "
                f"differ from the kernels' in {count(moved)} of "
                f"{sum(c.numel() for c in cells)}; on their own cells, "
                f"kernels vs plain ops {whole_own:.3e} over the whole "
                f"gradient (not gated)")
        check_grads(f"{head} b{BATCH} train step at iteration {it}, "
                    f"backward kernels vs their plain versions", keys, g_k,
                    g_b, noise=noise)
        check_grads(f"{head} b{BATCH} train step at iteration {it}, "
                    f"kernels vs plain ops" + (" on the kernels' sampler "
                                              "cells" if cells else ""),
                    keys, g_k, g_p, exact=g_64)


def check_card_vs_float64(state_params, cfg, batch, seed: int) -> None:
    """The card's float32 gradient of a 2-sequence step at iteration 6000
    against the float64 gradient of the same step (the plain ops on the
    CPU), over the whole gradient within GRAD_TOL, or twice the CPU
    float32's own distance from it where that is larger: a unit within
    float32 rounding of zero can take the other side of its ReLU on
    either float32 device, or on both, and the float64 step says which
    did (see GRAD_TOL)."""
    from pivp_tpu_torch.models import predictor
    from pivp_tpu_torch.ops import sampling
    from pivp_tpu_torch.parallel import train_step as ts
    from pivp_tpu_torch.utils import weights

    keys = list(weights.flatten(state_params))
    it = 6000
    two = tuple(a[:, :2].cpu() for a in batch)
    cpu_params = predictor.map_params(
        lambda p: p.detach().cpu().requires_grad_(), state_params)
    with deterministic_cudnn():
        g_d, _ = ts.grads_and_metrics(state_params, cfg,
                                      tuple(a.to(batch[0].device)
                                            for a in two), it,
                                      sampling.generator(seed, it))
    g_c, _ = ts.grads_and_metrics(cpu_params, cfg, two, it,
                                  sampling.generator(seed, it))
    g_64 = grads_float64(ts, predictor, sampling, cpu_params, cfg, two, it,
                         seed)
    cpu_diffs, cpu_whole = norms_of_difference(keys, g_c, g_64)
    worst = max(cpu_diffs, key=cpu_diffs.get)
    log(f"{label(cfg)} train step at iteration {it}, 2 sequences, the "
        f"CPU's float32 vs float64: whole gradient {cpu_whole:.3e}, worst "
        f"tensor {worst} {cpu_diffs[worst]:.3e}")
    check_grads(f"{label(cfg)} train step at iteration {it}, 2 "
                f"sequences, card vs float64", keys, g_d, g_64,
                limit=max(GRAD_TOL, 2 * cpu_whole))


def train_cli_phase(args, cfg) -> tuple:
    """The training CLI in process: 80 synthetic sequences split 64 / 16,
    so the second batch of 32 closes epoch 1 (and no later one does
    before step 4), which runs one validation sweep (one batch, 16
    sequences padded to 32) and saves checkpoint 1; then the final one.
    The run directory (~120 MB of npz at full width) is checked, then
    deleted."""
    from pivp_tpu_torch.training import train_cli

    head = cfg.model_type
    models = tempfile.mkdtemp(dir=args.out, prefix="train-")
    reset_counters()
    t0 = time.perf_counter()
    result = train_cli.main([
        "--synthetic", "80", "--train_val_split", "0.8",
        "--num_iterations", str(args.train_steps), "--batch_size",
        str(BATCH), "--validation_interval", "1", "--save_interval", "1",
        "--seed", str(args.seed), "--output_dir", models,
        "--event_log_dir", models, "--run_name", run_name(head),
        "--model_type", head, "--num_masks", str(cfg.num_masks),
        "--device", "cuda"], standalone_mode=False)
    torch.cuda.synchronize()
    log(f"{head} train_cli: {args.train_steps} steps, 1 validation sweep, "
        f"2 checkpoints in {time.perf_counter() - t0:.1f} s")
    launches = check_counters(
        f"{head} train_cli ({args.train_steps} steps + 1 validation batch)",
        args.train_steps + 1, args.train_steps, local_apply=not cfg.is_stp)
    if result["model_config"].model_type != head:
        fail(f"train_cli trained {result['model_config'].model_type}")
    save_dir = result["save_dir"]
    for name in ("training-1.npz", "state-1.npz", "training-final.npz",
                 "state-final.npz", "training-global_losses.npy",
                 "training-global_psnr_all.npy",
                 "training-global_losses_valid.npy",
                 "training-global_psnr_all_valid.npy"):
        if not os.path.exists(os.path.join(save_dir, name)):
            fail(f"train_cli wrote no {name} in {save_dir}")
    curves = [np.load(os.path.join(save_dir, f"training-global_{n}.npy"))
              for n in ("losses", "psnr_all", "losses_valid",
                        "psnr_all_valid")]
    if not all(c.shape == (1, 5) and np.isfinite(c).all() for c in curves):
        fail(f"{head} train_cli curves {[c.tolist() for c in curves]}")
    log(f"{head} train_cli epoch 1: train loss [mean,std,min,max,median] "
        f"{curves[0][0].tolist()}, validation loss {curves[2][0, 0]:.6f}, "
        f"validation PSNR {curves[3][0, 0]:.4f} dB (summed over the "
        f"predicted frames)")
    shutil.rmtree(models)
    return launches


def train_phase(args, card: str, cfg, iterations, cli: bool = True):
    """train_cli (with `cli`), then train steps one at a time on a fixed
    batch: the launches and peak device memory of one step, the median
    of --timed_steps steps, one profiled step, and the gradient checks
    at each of `iterations` and of the card against float64. Returns
    train_cli's launch counts (None without `cli`)."""
    from pivp_tpu_torch.models import predictor
    from pivp_tpu_torch.ops import sampling
    from pivp_tpu_torch.parallel import train_step as ts

    head = label(cfg)
    launches = train_cli_phase(args, cfg) if cli else None
    batch = synthetic_batch(args.seed + 1)
    params = predictor.init_params(torch.Generator().manual_seed(args.seed),
                                   cfg, device="cuda")
    state = ts.create_train_state(params, ts.make_optimizer(1e-3))
    step = ts.make_train_step(cfg)
    seed = args.seed + 1
    for it in range(2):                                   # warm-up
        step(state, batch, it, sampling.generator(seed, it))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    _, metrics = step(state, batch, 2, sampling.generator(seed, 2))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check_counters(f"{head} one train step", 1, 1,
                   local_apply=not cfg.is_stp)
    if not bool(torch.isfinite(metrics["loss"])):
        fail(f"{head}: non-finite training loss {float(metrics['loss'])}")
    times = []
    for it in range(3, 3 + args.timed_steps):
        t0 = time.perf_counter()
        step(state, batch, it, sampling.generator(seed, it))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = [x * 1e3 for x in times]
    log(f"{head} train b{BATCH}: ms/step {ms} (median {np.median(ms):.3f}); "
        f"training frames/s {BATCH * PREDICTED / np.median(times):.1f}; "
        f"peak device memory of a step {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated) on {card}")
    flops = 3 * rollout_flops(state.params, cfg, BATCH)
    log(f"{head} train b{BATCH}: convs, deconvs and dense layers about "
        f"{flops / 1e9:.1f} GFLOP per step (3x the forward's), "
        f"{flops / PEAK_F32_OPS_PER_S * 1e3:.2f} ms at the float32 peak")
    it = 3 + args.timed_steps
    profile_request(lambda: step(state, batch, it,
                                 sampling.generator(seed, it)),
                    (), None, what=f"{head} train step")
    check_step_grads(state.params, cfg, batch, seed, iterations)
    check_card_vs_float64(state.params, cfg, batch, seed)
    return launches


def frames_differ(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got != want).sum())


def check_artifact(head: str, cfg, serve, live, request, requests: int,
                   profile: bool) -> None:
    """A loaded serving artifact `serve` against make_serve_fn's `live`
    on the same weights: its graph's kernel nodes; its frames, bit for
    bit with cudnn.deterministic (cuDNN's default algorithm for the
    transposed convolutions is not reproducible from one run to the
    next, so make_serve_fn differs from itself by tens to hundreds of u8
    values a request; both counts are printed); the launches of `requests`
    requests by counter and, with `profile`, of one by the profiler;
    and the medians of both, timed in turns."""
    from pivp_tpu_torch.inference import export

    nodes = export.kernel_nodes(serve.exported)
    want_nodes = {"lstm_gates_fwd": STEPS * GATE_LAUNCHES_PER_STEP}
    if not cfg.is_stp:
        want_nodes["local_apply_fwd"] = STEPS
    log(f"{head} artifact: pivp nodes {nodes} (expected {want_nodes}); "
        f"inputs {[tuple(s.shape) for s in serve.in_specs]}")
    if nodes != want_nodes:
        fail(f"{head} artifact: kernel nodes {nodes} != {want_nodes}")
    got, want, again = serve(*request), live(*request), live(*request)
    torch.cuda.synchronize()
    if (got.shape != want.shape or got.dtype != torch.uint8
            or want.shape != (PREDICTED, BATCH, cfg.image_height,
                              cfg.image_width, cfg.color_channels)):
        fail(f"{head} artifact output {tuple(got.shape)} {got.dtype}")
    log(f"{head} artifact vs make_serve_fn, cuDNN's default algorithms: "
        f"{frames_differ(got, want)} of {want.numel()} u8 values differ "
        f"(make_serve_fn vs itself: {frames_differ(again, want)})")
    with deterministic_cudnn():
        got, want = serve(*request), live(*request)
        torch.cuda.synchronize()
    n = frames_differ(got, want)
    log(f"{head} artifact vs make_serve_fn, cudnn.deterministic: {n} of "
        f"{want.numel()} u8 values differ")
    if n:
        fail(f"{head} artifact's frames differ from make_serve_fn's")
    reset_counters()
    time_requests(serve, request, requests)
    check_counters(f"{head} artifact ({requests} requests)", requests,
                   local_apply=not cfg.is_stp)
    if profile:
        seen = profile_request(serve, request, None,
                               what=f"{head} artifact request")
        if seen != (STEPS, STEPS * GATE_LAUNCHES_PER_STEP, 0, 0, 0):
            fail(f"{head} artifact request: profiled launches {seen}")
    t_art, t_live = [], []
    for _ in range(requests):
        t_art += time_requests(serve, request, 1)[0]
        t_live += time_requests(live, request, 1)[0]
    log(f"{head} b{BATCH}, in turns: artifact ms/request "
        f"{[round(x * 1e3, 3) for x in t_art]} (median "
        f"{np.median(t_art) * 1e3:.3f}), make_serve_fn "
        f"{[round(x * 1e3, 3) for x in t_live]} (median "
        f"{np.median(t_live) * 1e3:.3f})")


def check_http(httpd, live, request) -> None:
    """The example server, serving in a thread: /healthz, one timed b32
    POST at cuDNN's default algorithms, one under cudnn.deterministic
    whose frames must equal make_serve_fn's, and a 400 for a malformed
    body and for a wrong batch."""
    import io
    import threading
    import urllib.error
    import urllib.request

    def post(body: bytes):
        return urllib.request.urlopen(urllib.request.Request(
            base + "/predict", data=body, method="POST"), timeout=120)

    def npz(images, actions, state0) -> bytes:
        out = io.BytesIO()
        np.savez(out, images=images, actions=actions, state0=state0)
        return out.getvalue()

    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = httpd.server_address
        base = f"http://{host}:{port}"
        if urllib.request.urlopen(base + "/healthz",
                                  timeout=60).read() != b"ok":
            fail("the HTTP server's /healthz is not ok")
        arrays = [a.cpu().numpy() for a in request]
        t0 = time.perf_counter()
        post(npz(*arrays)).read()
        ms = (time.perf_counter() - t0) * 1e3
        with deterministic_cudnn():
            with np.load(io.BytesIO(post(npz(*arrays)).read())) as z:
                frames = z["frames"]
            want = live(*request).cpu().numpy()
        n = int((frames != want).sum())
        log(f"HTTP b{BATCH} POST /predict: round trip {ms:.3f} ms; with "
            f"cudnn.deterministic {n} of {want.size} u8 values differ from "
            f"make_serve_fn's")
        if n:
            fail("the HTTP reply's frames differ from make_serve_fn's")
        for what, body in (("a malformed body", b"not-an-npz"),
                           ("a wrong batch", npz(*(a[:, :1] if a.ndim > 2
                                                   else a[:1]
                                                   for a in arrays)))):
            try:
                post(body)
                fail(f"HTTP: {what} was answered")
            except urllib.error.HTTPError as e:
                log(f"HTTP: {what} gets {e.code}")
                if e.code != 400:
                    fail(f"HTTP: {what} gets {e.code}, not 400")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        fail("the HTTP server's thread did not stop")


def deploy_phase(args) -> None:
    """CDNA: seeded params -> export_reference_npz (the Chainer layout)
    -> convert_cli import (bit for bit) -> export_cli from a run
    directory that names the head -> the example HTTP server, which
    loads the artifact; the artifact against make_serve_fn
    (check_artifact, profiled) and over HTTP (check_http). Then DNA and
    STP (shared): export_serving_artifact -> load_serving_artifact ->
    check_artifact. Artifacts go to a temp dir, deleted at the end."""
    from pivp_tpu_torch.inference import export, export_cli
    from pivp_tpu_torch.models import predictor
    from pivp_tpu_torch.utils import checkpoint, convert_cli, weights

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "examples"))
    import serve_http_torch

    tmp = tempfile.mkdtemp(dir=args.out, prefix="deploy-")
    try:
        cfg = head_config("CDNA")
        params = predictor.init_params(
            torch.Generator().manual_seed(args.seed), cfg, device="cuda")
        request = synthetic_batch(args.seed)
        request = (request[0][:cfg.context_frames],
                   request[1][:cfg.sequence_length - 1], request[2][0])
        chainer = os.path.join(tmp, "chainer.npz")
        checkpoint.export_reference_npz(chainer, cfg, params)
        models = os.path.join(tmp, "models")
        ours = os.path.join(models, run_name("CDNA"), "training-final.npz")
        os.makedirs(os.path.dirname(ours))
        convert_cli.main(["import", chainer, ours, "--model_type", "CDNA",
                          "--num_masks", str(cfg.num_masks)],
                         standalone_mode=False)
        want = weights.to_jax_params(params)
        with np.load(ours) as z:
            same = sorted(z.files) == sorted(want) and all(
                z[k].dtype == v.dtype and np.array_equal(z[k], v)
                for k, v in want.items())
        log(f"CDNA Chainer npz ({os.path.getsize(chainer)} bytes) -> "
            f"convert_cli import: {len(want)} arrays, equal to the params "
            f"bit for bit: {same}")
        if not same:
            fail("convert_cli import changed the params")
        pt2 = os.path.join(tmp, "cdna.pt2")
        t0 = time.perf_counter()
        export_cli.main([run_name("CDNA"), "training-final.npz", pt2,
                         "--models_dir", models, "--batch", str(BATCH),
                         "--device", "cuda"], standalone_mode=False)
        t1 = time.perf_counter()
        httpd = serve_http_torch.make_server(pt2, "127.0.0.1", 0)
        log(f"CDNA export_cli: {os.path.getsize(pt2)} bytes in "
            f"{t1 - t0:.1f} s; make_server loaded and warmed it up in "
            f"{time.perf_counter() - t1:.1f} s")
        live = export.make_serve_fn(params, cfg)
        check_artifact("CDNA", cfg, httpd.artifact, live, request,
                       args.requests, profile=True)
        check_http(httpd, live, request)
        for head in ("DNA", "STP"):
            cfg = head_config(head)
            params = predictor.init_params(
                torch.Generator().manual_seed(args.seed), cfg,
                device="cuda")
            path = os.path.join(tmp, f"{head}.pt2")
            t0 = time.perf_counter()
            export.export_serving_artifact(params, cfg, BATCH, path)
            t1 = time.perf_counter()
            serve = export.load_serving_artifact(path)
            log(f"{head} export_serving_artifact: {os.path.getsize(path)} "
                f"bytes in {t1 - t0:.1f} s; load_serving_artifact "
                f"{time.perf_counter() - t1:.1f} s")
            check_artifact(head, cfg, serve,
                           export.make_serve_fn(params, cfg), request,
                           HEAD_REQUESTS, profile=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

@contextlib.contextmanager
def deterministic():
    """cudnn.deterministic and torch.use_deterministic_algorithms(True,
    warn_only=True): yields the list that collects the warning of each
    op that has no deterministic implementation."""
    prev = (torch.backends.cudnn.deterministic,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.backends.cudnn.deterministic = prev[0]
        torch.use_deterministic_algorithms(prev[1], warn_only=prev[2])


@contextlib.contextmanager
def thread_querying_events():
    """A thread that, until the block ends, makes the CUDA calls the
    loop's prefetch thread makes while it pins payloads: pinned
    allocations and event queries (the host allocator's). A capture in
    CUDA's global mode fails when another thread makes them. Yields a
    list holding the thread's round count, then any error it met."""
    import threading

    stop, out = threading.Event(), [0]
    event = torch.cuda.Event()
    event.record(torch.cuda.Stream())

    def run():
        try:
            while not stop.is_set():
                torch.empty(1 << 16, dtype=torch.uint8, pin_memory=True)
                event.query()
                out[0] += 1
        except Exception as e:  # reported by the caller
            out.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join()


def nondeterministic_ops(caught) -> list:
    return sorted({str(w.message).split(" does not have")[0][:120]
                   for w in caught if "deterministic" in str(w.message)})


def driver_batches(seed: int, batch: int, k: int = DRIVER_K) -> tuple:
    """k time-major batches stacked (k, T, B, ...), frames as uint8 (what
    the loop stages with u8_transfer), on the host."""
    from pivp_tpu_torch.config import ModelConfig
    from pivp_tpu_torch.data import assembler, synthetic

    cfg = ModelConfig()
    imgs, acts, stas = synthetic.generate_sequences(
        k * batch, cfg.sequence_length, cfg.image_height, cfg.image_width,
        seed=seed)
    stacked = tuple(np.stack([a[i * batch:(i + 1) * batch].swapaxes(0, 1)
                              for i in range(k)])
                    for a in (imgs, acts, stas))
    return (assembler.quantize_images(stacked[0]),) + stacked[1:]


def new_train_state(cfg, seed: int):
    from pivp_tpu_torch.models import predictor
    from pivp_tpu_torch.parallel import train_step as ts

    params = predictor.init_params(torch.Generator().manual_seed(seed),
                                   cfg, device="cuda")
    return ts.create_train_state(params, ts.make_optimizer(1e-3))


def per_step_launches(cfg) -> tuple:
    la = 0 if cfg.is_stp else STEPS
    return (la, STEPS * GATE_LAUNCHES_PER_STEP, la, la,
            STEPS * GATE_LAUNCHES_PER_STEP)


def graphed_vs_eager(args, cfg, batch: int) -> None:
    """Phase 11 (a): from one seeded state and one set of DRIVER_K
    batches, the replays of the captured train step against as many
    eager steps, under `deterministic`: the params, the Adam mu/nu/count
    and each step's loss and PSNR bit for bit, and the launches each
    replay makes (the counters: the warm-up steps and the replays). The
    capture runs beside a thread that pins buffers and queries events,
    as the loop's prefetch thread does in a run's first dispatch."""
    from pivp_tpu_torch.ops import sampling
    from pivp_tpu_torch.parallel import train_step as ts
    from pivp_tpu_torch.utils import weights

    head = label(cfg)
    seed = args.seed + 1
    batches = driver_batches(args.seed + 2, batch)
    with deterministic() as caught:
        eager, step = new_train_state(cfg, args.seed), ts.make_train_step(cfg)
        want = []
        for i in range(DRIVER_K):
            it = DRIVER_ITER0 + i
            _, m = step(eager, tuple(torch.as_tensor(a[i], device="cuda")
                                     for a in batches), it,
                        sampling.generator(seed, it))
            want.append(torch.stack([m["loss"], m["psnr_all"]]))
        graphed = new_train_state(cfg, args.seed)
        multi = ts.make_train_multi(cfg)
        reset_counters()
        with thread_querying_events() as thread:
            _, got = multi(graphed, batches, DRIVER_ITER0, seed)
            torch.cuda.synchronize()
        counts = read_counters()
    cap = multi.captured
    log(f"{head} b{batch}: captured with another thread pinning buffers "
        f"and querying events ({thread[0]} rounds, errors {thread[1:]})")
    if thread[0] == 0 or thread[1:]:
        fail(f"{head}: the event-querying thread: {thread}")
    want_launches = per_step_launches(cfg)
    log(f"{head} b{batch}: captured train step, launches a replay "
        f"{cap.launches} (expected {want_launches}); counters over the "
        f"dispatch {counts} (2 warm-up steps + {DRIVER_K} replays); "
        f"capture {cap.capture_s:.2f} s, graph pool "
        f"{cap.pool_bytes} bytes ({cap.pool_bytes / 2**30:.3f} GiB)")
    if cap.launches != want_launches:
        fail(f"{head}: a replay launches {cap.launches}")
    if counts != tuple((2 + DRIVER_K) * n for n in want_launches):
        fail(f"{head}: counters {counts} over the dispatch")
    ops = nondeterministic_ops(caught)
    log(f"{head} b{batch}: ops without a deterministic implementation: "
        f"{ops or 'none'}")
    a = dict(weights.flatten(ts.opt_state_tree(graphed)),
             **{f"params/{k}": v for k, v
                in weights.flatten(graphed.params).items()})
    b = dict(weights.flatten(ts.opt_state_tree(eager)),
             **{f"params/{k}": v for k, v
                in weights.flatten(eager.params).items()})
    differ = [k for k in b if not torch.equal(a[k], b[k])]
    metrics = torch.stack([got["loss"], got["psnr_all"]], dim=1)
    same_metrics = torch.equal(metrics, torch.stack(want))
    log(f"{head} b{batch}: {DRIVER_K} graphed steps vs {DRIVER_K} eager "
        f"steps: {len(b) - len(differ)} of {len(b)} params/Adam tensors "
        f"equal bit for bit (count {int(a['count'])} vs {int(b['count'])})"
        f", per-step loss and PSNR equal: {same_metrics} "
        f"({metrics[:, 0].tolist()})")
    if differ or not same_metrics:
        worst = {k: float((a[k].double() - b[k].double()).abs().max())
                 for k in differ}
        fail(f"{head}: graphed steps differ from eager ones: {worst}")


def graphed_timing(args, cfg) -> None:
    """Phase 11 (a), times at BATCH: the median of 3 dispatches of
    DRIVER_K replays (a pre-staged, pinned payload; each ended by a
    synchronize) over DRIVER_K, against the median of 5 eager steps on a
    batch already on the card, after warm-up; one profiled dispatch,
    whose launches of each kernel must be DRIVER_K times a replay's, and
    one profiled eager step."""
    from pivp_tpu_torch.ops import sampling
    from pivp_tpu_torch.parallel import train_step as ts

    head = label(cfg)
    seed = args.seed + 1
    batches = driver_batches(args.seed + 3, BATCH)
    state, multi = new_train_state(cfg, args.seed), ts.make_train_multi(cfg)

    def staged(i):
        return ts.stage_call(cfg, batches, DRIVER_ITER0 + i * DRIVER_K,
                             seed, pin=True)

    multi(state, staged(0), DRIVER_ITER0, seed)              # capture
    times = []
    for i in range(1, 4):
        call = staged(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multi(state, call, call.iter0, seed)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / DRIVER_K)
    call = staged(4)
    launches = profile_request(
        lambda: multi(state, call, call.iter0, seed), (), None,
        what=f"{head} graphed dispatch of {DRIVER_K} steps")
    want = tuple(DRIVER_K * n for n in multi.captured.launches)
    log(f"{head}: the profiled dispatch's kernels by the trace {launches}"
        f", by the counters {want}")
    # The profiler loses some kernel records of a graph replay (STP's
    # gate backward: 1 and 4 of 252 in two runs on an H100, while the
    # replays equal eager steps bit for bit), so the trace may show
    # fewer launches than the counters, but never more, and every
    # counted kernel.
    if any(n > w or (w and not n) for n, w in zip(launches, want)):
        fail(f"{head}: the profiled dispatch launched {launches}, the "
             f"counters say {want}")
    step = ts.make_train_step(cfg)
    batch = tuple(torch.as_tensor(a[0], device="cuda") for a in batches)
    eager_times = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch, i, sampling.generator(seed, i))
        torch.cuda.synchronize()
        eager_times.append(time.perf_counter() - t0)
    profile_request(lambda: step(state, batch, 7,
                                 sampling.generator(seed, 7)), (), None,
                    what=f"{head} eager step")
    g_ms = [x * 1e3 for x in times]
    e_ms = [x * 1e3 for x in eager_times[2:]]
    MEASURED[f"graphed_ms/{head}"] = float(np.median(g_ms))
    log(f"{head} train b{BATCH}: graphed ms/step {g_ms} (median "
        f"{np.median(g_ms):.3f}, dispatches of {DRIVER_K}); eager ms/step "
        f"{e_ms} (median {np.median(e_ms):.3f}); capture "
        f"{multi.captured.capture_s:.2f} s, graph pool "
        f"{multi.captured.pool_bytes / 2**30:.3f} GiB")


def driver_cli(args, models: str, data: str, *extra) -> list:
    return ["--data_dir", data, "--train_val_split", DRIVER_SPLIT,
            "--num_iterations", str(DRIVER_ITERS), "--batch_size",
            str(BATCH), "--validation_interval", "2", "--save_interval",
            "100", "--seed", str(args.seed), "--steps_per_call",
            str(DRIVER_K), "--prefetch", "2", "--checkpointer", "torch",
            "--graceful_preemption", "1", "--run_name", run_name("CDNA"),
            "--output_dir", models, "--event_log_dir", models,
            "--device", "cuda", *extra]


def driver_child(args, models: str, data: str, log_path: str):
    root = os.path.dirname(os.path.abspath(__file__))
    out = open(log_path, "a")
    try:
        return subprocess.Popen(
            [sys.executable, "-c", DRIVER_CHILD,
             *driver_cli(args, models, data)], cwd=root, stdout=out,
            stderr=subprocess.STDOUT)
    finally:
        out.close()


def wait_child(child, what: str, log_path: str) -> None:
    try:
        rc = child.wait(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-3000:]
        fail(f"{what} exited {rc}:\n{tail}")


def same_run_files(a: str, b: str) -> list:
    """The files of run directory `b` that differ from `a`'s: the final
    weights and optimizer state, array by array, and the four curves."""
    differ = []
    for name in ("training-final.npz", "state-final.npz"):
        with np.load(os.path.join(a, name)) as x, \
                np.load(os.path.join(b, name)) as y:
            if sorted(x.files) != sorted(y.files) or not all(
                    np.array_equal(x[k], y[k]) for k in x.files):
                differ.append(name)
    for name in ("losses", "psnr_all", "losses_valid", "psnr_all_valid"):
        name = f"training-global_{name}.npy"
        x, y = (np.load(os.path.join(d, name)) for d in (a, b))
        if x.shape != y.shape or not np.array_equal(x, y):
            differ.append(name)
    return differ


def driver_runs(args, tmp: str) -> tuple:
    """Phase 11 (b): train_cli with K-step dispatch, prefetch and the
    torch checkpointer on data on disk, under `deterministic`. The
    uninterrupted run (in process; its launches are counted: 2 warm-up
    steps and DRIVER_ITERS replays, and the validation sweeps' rollouts);
    a train_cli process that gets a SIGTERM once its first epoch is
    logged, checkpoints at the next dispatch boundary and exits 0, and
    is started again with the same run name: its final npz files and
    curves equal the uninterrupted run's bit for bit; and the run with
    --lazy_load 1, whose final params equal them too. Returns the
    uninterrupted run's directory and the data directory."""
    from pivp_tpu_torch.data import synthetic
    from pivp_tpu_torch.training import train_cli

    data = os.path.join(tmp, "data")
    synthetic.write_processed_dir(data, DRIVER_SEQUENCES, 10, 64, 64,
                                  seed=args.seed)
    full = os.path.join(tmp, "full")
    with deterministic() as caught:
        reset_counters()
        t0 = time.perf_counter()
        train_cli.main(driver_cli(args, full, data), standalone_mode=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    epochs = DRIVER_ITERS // DRIVER_EPOCH
    n_val = DRIVER_SEQUENCES - int(float(DRIVER_SPLIT) * DRIVER_SEQUENCES)
    sweeps = epochs // 2 * -(-n_val // BATCH)
    check_counters(
        f"CDNA train_cli --steps_per_call {DRIVER_K} ({DRIVER_ITERS} "
        f"steps, 2 warm-up steps, {sweeps} validation batches) in "
        f"{seconds:.1f} s", DRIVER_ITERS + 2 + sweeps, DRIVER_ITERS + 2)
    log(f"CDNA driver run: ops without a deterministic implementation: "
        f"{nondeterministic_ops(caught) or 'none'}")
    full_dir = os.path.join(full, run_name("CDNA"))

    pre = os.path.join(tmp, "preempted")
    log_path = os.path.join(tmp, "child.log")
    events = os.path.join(pre, f"{run_name('CDNA')}-events.jsonl")
    t0 = time.perf_counter()
    child = driver_child(args, pre, data, log_path)
    try:
        while child.poll() is None and not (
                os.path.exists(events) and os.path.getsize(events)):
            time.sleep(0.01)
        if child.poll() is None:
            child.send_signal(signal.SIGTERM)
    finally:
        wait_child(child, "the preempted train_cli", log_path)
    pre_dir = os.path.join(pre, run_name("CDNA"))
    stops = glob.glob(os.path.join(pre_dir, "training-preempt-itr*.npz"))
    if len(stops) != 1:
        fail(f"the SIGTERM did not preempt the run: {os.listdir(pre_dir)}")
    stop = int(stops[0].rsplit("itr", 1)[1][:-4])
    log(f"SIGTERM after epoch 1: the run checkpointed at iteration {stop} "
        f"({'mid-epoch' if stop % DRIVER_EPOCH else 'at an epoch end'}) "
        f"and exited 0 after {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    child = driver_child(args, pre, data, log_path)
    wait_child(child, "the resumed train_cli", log_path)
    differ = same_run_files(full_dir, pre_dir)
    log(f"resumed with the same --run_name in {time.perf_counter() - t0:.1f}"
        f" s: final npz and curves equal to the uninterrupted run's bit for "
        f"bit: {not differ} {differ or ''}")
    if differ:
        fail(f"the resumed run differs from the uninterrupted one: {differ}")

    lazy = os.path.join(tmp, "lazy")
    with deterministic():
        train_cli.main(driver_cli(args, lazy, data, "--lazy_load", "1"),
                       standalone_mode=False)
    differ = same_run_files(full_dir, os.path.join(lazy, run_name("CDNA")))
    log(f"--lazy_load 1: final npz and curves equal bit for bit: "
        f"{not differ} {differ or ''}")
    if differ:
        fail(f"the lazy_load run differs: {differ}")
    return full, data


def driver_profile(args, tmp: str, data: str) -> None:
    """Phase 11 (c): --profile_dir on a 3-iteration train_cli run writes a
    torch.profiler trace that holds the five kernels."""
    from pivp_tpu_torch.training import train_cli

    trace_dir = os.path.join(tmp, "trace")
    models = os.path.join(tmp, "profiled")
    train_cli.main(["--data_dir", data, "--train_val_split", DRIVER_SPLIT,
                    "--num_iterations", "3", "--batch_size", str(BATCH),
                    "--seed", str(args.seed), "--run_name",
                    run_name("CDNA"), "--output_dir", models,
                    "--event_log_dir", models, "--profile_dir", trace_dir,
                    "--device", "cuda"], standalone_mode=False)
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"--profile_dir wrote {os.listdir(trace_dir)}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {n: sum(f"{n}<" in k for k in kernels) for n in CUDA_NAMES}
    log(f"--profile_dir: {os.path.basename(traces[0])} "
        f"({os.path.getsize(traces[0])} bytes, {len(kernels)} kernel "
        f"events); the five kernels' events: {found}")
    if not all(found.values()):
        fail(f"the trace lacks a kernel: {found}")


def driver_visualize(args, tmp: str, models: str, data: str) -> None:
    """Phase 11 (d): visualize_cli on the uninterrupted run's directory
    writes the loss curves and the enc0..enc7 activation grids and
    projections (where matplotlib is installed; elsewhere the numbers
    they draw, `visualize.model_activations`, are computed on the card
    and the log says the drawing is left to the CPU); the captured
    activations through the kernels lie within FRAME_TOL of the plain
    ops'."""
    import importlib.util

    from pivp_tpu_torch.data import dataset
    from pivp_tpu_torch.inference import predict
    from pivp_tpu_torch.models import predictor
    from pivp_tpu_torch.visualization import visualize, visualize_cli

    checkpoint = os.path.join(models, run_name("CDNA"), "training-final.npz")
    if importlib.util.find_spec("matplotlib") is not None:
        figs = os.path.join(tmp, "figures")
        written = visualize_cli.main(
            [run_name("CDNA"), "--model_name", "training-final.npz",
             "--models_dir", models, "--data_dir", data, "--out_dir", figs,
             "--device", "cuda"], standalone_mode=False)
        names = {os.path.basename(w) for w in written}
        want = ({f"enc{i}-activation.png" for i in range(8)}
                | {f"training-global_{n}.png" for n in (
                    "losses", "psnr_all", "losses_valid", "psnr_all_valid")}
                | {"enc0-projected-t0-output.png"})
        log(f"visualize_cli: {len(written)} figures "
            f"({sum(os.path.getsize(w) for w in written)} bytes)")
        if want - names or not all(os.path.getsize(w) for w in written):
            fail(f"visualize_cli wrote no {sorted(want - names)}")
    else:
        images, actions, states = (a[0, :5] for a in
                                   dataset.load_sequences(data, limit=1))
        acts = visualize.model_activations(checkpoint, "CDNA", images,
                                           actions, states, device="cuda")
        shapes = [a.shape for a in acts["conv_res_all"]]
        finite = all(np.isfinite(a).all() for a in acts["conv_res_all"])
        log(f"visualize: matplotlib is not installed on this host, so the "
            f"PNG rendering of visualize_cli is held on the CPU only (CPU "
            f"tests); its numbers on the card (model_activations): "
            f"enc0..enc7 {shapes}, finite {finite}, projections of steps "
            f"{list(acts['projected'])}")
        if not finite or len(shapes) != 8:
            fail("model_activations gave no finite enc0..enc7")
    cfg, params = predict.load_model(checkpoint, "CDNA", 10, 2, True, -1.0,
                                     64, 64, 5, device="cuda")
    images, actions, states = (a[:5, :1] for a in synthetic_batch(
        args.seed))
    plain = dataclasses.replace(cfg, use_kernel=False,
                                use_kernel_gates=False)
    with torch.no_grad():
        got, want_out = (predictor.rollout(params, c, images, actions,
                                           states, capture=True)
                         for c in (cfg, plain))
    err = max(max_err(a, b) for a, b in zip(got["conv_res_all"],
                                            want_out["conv_res_all"]))
    log(f"visualize: enc0..enc7 captured through the kernels vs the plain "
        f"ops: max abs {err:.3e} (limit {FRAME_TOL})")
    if err > FRAME_TOL:
        fail(f"captured activations differ by {err:.3e}")


def driver_phase(args) -> None:
    """Phase 11: the rest of the training driver (see the docstring)."""
    for head in ("CDNA", "DNA", "STP"):
        cfg = head_config(head)
        graphed_vs_eager(args, cfg, DRIVER_CHECK_BATCH[head])
        graphed_timing(args, cfg)
        torch.cuda.empty_cache()
    os.makedirs(args.out, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=args.out, prefix="driver-")
    try:
        models, data = driver_runs(args, tmp)
        driver_profile(args, tmp, data)
        driver_visualize(args, tmp, models, data)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def push_frames(rng: np.random.RandomState, t: int) -> list:
    """t JPEG frames of the push dataset's size: two squares moving over
    a textured table, drawn with PIL."""
    import io

    from PIL import Image, ImageDraw

    h, w = DATA_FRAME
    base = Image.fromarray(rng.randint(90, 140, (h // 8, w // 8, 3))
                           .astype(np.uint8)).resize((w, h))
    squares = [(rng.randint(0, w - 120), rng.randint(0, h - 120),
                rng.randint(-25, 26), rng.randint(-25, 26),
                tuple(int(v) for v in rng.randint(0, 256, 3)))
               for _ in range(2)]
    out = []
    for i in range(t):
        img = base.copy()
        draw = ImageDraw.Draw(img)
        for x, y, dx, dy, color in squares:
            x0 = int(np.clip(x + i * dx, 0, w - 120))
            y0 = int(np.clip(y + i * dy, 0, h - 120))
            draw.rectangle((x0, y0, x0 + 119, y0 + 119), fill=color)
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def write_raw_shards(raw: str, seed: int) -> int:
    """Phase 12 (a): DATA_SHARDS shards of DATA_PER_SHARD push records
    with the port's writer. Returns the bytes written."""
    from pivp_tpu_torch.data import tfrecord

    os.makedirs(raw, exist_ok=True)
    rng = np.random.RandomState(seed)
    total = 0
    for s in range(DATA_SHARDS):
        records = []
        for _ in range(DATA_PER_SHARD):
            feats = {}
            jpegs = push_frames(rng, STEPS + 1)
            for i, jpeg in enumerate(jpegs):
                feats[f"move/{i}/image/encoded"] = [jpeg]
                for key in ("commanded_pose", "endeffector"):
                    feats[f"move/{i}/{key}/vec_pitch_yaw"] = [
                        float(v) for v in rng.uniform(-1, 1, 5)]
            records.append(tfrecord.encode_example(feats))
        path = os.path.join(
            raw, f"push_train.tfrecord-{s:05d}-of-{DATA_SHARDS:05d}")
        tfrecord.write_records(path, records)
        total += os.path.getsize(path)
    return total


def run_etl(raw: str, out: str, *extra) -> int:
    """`python -m pivp_tpu_torch.data.make_dataset_cli` on `raw`; returns
    the native scanner's calls, which the CLI logs."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pivp_tpu_torch.data.make_dataset_cli",
         "--data_dir", raw, "--out_dir", out, *extra], cwd=root,
        capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"make_dataset_cli exited {proc.returncode}:\n"
             f"{proc.stderr[-3000:]}")
    found = [line for line in proc.stderr.splitlines()
             if "native TFRecord scanner calls:" in line]
    if not found:
        fail(f"make_dataset_cli logged no scanner count:\n"
             f"{proc.stderr[-2000:]}")
    calls = int(found[-1].rsplit(":", 1)[1].strip(" )"))
    log(f"make_dataset_cli {' '.join(extra)}: {seconds:.1f} s, native "
        f"TFRecord scanner calls {calls}")
    return calls


def check_processed(out: str, rows: int) -> None:
    with open(os.path.join(out, "map.csv")) as f:
        n = sum(1 for _ in f) - 1
    shapes = {name: (np.load(os.path.join(out, f"{name}_{rows - 1}.npy"))
                     .shape) for name in ("image_batch", "action_batch",
                                          "state_batch", "image_batch_pred")}
    want = {"image_batch": (STEPS + 1, 64, 64, 3),
            "action_batch": (STEPS + 1, 1, 5),
            "state_batch": (STEPS + 1, 1, 5),
            "image_batch_pred": (STEPS + 1,) + DATA_FRAME + (3,)}
    log(f"{out}: map.csv rows {n}, npy shapes {shapes}")
    if n != rows or shapes != want:
        fail(f"the ETL wrote {n} rows and {shapes}; want {rows} and {want}")


def data_cli(args, models: str, data: str, *extra) -> list:
    return ["--data_dir", data, "--num_iterations", str(DATA_ITERS),
            "--batch_size", str(BATCH), "--validation_interval", "100",
            "--save_interval", "100", "--seed", str(args.seed),
            "--steps_per_call", str(DRIVER_K), "--prefetch", "2",
            "--run_name", run_name("CDNA"), "--output_dir", models,
            "--event_log_dir", models, "--device", "cuda", *extra]


@contextlib.contextmanager
def captured_log(name: str):
    """Yields the list of messages that logger `name` emits."""
    import logging

    messages = []

    class Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    handler = Keep(level=logging.INFO)
    logger = logging.getLogger(name)
    logger.addHandler(handler)
    try:
        yield messages
    finally:
        logger.removeHandler(handler)


def data_training(args, tmp: str, data: str) -> None:
    """Phase 12 (d): train_cli on the converted directory as a world-1
    NCCL process group, K-step graphed dispatch with prefetch; then the
    same run without the process group, which must equal it bit for bit
    under `deterministic`."""
    from pivp_tpu_torch.data import native
    from pivp_tpu_torch.training import train_cli

    dist_flags = ("--coordinator_address", f"127.0.0.1:{free_port()}",
                  "--num_processes", "1", "--process_id", "0")
    grouped = os.path.join(tmp, "grouped")
    with deterministic(), captured_log(
            "pivp_tpu_torch.training.loop") as messages:
        reset_counters()
        assembled = native.assemble.calls
        t0 = time.perf_counter()
        train_cli.main(data_cli(args, grouped, data, *dist_flags),
                       standalone_mode=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        assembled = native.assemble.calls - assembled
    groups = [m for m in messages if m.startswith("Data parallel: rank")]
    log(f"train_cli on the ETL output, {' '.join(dist_flags)}: "
        f"{seconds:.1f} s; {groups[0] if groups else 'no process group'}; "
        f"native assembler calls {assembled}")
    if not groups or "(nccl)" not in groups[0]:
        fail(f"the run did not train in an NCCL process group: {groups}")
    if assembled != DATA_ITERS // DRIVER_K:
        fail(f"the native assembler ran {assembled} times, not "
             f"{DATA_ITERS // DRIVER_K}")
    check_counters(f"CDNA train_cli in a world-1 NCCL group ({DATA_ITERS} "
                   f"steps, 2 warm-up steps)", DATA_ITERS + 2,
                   DATA_ITERS + 2)
    alone = os.path.join(tmp, "alone")
    with deterministic():
        train_cli.main(data_cli(args, alone, data), standalone_mode=False)
    differ = same_run_files(os.path.join(grouped, run_name("CDNA")),
                            os.path.join(alone, run_name("CDNA")))
    log(f"the same run without the process group: final npz and curves "
        f"equal bit for bit: {not differ} {differ or ''}")
    if differ:
        fail(f"the world-1 NCCL run differs from the run without a "
             f"group: {differ}")


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def data_batch(seed: int) -> tuple:
    """Phase 12 (e)'s b32 global batch, time-major, frames as uint8."""
    return tuple(a[0] for a in driver_batches(seed, BATCH, k=1))


def dp_rank_grads(rank: int, port: int, out: str, seed: int) -> None:
    """Phase 12 (e), one of two gloo ranks on the card: its b16 half of
    the global batch, one step's all-reduced gradient (saved by rank
    0)."""
    import torch.distributed as dist

    from pivp_tpu_torch.ops import sampling
    from pivp_tpu_torch.parallel import multihost
    from pivp_tpu_torch.parallel import train_step as ts
    from pivp_tpu_torch.utils import weights
    from pivp_tpu_torch.utils.device import resolve_device

    multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cuda",
                         backend="gloo")   # NCCL refuses a shared GPU
    try:
        resolve_device("cuda")
        if dist.get_backend() != "gloo":
            raise RuntimeError(f"backend {dist.get_backend()}, not gloo")
        cfg = head_config("CDNA")
        params = new_train_state(cfg, seed).params
        local = BATCH // 2
        batch = tuple(torch.as_tensor(np.ascontiguousarray(
            a[:, rank * local:(rank + 1) * local]), device="cuda")
            for a in data_batch(seed + 5))
        grads, metrics = ts.grads_and_metrics(
            params, cfg, batch, DRIVER_ITER0,
            sampling.generator(seed + 1, DRIVER_ITER0),
            dp=multihost.data_parallel())
        if rank == 0:
            keys = list(weights.flatten(params))
            torch.save({"grads": dict(zip(keys, (g.cpu() for g in grads))),
                        "loss": float(metrics["loss"])}, out)
    finally:
        multihost.shutdown()


def data_two_ranks(args, tmp: str) -> None:
    """Phase 12 (e): two gloo ranks on the one card, b16 each, take one
    step of the b32 global batch with the same sampling inputs; their
    all-reduced gradient against the one-rank b32 step's, over the whole
    gradient, within GRAD_TOL."""
    import torch.multiprocessing as mp

    from pivp_tpu_torch.ops import sampling
    from pivp_tpu_torch.parallel import train_step as ts
    from pivp_tpu_torch.utils import weights

    out = os.path.join(tmp, "dp_grads.pt")
    t0 = time.perf_counter()
    mp.start_processes(dp_rank_grads, args=(free_port(), out, args.seed),
                       nprocs=2, join=True, start_method="spawn")
    seconds = time.perf_counter() - t0
    got = torch.load(out, weights_only=True)
    cfg = head_config("CDNA")
    params = new_train_state(cfg, args.seed).params
    batch = tuple(torch.as_tensor(a, device="cuda")
                  for a in data_batch(args.seed + 5))
    grads, metrics = ts.grads_and_metrics(
        params, cfg, batch, DRIVER_ITER0,
        sampling.generator(args.seed + 1, DRIVER_ITER0))
    keys = list(weights.flatten(params))
    diffs, whole = norms_of_difference(
        keys, [got["grads"][k] for k in keys], grads)
    worst = max(diffs, key=diffs.get)
    log(f"two gloo ranks on the card (b16 each, {seconds:.1f} s with the "
        f"spawns) vs one rank at b32, iteration {DRIVER_ITER0}: loss "
        f"{got['loss']:.6f} vs {float(metrics['loss']):.6f}; gradient "
        f"relative Frobenius {whole:.3e} (tol {GRAD_TOL:g}), worst tensor "
        f"{worst} {diffs[worst]:.3e}")
    if not whole <= GRAD_TOL:
        fail(f"the two ranks' gradient is {whole} from the one-rank step's")


def data_flops(args) -> None:
    """Phase 12 (f): the analytic FLOPs of the CDNA b32 train step
    (utils/flops) beside rollout_flops's count from the weights' shapes,
    and the float32 peak share of phase 11's graphed step."""
    from pivp_tpu_torch.models import predictor
    from pivp_tpu_torch.utils import flops

    cfg = head_config("CDNA")
    params = predictor.init_params(torch.Generator().manual_seed(args.seed),
                                   cfg, device="cpu")
    step = flops.train_step_flops(cfg, BATCH)
    forward = rollout_flops(params, cfg, BATCH)
    log(f"CDNA b{BATCH} train step FLOPs: utils/flops {step} (3x a forward "
        f"of {step // 3}); rollout_flops from the weights' shapes {forward}"
        f" a forward ({forward / (step // 3):.4f}x), {3 * forward} x3")
    # Where the two forward counts differ, layer by layer.
    ours = {k: v * BATCH * (cfg.sequence_length - 1)
            for k, v in flops.forward_step_terms(cfg).items()}
    theirs = rollout_layer_flops(params, cfg, BATCH)
    gap = step // 3 - forward
    for layer in sorted(set(ours) | set(theirs)):
        a, b = ours.get(layer, 0), theirs.get(layer, 0)
        if a != b:
            log(f"  {layer}: utils/flops {a}, weights' shapes {b}, "
                f"{a - b:+d} ({100 * (a - b) / gap:.2f}% of the gap)")
    ms = MEASURED.get("graphed_ms/CDNA")
    if ms is None:
        log("share of the float32 peak: not measured (phase 11 did not "
            "run)")
        return
    for name, count in (("utils/flops", step),
                        ("the weights' shapes (3x rollout_flops)",
                         3 * forward)):
        tflops = count / (ms / 1e3) / 1e12
        log(f"phase 11's graphed CDNA step, {ms:.3f} ms: {tflops:.2f} "
            f"TFLOP/s by {name}, {100 * flops.mfu(tflops):.1f}% of the "
            f"H100's {flops.H100_F32_PEAK_TFLOPS:g} TFLOP/s float32 peak")


def data_phase(args) -> None:
    """Phase 12: the data path (see the docstring)."""
    from pivp_tpu_torch.data import build_features

    os.makedirs(args.out, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=args.out, prefix="data-")
    try:
        raw = os.path.join(tmp, "raw")
        t0 = time.perf_counter()
        nbytes = write_raw_shards(raw, args.seed)
        log(f"wrote {DATA_SHARDS} raw shards of {DATA_PER_SHARD} records "
            f"({STEPS + 1} JPEG frames of {DATA_FRAME[1]}x{DATA_FRAME[0]} "
            f"each), {nbytes / 2**20:.1f} MiB, in "
            f"{time.perf_counter() - t0:.1f} s")
        data = os.path.join(tmp, "processed")
        calls = run_etl(raw, data, "--sequences_per_file", "0")
        if calls != DATA_SHARDS:
            fail(f"the native scanner ran {calls} times for "
                 f"{DATA_SHARDS} shards")
        check_processed(data, DATA_SHARDS * DATA_PER_SHARD)
        four = os.path.join(tmp, "raw4")
        os.makedirs(four)
        for name in sorted(os.listdir(raw))[:4]:
            os.symlink(os.path.join(raw, name), os.path.join(four, name))
        run_etl(four, os.path.join(tmp, "processed4"))
        check_processed(os.path.join(tmp, "processed4"), 4)
        build_features.main(["--data_dir", data], standalone_mode=False)
        with open(os.path.join(data, "features.json")) as f:
            feats = json.load(f)
        log(f"build_features: features.json num_sequences "
            f"{feats['num_sequences']}, image_shape {feats['image_shape']}, "
            f"mean interframe motion {feats['mean_interframe_motion']:.5f}")
        if feats["num_sequences"] != DATA_SHARDS * DATA_PER_SHARD:
            fail(f"features.json counts {feats['num_sequences']} sequences")
        data_training(args, tmp, data)
        data_two_ranks(args, tmp)
        data_flops(args)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--train_steps", type=int, default=3)
    ap.add_argument("--timed_steps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "smoke"))
    ap.add_argument("--kernels_only", action="store_true",
                    help="stop after phase 3 (no JSON lines are printed)")
    ap.add_argument("--driver_only", action="store_true",
                    help="run phases 1, 2 and 11 only (no JSON lines are "
                    "printed)")
    ap.add_argument("--data_only", action="store_true",
                    help="run phases 1, 2 and 12 only (no JSON lines are "
                    "printed)")
    ap.add_argument("--bwd_x_rows", default="",
                    help="comma-separated tile heights: after phase 3, "
                    "time dX at the main shape with each")
    args = ap.parse_args()
    if args.requests < 1:
        fail("--requests must be at least 1")
    if not 2 <= args.train_steps <= 3 or args.timed_steps < 5:
        fail("--train_steps must be 2 or 3 (the second step closes the "
             "one epoch) and --timed_steps at least 5")
    phase_t0 = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal phase_t0
        now = time.perf_counter()
        log(f"phase {name}: {now - phase_t0:.1f} s")
        torch.cuda.empty_cache()
        phase_t0 = now

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a GPU")
    from pivp_tpu_torch.ops.kernels import build
    from pivp_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")                   # also turns TF32 off
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_done("1 device")

    # 2. build
    _, info = build.load(force_build=True)
    log(f"build: {info.path.name} in {info.seconds:.1f} s")
    for line in info.ptxas:
        log(f"  ptxas {line}")
    phase_done("2 build")

    if args.driver_only:
        driver_phase(args)
        phase_done("11 driver")
        log(card)
        return
    if args.data_only:
        data_phase(args)
        phase_done("12 data")
        log(card)
        return

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    kernels = ([check_local_apply(gen), check_lstm_gates(gen)]
               + check_local_apply_bwd(gen) + [check_lstm_gates_bwd(gen)])
    if args.bwd_x_rows:
        sweep_bwd_x(gen, [int(r) for r in args.bwd_x_rows.split(",")])
    phase_done("3 kernels")
    if args.kernels_only:
        log(card)
        return

    # 4. the prediction path, served
    launches = serve_phase(args, card, head_config("CDNA"), args.requests)
    for k, n in zip(kernels[:2], launches[:2]):
        k["launches"] = n
    phase_done("4 serve")

    # 5. the predict CLI path
    predict_phase(args)
    phase_done("5 predict")

    # 6. the training path
    launches = train_phase(args, card, head_config("CDNA"), (0, 6000))
    for k, n in zip(kernels[2:], launches[2:]):
        k["launches"] = n
    phase_done("6 train")

    # 7, 8. the DNA and STP heads, served and trained
    for number, head in (("7", "DNA"), ("8", "STP")):
        serve_phase(args, card, head_config(head), HEAD_REQUESTS)
        train_phase(args, card, head_config(head), (6000,))
        phase_done(f"{number} {head}")

    # 9. STP with a projection per mask, through the API (no flag of
    # train_cli or load_model selects it, as in the JAX package)
    per_mask = dataclasses.replace(head_config("STP"),
                                   stp_shared_params=False)
    serve_phase(args, card, per_mask, HEAD_REQUESTS, round_trip=False)
    train_phase(args, card, per_mask, (6000,), cli=False)
    phase_done("9 STP per-mask")

    # 10. deployment: Chainer npz -> convert -> export -> HTTP, and the
    # DNA and STP artifacts
    deploy_phase(args)
    phase_done("10 deploy")

    # 11. the training driver: K-step dispatch as a CUDA graph, exact
    # resume after a SIGTERM, lazy loading, profiling, visualization
    driver_phase(args)
    phase_done("11 driver")

    # 12. the data path: raw shards -> the ETL -> map.csv -> training in
    # a process group, and two ranks' all-reduced gradient
    data_phase(args)
    phase_done("12 data")

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "cold_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "library_cold_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in order}
                                  for d in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
