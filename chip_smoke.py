#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pivp_tpu_torch) on one NVIDIA GPU.

Drives the port's CDNA feed-self prediction path at full width (10
masks, channel plans (32,32,64,64,128,96,64) / (32,32,64,64,128,64,32),
64x64x3 frames, T=10, 2 context frames, use_state, float32, batch 32)
with random weights made from --seed, in phases:

  1. device   a CUDA device is required; prints its name and power limit
  2. build    compiles every CUDA kernel from pivp_tpu_torch/csrc
  3. kernels  each kernel against its plain PyTorch version on the card,
              at the main path's shapes, with times and bounds
  4. serve    seeded params -> save_npz -> load_model -> make_serve_fn,
              --requests requests of batch 32; the launch counters must
              show every kernel launched on that path; the rollout with
              both kernel switches off, and a small batch on the CPU,
              must agree with it
  5. predict  predict_and_render on a synthetic processed-data dir
              renders the contact-sheet GIF

Any failure exits non-zero. The last lines are a `kernels` JSON line,
the card's name and power limit, and `{"ok": true, "device": ...}`.

Usage: python3 chip_smoke.py [--seed 0] [--requests 3] [--out DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the
# float32 rate outside the tensor cores, which these kernels use.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# Main-path shapes at batch 32: the fused CDNA tap application, and the
# ConvLSTM cells of one timestep as (count, H, W, C).
BATCH = 32
LOCAL_APPLY_SHAPE = (BATCH, 64, 64, 3)
GATE_CELLS = ((3, 32, 32, 32), (3, 16, 16, 64), (1, 8, 8, 128))
GATE_LAUNCHES_PER_STEP = sum(n for n, _, _, _ in GATE_CELLS)


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


def cuda_ms(fn, iters: int = 200, warmup: int = 20,
            graph: bool = False) -> float:
    """Mean time of one call of `fn`, from CUDA events around `iters`
    back-to-back calls after `warmup` calls. Called from Python, a short
    kernel is paced by the host's launch overhead; with `graph=True` the
    `iters` calls are captured in one CUDA graph and replayed, which
    leaves the device time alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        run = g.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if graph:
        run()
    else:
        for _ in range(iters):
            run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
            plain_ms = cuda_ms(lambda: la.local_kernel_apply_plain(x, w),
                               graph=True)
            call_ms = cuda_ms(lambda: la.local_kernel_apply(x, w))
            b, h, wd, c = shape
            nbytes = (2 * b * h * wd * c + b * h * wd * k * k) * 4
            bms, by = bound_ms(nbytes, 2 * k * k * c * b * h * wd)
    log(f"local_apply {LOCAL_APPLY_SHAPE}x25 f32, device time per call "
        f"(CUDA graph): kernel {ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} us, bound {bms * 1e3:.2f} us ({by}); "
        f"kernel called from Python {call_ms * 1e3:.2f} us per call")
    return {"name": "local_kernel_apply", "route": "cuda",
            "source": "pivp_tpu_torch/csrc/local_apply.cu",
            "replaces": "pivp_tpu/ops/pallas/local_apply.py:106",
            "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def check_lstm_gates(gen: torch.Generator) -> dict:
    from pivp_tpu_torch.ops.kernels import lstm_gates as lg

    worst = 0.0
    step_ms = step_plain_ms = step_call_ms = step_bytes = step_ops = 0.0
    for n_cells, h, w, c in GATE_CELLS:
        for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
            gates = (torch.randn((BATCH, h, w, 4 * c), generator=gen,
                                 device="cuda") * 1.5).to(dtype)
            cc = torch.randn((BATCH, h, w, c), generator=gen,
                             device="cuda").to(dtype)
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
                step_ms += n_cells * cuda_ms(
                    lambda: lg.fused_lstm_gates(gates, cc, 1.0), graph=True)
                step_plain_ms += n_cells * cuda_ms(
                    lambda: lg.fused_lstm_gates_plain(gates, cc, 1.0),
                    graph=True)
                step_call_ms += n_cells * cuda_ms(
                    lambda: lg.fused_lstm_gates(gates, cc, 1.0))
                elems = BATCH * h * w * c
                step_bytes += n_cells * 7 * elems * 4
                # Per element: 3 sigmoids (negate, exp, add, divide), 2
                # tanh, the forget-bias add and 4 multiply/adds.
                step_ops += n_cells * 19 * elems
    bms, by = bound_ms(step_bytes, step_ops)
    log(f"lstm_gates, the {GATE_LAUNCHES_PER_STEP} cells of one timestep "
        f"at b{BATCH} f32, device time (CUDA graph): kernel "
        f"{step_ms * 1e3:.2f} us, plain {step_plain_ms * 1e3:.2f} us, bound "
        f"{bms * 1e3:.2f} us ({by}); kernel called from Python "
        f"{step_call_ms * 1e3:.2f} us")
    return {"name": "fused_lstm_gates", "route": "cuda",
            "source": "pivp_tpu_torch/csrc/lstm_gates.cu",
            "replaces": "pivp_tpu/ops/pallas/lstm_gates.py:107",
            "max_abs_err": worst, "ms": step_ms, "plain_ms": step_plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def profile_request(serve, request, trace_path: str) -> None:
    """One served request under torch.profiler: the device's busy share
    of the request's wall time and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(*request)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(trace_path)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"profiled request: wall {wall_us / 1e3:.3f} ms under the "
        f"profiler, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}%), {sum(e.count for e in kernels)}"
        f" kernel launches; trace {trace_path}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total:10.1f} us  x{e.count:<4d} "
            f"{e.key[:100]}")


def rollout_flops(params, cfg, batch: int) -> float:
    """Operations (2 per multiply-add) of the convs, deconvs and dense
    layers of one feed-self rollout of T-1 steps, from the weight
    shapes: a conv is counted over its output grid, a transposed conv
    over its input grid, a dense layer once per sample."""
    h, w = cfg.image_height, cfg.image_width
    r0, r1, r2, r3 = (h * w, h * w // 4, h * w // 16, h * w // 64)
    grid = {"enc0": r1, "enc1": r2, "enc2": r3, "enc3": r3, "enc4": r3,
            "enc5": r2, "enc6": r1, "lstm1": r1, "lstm2": r1, "lstm3": r2,
            "lstm4": r2, "lstm5": r3, "lstm6": r2, "lstm7": r1,
            "masks": r0, "head/enc7": r0, "state_pred": 1,
            "head/cdna_kerns": 1}
    from pivp_tpu_torch.utils import weights

    per_step = sum(2 * batch * grid[k[:-2]] * v.numel()
                   for k, v in weights.flatten(params).items()
                   if k.endswith("/w"))
    return per_step * (cfg.sequence_length - 1)


def reset_counters() -> None:
    from pivp_tpu_torch.ops.kernels import local_apply, lstm_gates

    local_apply.local_kernel_apply.launches = 0
    lstm_gates.fused_lstm_gates.launches = 0


def read_counters():
    from pivp_tpu_torch.ops.kernels import local_apply, lstm_gates

    return (local_apply.local_kernel_apply.launches,
            lstm_gates.fused_lstm_gates.launches)


def check_counters(what: str, rollouts: int, steps: int) -> tuple:
    la, lg = read_counters()
    want = (rollouts * steps, rollouts * steps * GATE_LAUNCHES_PER_STEP)
    log(f"{what}: launches local_kernel_apply {la}, fused_lstm_gates {lg} "
        f"(expected {want[0]}, {want[1]})")
    if (la, lg) != want:
        fail(f"{what}: launch counts {(la, lg)} != {want}")
    return la, lg


def serve_phase(args, card: str):
    from pivp_tpu_torch.config import ModelConfig
    from pivp_tpu_torch.data import synthetic
    from pivp_tpu_torch.inference import export
    from pivp_tpu_torch.inference import predict as predict_lib
    from pivp_tpu_torch.models import predictor
    from pivp_tpu_torch.ops import transforms
    from pivp_tpu_torch.utils import checkpoint

    cfg = ModelConfig()
    t, ctx = cfg.sequence_length, cfg.context_frames
    params = predictor.init_params(torch.Generator().manual_seed(args.seed),
                                   cfg, device="cuda")
    run_dir = os.path.join(args.out, "models", args.run_name)
    os.makedirs(run_dir, exist_ok=True)
    ckpt = os.path.join(run_dir, "smoke-params.npz")
    checkpoint.save_npz(ckpt, params)
    cfg, params = predict_lib.load_model(
        ckpt, "CDNA", cfg.num_masks, ctx, cfg.use_state,
        image_height=cfg.image_height, image_width=cfg.image_width,
        sequence_length=t, device="cuda")
    if not (cfg.use_kernel and cfg.use_kernel_gates):
        fail("the kernel switches are off by default")

    images, actions, states = synthetic.generate_sequences(
        BATCH, t, cfg.image_height, cfg.image_width, seed=args.seed)
    images = torch.as_tensor(images.swapaxes(0, 1).copy(), device="cuda")
    actions = torch.as_tensor(actions.swapaxes(0, 1).copy(), device="cuda")
    states = torch.as_tensor(states.swapaxes(0, 1).copy(), device="cuda")
    serve = export.make_serve_fn(params, cfg)
    request = (images[:ctx], actions[:t - 1], states[0])
    serve(*request)                                   # warm-up
    torch.cuda.synchronize()

    reset_counters()
    times = []
    for _ in range(args.requests):
        t0 = time.perf_counter()
        frames = serve(*request)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = check_counters(f"serve ({args.requests} requests)",
                              args.requests, t - 1)
    profile_request(serve, request, os.path.join(args.out, "serve_trace.json"))
    if frames.shape != (t - ctx, BATCH, cfg.image_height, cfg.image_width,
                        cfg.color_channels) or frames.dtype != torch.uint8:
        fail(f"serve output {tuple(frames.shape)} {frames.dtype}")
    ms = [x * 1e3 for x in times]
    n_frames = (t - ctx) * BATCH
    log(f"serve b{BATCH}: ms/request {ms} (median {np.median(ms):.3f}); "
        f"predicted frames/s {n_frames / np.median(times):.1f} on {card}")
    flops = rollout_flops(params, cfg, BATCH)
    log(f"serve b{BATCH}: convs, deconvs and dense layers "
        f"{flops / 1e9:.1f} GFLOP per request, "
        f"{flops / PEAK_F32_OPS_PER_S * 1e3:.2f} ms at the float32 peak")

    # The same rollout with both kernel switches off, on the same card.
    out_k = predictor.predict(params, cfg, images, actions, states)
    plain_cfg = dataclasses.replace(cfg, use_kernel=False,
                                    use_kernel_gates=False)
    out_p = predictor.predict(params, plain_cfg, images, actions, states)
    torch.cuda.synchronize()
    gen_k, gen_p = out_k["gen_images"], out_p["gen_images"]
    if not bool(torch.isfinite(gen_k).all()):
        fail("non-finite predicted frames")
    d_img = max_err(gen_k, gen_p)
    d_psnr = float((out_k["psnrs"] - out_p["psnrs"]).abs().max())
    log(f"kernels vs plain ops, b{BATCH} rollout: max|dframe| {d_img:.3e} "
        f"(tol 1e-4), max|dPSNR| {d_psnr:.3e} dB (tol 0.01); PSNR "
        f"{float(out_k['psnr_all']):.4f} dB summed, SSIM "
        f"{float(out_k['ssim']):.5f}")
    if not (d_img <= 1e-4 and d_psnr <= 0.01):
        fail("kernel rollout disagrees with the plain-op rollout")
    d_serve = int((frames.int() - transforms.quantize_frames_u8(
        gen_k[ctx - 1:]).int()).abs().max())
    if d_serve > 1:
        fail(f"served frames differ from the predict rollout by {d_serve}")

    # A small batch on the CPU, where the wrappers take the plain path.
    cpu = lambda x: x[:, :2].cpu()  # noqa: E731
    cpu_params = predictor.map_params(lambda p: p.cpu(), params)
    out_c = predictor.predict(cpu_params, cfg, cpu(images), cpu(actions),
                              cpu(states))
    d_cpu = max_err(gen_k[:, :2].cpu(), out_c["gen_images"])
    log(f"card vs CPU, 2 sequences: max|dframe| {d_cpu:.3e} (tol 1e-4)")
    if not d_cpu <= 1e-4:
        fail("the card's rollout disagrees with the CPU's")
    return launches


def predict_phase(args) -> None:
    from pivp_tpu_torch.data import synthetic
    from pivp_tpu_torch.inference import predict as predict_lib

    data_dir = os.path.join(args.out, "data")
    synthetic.write_processed_dir(data_dir, 2, 10, 64, 64, seed=args.seed)
    reset_counters()
    path = predict_lib.predict_and_render(
        args.run_name, "smoke-params.npz", 0,
        models_dir=os.path.join(args.out, "models"), data_dir=data_dir,
        time_step=8, downscale_factor=0.25, device="cuda")
    torch.cuda.synchronize()
    check_counters("predict_and_render", 1, 9)
    if not (os.path.exists(path) and os.path.getsize(path) > 0):
        fail(f"no prediction image at {path}")
    log(f"predict_and_render wrote {path} ({os.path.getsize(path)} bytes)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "smoke"))
    args = ap.parse_args()
    args.run_name = "00000000-000000-CDNA-32"
    if args.requests < 1:
        fail("--requests must be at least 1")

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a GPU")
    from pivp_tpu_torch.ops.kernels import build
    from pivp_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")                   # also turns TF32 off
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    _, info = build.load(force_build=True)
    log(f"build: {info.path.name} in {info.seconds:.1f} s")
    for line in info.ptxas:
        log(f"  ptxas {line}")

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    kernels = [check_local_apply(gen), check_lstm_gates(gen)]

    # 4. the main path, served
    launches = serve_phase(args, card)
    for k, n in zip(kernels, launches):
        k["launches"] = n

    # 5. the predict CLI path
    predict_phase(args)

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in order}
                                  for d in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
