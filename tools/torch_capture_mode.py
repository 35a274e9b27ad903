#!/usr/bin/env python3
"""Whether the port's train step can be captured as a CUDA graph while
another thread makes the CUDA calls of the training loop's prefetch
thread (pinned allocations and event queries, the host allocator's).

Captures a CDNA step at 32x32, T=5, b2 (`train_step.make_train_multi`,
2 steps) --tries times beside such a thread, with the capture mode
forced to the one given, and prints each try. In CUDA's global mode the
thread's calls invalidate the capture; in thread-local mode, which
`train_step.CapturedStep` uses, they do not. A failed capture can leave
the device's stream state behind, so run each mode in its own process.

Usage: python3 tools/torch_capture_mode.py global|thread_local [--tries 3]
Needs a GPU.
"""

import argparse
import os
import sys
import threading

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pivp_tpu_torch.config import ModelConfig  # noqa: E402
from pivp_tpu_torch.data import synthetic  # noqa: E402
from pivp_tpu_torch.models import predictor  # noqa: E402
from pivp_tpu_torch.parallel import train_step as ts  # noqa: E402


def force_capture_mode(mode: str) -> None:
    graph = torch.cuda.graph

    class forced(graph):
        def __init__(self, cuda_graph, **kwargs):
            kwargs["capture_error_mode"] = mode
            super().__init__(cuda_graph, **kwargs)

    torch.cuda.graph = forced


def batches(cfg: ModelConfig, k: int = 2, batch: int = 2) -> tuple:
    imgs, acts, stas = synthetic.generate_sequences(
        k * batch, cfg.sequence_length, cfg.image_height, cfg.image_width,
        seed=1)
    stacked = tuple(np.stack([a[i * batch:(i + 1) * batch].swapaxes(0, 1)
                              for i in range(k)])
                    for a in (imgs, acts, stas))
    u8 = np.clip(stacked[0] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return (u8,) + stacked[1:]


def try_capture(cfg: ModelConfig, payload: tuple) -> tuple:
    """One capture and its replays beside the querying thread: (what
    happened, the thread's rounds, the thread's errors)."""
    params = predictor.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cuda")
    state = ts.create_train_state(params, ts.make_optimizer(1e-3))
    stop, errors, rounds = threading.Event(), [], [0]
    event = torch.cuda.Event()
    event.record(torch.cuda.Stream())

    def run():
        try:
            while not stop.is_set():
                torch.empty(1 << 16, dtype=torch.uint8, pin_memory=True)
                event.query()
                rounds[0] += 1
        except Exception as e:  # printed with the try
            errors.append(repr(e)[:160])

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        _, metrics = ts.make_train_multi(cfg)(state, payload, 0, 0)
        torch.cuda.synchronize()
        result = f"captured, losses {metrics['loss'].tolist()}"
    except Exception as e:
        result = f"failed: {repr(e)[:240]}"
    finally:
        stop.set()
        thread.join()
    return result, rounds[0], errors


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("mode", choices=["global", "thread_local"])
    parser.add_argument("--tries", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    force_capture_mode(args.mode)
    cfg = ModelConfig(image_height=32, image_width=32, sequence_length=5)
    payload = batches(cfg)
    captured = 0
    for i in range(args.tries):
        result, rounds, errors = try_capture(cfg, payload)
        print(f"mode={args.mode} try {i}: {result}; thread rounds "
              f"{rounds}, errors {errors}", flush=True)
        if not result.startswith("captured"):
            break
        captured += 1
    print(f"mode={args.mode}: {captured} of {args.tries} captures "
          f"succeeded")
    return 0


if __name__ == "__main__":
    sys.exit(main())
