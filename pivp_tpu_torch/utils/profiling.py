"""Timing and tracing of the training loop.

Counterpart of `pivp_tpu/utils/profiling.py`: a step timer with a
percentile summary (device time between two CUDA events on the card,
the host clock on the CPU), a `torch.profiler` trace of a whole run for
`--profile_dir`, and a NaN-debug switch (the counterpart of the
reference's `chainer.set_debug(True)` under --debug).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


class StepTimer:
    """Seconds of each timed dispatch, with a percentile summary.

    On a CUDA device each dispatch is bracketed by two CUDA events and
    read at `summary()`, so timing adds no host sync to the loop; on the
    CPU it reads the host clock (the work is done when the call
    returns)."""

    def __init__(self, device="cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self.times: List[float] = []
        self._pending: List[tuple] = []
        self._t0 = None

    def start(self) -> None:
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pending.append((self._t0, end))
        else:
            self.times.append(time.perf_counter() - self._t0)

    def _collect(self) -> None:
        for t0, t1 in self._pending:
            t1.synchronize()
            self.times.append(t0.elapsed_time(t1) / 1e3)
        self._pending.clear()

    def clear(self) -> None:
        self.times.clear()
        self._pending.clear()

    def summary(self) -> Dict[str, float]:
        self._collect()
        arr = np.asarray(self.times)
        if arr.size == 0:
            return {}
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "min_s": float(arr.min()),
            "steps": int(arr.size),
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A `torch.profiler` trace of everything inside the block (CPU ops,
    and the CUDA kernels when a GPU is present), written to `log_dir` as
    a TensorBoard-readable `*.pt.trace.json` when the block ends. Does
    nothing when `log_dir` is empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def enable_nan_debugging() -> None:
    """Check every backward computation for NaNs and name the forward op
    that made one (expensive; debug only)."""
    torch.autograd.set_detect_anomaly(True)
