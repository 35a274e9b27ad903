"""Graceful preemption of the training loop.

The port's own copy of `pivp_tpu/training/preemption.py`. A cloud GPU
host gets SIGTERM before a maintenance event or a spot reclaim. The
training loop installs a handler that only sets a flag; the loop checks
it at every dispatch boundary, writes a full checkpoint and returns, so
that `--checkpointer torch` resumes from the exact optimizer step on the
next launch with the same `--run_name`.

A handler can only be installed from the main thread (a CPython rule);
elsewhere `install` does nothing, and tests set the flag with `request`.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Callable, Iterable

logger = logging.getLogger(__name__)

_EVENT = threading.Event()

DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


def request() -> None:
    """Ask the running training loop to checkpoint and exit at the next
    dispatch boundary (what the signal handler does)."""
    _EVENT.set()


def requested() -> bool:
    return _EVENT.is_set()


def clear() -> None:
    _EVENT.clear()


def install(signals: Iterable[int] = DEFAULT_SIGNALS
            ) -> Callable[[], None]:
    """Install set-the-flag handlers; returns a restore() that puts the
    previous handlers back. Off the main thread it installs nothing and
    returns a restore() that does nothing."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None

    # A flag left set by an earlier preempted run in this process would
    # stop the new run after one dispatch. Before install these signals
    # would have ended the process, so clearing here loses nothing.
    _EVENT.clear()

    previous = {}

    def handler(signum, frame):
        del frame
        logger.warning(
            "Received signal %d: will checkpoint and exit at the next "
            "dispatch boundary", signum)
        _EVENT.set()

    for sig in signals:
        previous[sig] = signal.signal(sig, handler)

    def restore() -> None:
        for sig, prev in previous.items():
            signal.signal(sig, prev)

    return restore
