"""Multi-process data-parallel scaffolding on torch.distributed.

Counterpart of `pivp_tpu/parallel/multihost.py`. A TPU pod runs one
process per host over a global device mesh; torch runs one process per
GPU, joined in a process group. This module gives the training pipeline
the same pod story:

  * `initialize()`: `torch.distributed.init_process_group`, NCCL for
    CUDA and gloo for the CPU unless the caller names a backend (a
    no-op without flags and without WORLD_SIZE/RANK in the environment,
    so every entry point can call it unconditionally);
  * `shard_rows()`: contiguous per-rank split of the map.csv sequence
    list, so each rank reads only its own slice of the data set;
  * `HostShardedBatcher`: per-rank epoch batcher of the local rows of a
    global batch, epoch-synchronized across ranks by construction (same
    seed schedule, rank-disjoint data);
  * `local_columns()`: a rank's share of a global batch (its own
    columns), what JAX's `make_global_batch` builds a global array
    from;
  * `agree_string()` / `agree_flag()`: rank 0's string, and the OR of a
    flag, on every rank.

Composition contract: the global batch of size B is the concatenation,
in rank order, of the ranks' batches of size B/world; each rank shuffles
its own row shard. Step metrics are global-batch means because the train
step all-reduces them with the gradients.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pivp_tpu_torch.data import dataset as dataset_lib


def _backend_for(device: str) -> str:
    """NCCL for CUDA, gloo for the CPU. Each rank of a CUDA group runs
    on a GPU of its own, on whichever host; ranks that share a GPU
    (which NCCL refuses) pass `backend="gloo"` to `initialize`."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda",
               backend: Optional[str] = None) -> bool:
    """Join (or create) the process group when running multi-process.

    `coordinator_address` is rank 0's host:port (a TCP rendezvous);
    `num_processes` and `process_id` are the world size and this rank.
    Without them, the group is formed from the environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them)
    when WORLD_SIZE and RANK are set, and otherwise nothing happens: the
    counterpart of JAX's cluster auto-detection. `backend` None picks
    NCCL for a CUDA `device` and gloo for the CPU. On CUDA this selects
    the rank's GPU (`rank_device`).
    Returns True if a process group is (now) initialized."""
    if dist.is_initialized():
        return True
    env = coordinator_address is None and num_processes is None
    if env:
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            return False
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs --num_processes and "
                         "--process_id with --coordinator_address")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} not in [0, "
                         f"{num_processes})")
    backend = backend or _backend_for(device)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device, process_id))
    dist.init_process_group(
        backend,
        init_method="env://" if env else f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


def rank_device(device: str = "cuda",
                rank: Optional[int] = None) -> torch.device:
    """This rank's device: for CUDA the GPU of its local rank
    (LOCAL_RANK, else the rank) modulo the visible GPUs; the CPU as it
    is."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if rank is None:
        rank = process_info()[0]
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This rank's place in the data-parallel process group that a train
    step all-reduces over (`group` None: the default group)."""
    rank: int
    world: int
    group: Optional[object] = None

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def data_parallel() -> Optional[DataParallel]:
    """The default process group as a DataParallel, or None without
    one."""
    if not dist.is_initialized():
        return None
    return DataParallel(dist.get_rank(), dist.get_world_size())


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _comm_device() -> torch.device:
    """Where the group's collectives take their tensors: the rank's GPU
    for NCCL, the CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def agree_string(s: str, max_len: int = 128) -> str:
    """Every rank adopts rank 0's value of a short string.

    Used for the timestamped run name: ranks can cross a second boundary
    during startup and disagree on `time.strftime`, but every rank must
    address the same run directory. Returns `s` without a group."""
    if process_info()[1] == 1:
        return s
    raw = s.encode()
    if len(raw) > max_len:
        raise ValueError(f"string longer than {max_len} bytes: {s!r}")
    buf = torch.zeros(max_len, dtype=torch.uint8)
    buf[:len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    buf = buf.to(_comm_device())
    dist.broadcast(buf, src=0)
    return bytes(buf.cpu().numpy()).rstrip(b"\x00").decode()


def agree_flag(flag: bool) -> bool:
    """Collective OR of a per-rank boolean (an all-reduce MAX).

    Used at dispatch boundaries so a preemption signal (SIGTERM) that
    reached only some ranks still stops every rank at the same step.
    Returns `flag` without a group."""
    if process_info()[1] == 1:
        return flag
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def gather_columns(t: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """The ranks' tensors (equal shapes) concatenated along `axis` in
    rank order, on every rank; `t` itself without a group."""
    world = process_info()[1]
    if world == 1:
        return t
    src = t.to(_comm_device()).contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=axis).to(t.device)


def shard_rows(n_rows: int, process_index: int,
               process_count: int) -> range:
    """Contiguous per-rank row assignment covering [0, n_rows) exactly
    once across ranks; remainders go to the leading ranks."""
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} not in "
                         f"[0, {process_count})")
    base, rem = divmod(n_rows, process_count)
    start = process_index * base + min(process_index, rem)
    count = base + (1 if process_index < rem else 0)
    return range(start, start + count)


def local_batch_size(global_batch: int, process_count: int) -> int:
    if global_batch % process_count:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{process_count} processes")
    return global_batch // process_count


class HostShardedBatcher:
    """Per-rank view of a globally batch_size-B stream.

    Each rank owns `shard_rows(n, rank, world)` of the data set and draws
    epoch-shuffled local batches of B/world rows; their concatenation
    over ranks (in rank order) is the global batch. Requires equal
    shards (n_rows % world == 0, enforced): epoch boundaries are then
    synchronized across ranks by construction, which the loop's
    collective validation sweeps and checkpoint epochs depend on.
    Callers with a ragged row count trim it first (the training loop
    does)."""

    def __init__(self, arrays, global_batch: int, seed: int,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        if process_index is None or process_count is None:
            process_index, process_count = process_info()
        self.process_index = process_index
        self.process_count = process_count
        n = arrays[0].shape[0]
        if n % process_count:
            raise ValueError(
                f"{n} rows do not split into equal shards over "
                f"{process_count} processes; trim to a multiple first "
                f"(unequal shards would desynchronize epoch boundaries "
                f"across ranks)")
        rows = shard_rows(n, process_index, process_count)
        local = tuple(a[rows.start:rows.stop] for a in arrays)
        # A distinct seed per rank, as the JAX package seeds its hosts.
        self.local = dataset_lib.EpochBatcher(
            local, local_batch_size(global_batch, process_count),
            seed=seed + process_index)

    def next(self):
        return self.local.next()

    def next_indices(self) -> np.ndarray:
        """Local-shard sequence indices of one batch: the assembler
        (data/assembler.py) gathers them from `self.arrays`."""
        return self.local.next_indices()

    def seek(self, num_batches: int) -> None:
        """Fast-forward this rank's shard stream by `num_batches` global
        batches (deterministic resume; every rank seeks the same count,
        so the epoch schedules stay in lockstep)."""
        self.local.seek(num_batches)

    @property
    def arrays(self):
        """This rank's local (images, actions, states) row shard."""
        return self.local.arrays

    @property
    def epoch(self) -> int:
        return self.local.epoch

    @property
    def is_new_epoch(self) -> bool:
        return self.local.is_new_epoch


def local_columns(batch, global_batch: int, batch_axis: int = 1,
                  process_index: Optional[int] = None,
                  process_count: Optional[int] = None):
    """This rank's columns [rank*B/world, (rank+1)*B/world) of each
    array of a global batch (axis `batch_axis`)."""
    if process_index is None or process_count is None:
        process_index, process_count = process_info()
    lbs = local_batch_size(global_batch, process_count)
    cols = slice(process_index * lbs, (process_index + 1) * lbs)
    index = (slice(None),) * batch_axis + (cols,)
    return tuple(a[index] for a in batch)

