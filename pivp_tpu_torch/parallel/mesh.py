"""Data-parallel layout over a torch.distributed process group.

Counterpart of `pivp_tpu/parallel/mesh.py`. The JAX package builds a
`jax.sharding.Mesh` of the visible devices with a `data` axis for the
batch and an optional `model` axis for spatial (image-height)
parallelism; XLA places the gradient all-reduce. torch runs one process
per GPU, so the port's "mesh" is the process group: each rank holds the
whole model and its own columns of the global batch, and the train step
all-reduces the gradients (parallel/train_step.py).

`--num_devices N` of train_cli maps onto it so: 0 (the default) means
every rank of the world; N > 0 must be the world size, since a rank
cannot sit idle while the others train, and the data-parallel degree
that `auto_num_devices` gives for the batch must be the world size too.
Anything else raises (`data_parallel_size`). Spatial parallelism
(`--spatial_parallel > 1`) is not ported yet: it raises.
"""

from __future__ import annotations

from typing import Optional

# Where spatial parallelism is queued.
SPATIAL_ROADMAP = ("ROADMAP.md, 'Modules to port', item 7: spatial "
                   "(image-height) parallelism")


def auto_num_devices(batch_size: int, num_devices: int = 0,
                     world_size: Optional[int] = None) -> int:
    """Largest device count <= the world's ranks (or the requested
    devices) that evenly divides the batch, with the JAX package's
    arithmetic. `world_size` defaults to this process group's size (1
    without one)."""
    if world_size is None:
        from pivp_tpu_torch.parallel import multihost

        world_size = multihost.process_info()[1]
    available = num_devices or world_size
    n = min(available, batch_size)
    while n > 1 and batch_size % n:
        n -= 1
    return max(n, 1)


def data_parallel_size(batch_size: int, num_devices: int,
                       world_size: int) -> int:
    """The data-parallel degree of a run: `auto_num_devices` over the
    world, which must be the world size itself (one process per GPU,
    every rank training). Raises ValueError otherwise."""
    if num_devices < 0:
        raise ValueError(f"num_devices must be >= 0, got {num_devices}")
    if num_devices and num_devices != world_size:
        raise ValueError(
            f"--num_devices {num_devices} with {world_size} process(es): "
            f"the port runs one process per GPU and trains on every rank "
            f"of the process group, so launch {num_devices} processes "
            f"(--num_processes) or pass --num_devices 0")
    n = auto_num_devices(batch_size, num_devices, world_size)
    if n != world_size:
        raise ValueError(
            f"batch {batch_size} does not split over {world_size} ranks "
            f"(the largest divisor within reach is {n}): pick a batch "
            f"size that the world size divides")
    return n


def check_spatial_parallel(spatial_parallel: int) -> None:
    """Raise for spatial parallelism, which the port does not have."""
    if spatial_parallel < 1:
        raise ValueError(f"spatial_parallel must be >= 1, got "
                         f"{spatial_parallel}")
    if spatial_parallel > 1:
        raise NotImplementedError(
            f"--spatial_parallel {spatial_parallel}: spatial parallelism "
            f"is not ported yet (it needs a halo exchange for every conv, "
            f"deconv and local-apply and a LayerNorm reduced across "
            f"shards); see {SPATIAL_ROADMAP}")
