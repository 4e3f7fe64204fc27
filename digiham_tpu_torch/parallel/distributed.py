"""Multi-process scale-out: process bring-up and process-sharded channel
banks (port of ``digiham_tpu/parallel/distributed.py``).

The reference's only multi-process story is Unix pipes on one machine.
Here every process ingests its local channels' sample streams and joins
one ``torch.distributed`` job; the (channel, time) mesh then spans every
process's devices, channel shards pinned to the process that ingests their
rows, so samples never cross between processes and only the halo hops,
the carry ring and the sum over ``time`` do. The backend follows the
device the caller names: NCCL for CUDA devices, gloo for the CPU.
"""
from __future__ import annotations

import torch

from .sharded import LocalRows, Mesh, Slot, row_bounds


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device=None) -> None:
    """Join (or start, as process 0) a ``torch.distributed`` job.

    coordinator: ``host:port`` of process 0's TCP store (``localhost:29500``
    on one machine). ``device``: the kind of device the processes shard
    over, ``None`` for the card: NCCL for CUDA, gloo for ``"cpu"``. Each
    process then sets its current CUDA device to its own when it has
    several."""
    import torch.distributed as dist

    from .. import resolve_device

    kind = resolve_device(device).type
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(kind)
    if backend is None:
        raise ValueError(f"no torch.distributed backend for {kind} devices")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def local_devices(device=None) -> list:
    """This process's devices: every visible card for CUDA (``None``), one
    CPU slot per ``device="cpu"`` or ``device=["cpu"] * 4`` as given."""
    from .. import resolve_device

    if isinstance(device, (list, tuple)):
        return [torch.device(d) for d in device]
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def global_channel_mesh(n_time_shards: int = 1, devices=None) -> Mesh:
    """A (channel, time) mesh over every process's devices, host-major:
    the slots of process 0 come first, so each process's channel shards
    map to its own devices. ``devices``: this process's devices (see
    :func:`local_devices`; every process must give the same count). A
    channel row whose slots span several processes gets a group of its
    ranks for the sum over ``time`` (every process creates every group, in
    the same order, as ``new_group`` requires)."""
    import torch.distributed as dist

    local = local_devices(devices)
    world, rank = dist.get_world_size(), dist.get_rank()
    counts = [None] * world
    dist.all_gather_object(counts, len(local))
    if len(set(counts)) != 1:
        raise ValueError(f"processes hold different device counts {counts}")
    n = counts[0] * world
    if n % n_time_shards:
        raise ValueError(f"{n} devices not divisible by {n_time_shards} "
                         f"time shards")
    flat = [Slot(local[k % counts[0]] if k // counts[0] == rank
                 else torch.device("meta"), k // counts[0])
            for k in range(n)]
    n_c = n // n_time_shards
    slots = [flat[i * n_time_shards:(i + 1) * n_time_shards]
             for i in range(n_c)]
    groups = {}
    for i, row in enumerate(slots):
        ranks = sorted({s.rank for s in row})
        if len(ranks) > 1:
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[i] = group
    return Mesh(slots, rank=rank, row_groups=groups)


def local_channel_slice(total_channels: int) -> slice:
    """Which rows of the global [channels, ...] arrays this process feeds."""
    import torch.distributed as dist

    n_proc, pid = dist.get_world_size(), dist.get_rank()
    per = total_channels // n_proc
    start = pid * per
    end = total_channels if pid == n_proc - 1 else start + per
    return slice(start, end)


def make_global_array(local_block, mesh: Mesh, spec=None) -> LocalRows:
    """This process's rows of a global array, with their global slice: the
    rows :func:`local_channel_slice` gives, ``local_block`` holding them.
    The sharded steps take it where one process takes the whole array.
    Raises when the global rows do not divide over ``mesh``'s channel axis;
    ``spec`` (the JAX partition spec), when given, must shard rows over
    ``channel``."""
    import torch.distributed as dist

    if spec is not None and tuple(spec)[:1] != ("channel",):
        raise ValueError(f"rows shard over 'channel', not {spec}")
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, int(local_block.shape[0]))
    start = sum(counts[:dist.get_rank()])
    rows = slice(start, start + counts[dist.get_rank()])
    shape = (sum(counts),) + tuple(local_block.shape[1:])
    row_bounds(mesh, shape[0])
    return LocalRows(local_block, rows, shape)
