"""Multi-process runtime initialization and topology helpers.

Every process runs the same program; ``torch.distributed`` joins them into
one gloo process group, on CPU and CUDA hosts alike: the only collective,
:func:`all_sum_volume`, reduces host volumes, and gloo binds no process to
a card, so several processes may share one. Within a process, a
:class:`.mesh.DeviceMesh` spans that process's devices. The fusion runner
(``pipeline/runner.py``) stripes work units over the processes, and
:func:`all_sum_volume` sums their partial volumes once at the end.

Typical entry point:

    from cudadepthmapintegration_torch.parallel import distributed

    distributed.initialize()            # no-op in a single process
    share = distributed.host_view_slice(len(views))
    ...

Process-level failures compose with ``pipeline.runner.FaultTolerantRunner``:
a restarted process re-joins with the same rank and re-fuses only its
unfinished units (idempotent sum).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize",
    "is_multihost",
    "host_view_slice",
    "all_sum_volume",
    "topology_summary",
]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the process group when running under a multi-process launcher.

    The coordinator is ``coordinator_address`` ("host:port"), else the
    ``COORDINATOR_ADDRESS`` environment variable (as the JAX package reads
    it), else ``MASTER_ADDR``/``MASTER_PORT`` as a torch launcher sets them.
    The world size and rank come from the arguments, else ``WORLD_SIZE``
    and ``RANK``. A no-op when no coordinator is named, when the world has
    one process, or when the group is already up.
    """
    if dist.is_initialized():
        return
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if not addr:
        return
    world = num_processes if num_processes is not None else os.environ.get("WORLD_SIZE")
    rank = process_id if process_id is not None else os.environ.get("RANK")
    if world is None or rank is None:
        raise ValueError(
            f"coordinator {addr} given, but no world size and rank "
            "(pass num_processes/process_id or set WORLD_SIZE and RANK)"
        )
    if int(world) == 1:
        return
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{addr}",
        world_size=int(world),
        rank=int(rank),
    )


def _rank_and_size() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_multihost() -> bool:
    return _rank_and_size()[1] > 1


def host_view_slice(n_views: int) -> range:
    """This process's contiguous share of a global view list (for
    per-process disk reads; fusion order does not matter)."""
    p, n = _rank_and_size()
    return range((n_views * p) // n, (n_views * (p + 1)) // n)


def all_sum_volume(volume) -> np.ndarray:
    """Sum per-process partial volumes across all processes (replica mode).

    Every process fuses only its striped units into a full-size volume
    replica, and the true fusion is the elementwise sum of all replicas
    (order-independent addition, ``CudaReconstruction.cu:211``). Every
    partial is gathered as float32 and the sum runs in rank order on the
    host, as the JAX package's does. Single process: identity.
    """
    if not is_multihost():
        return np.asarray(volume)
    local = torch.as_tensor(np.asarray(volume, np.float32))
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    return np.stack([p.numpy() for p in parts]).sum(axis=0)


def topology_summary() -> dict:
    rank, size = _rank_and_size()
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "process_index": rank,
        "process_count": size,
        "local_devices": n_cuda or 1,
        "global_devices": (n_cuda or 1) * size,
        "platform": "gpu" if n_cuda else "cpu",
    }
