"""Process-group bring-up, device meshes and the collectives of the parallel
modules over ``torch.distributed`` (port of ``parallel/multihost.py``).

A JAX mesh slot is a rank here: one process per rank, each on its own card
(NCCL) or on the CPU (gloo).  Call :func:`initialize` once per process
before any collective; the meshes then span every rank.  The parallel
modules issue their collectives through the wrappers below, which count
each one by kind and payload in :data:`COMM`, so a caller can count what a
call sent (``COMM.clear()`` before it, read after).
"""
from __future__ import annotations

import collections
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# Collectives issued by this process: (kind, payload bytes) -> count.
COMM: collections.Counter = collections.Counter()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the process group: a no-op for one process with no arguments.

    ``coordinator_address``: ``host:port`` (TCP) or any ``init_method`` URL
    (``tcp://...``, ``file://...``).  The backend is ``nccl`` when CUDA is
    present (the process takes the card ``process_id % device_count``) and
    ``gloo`` only without it."""
    if coordinator_address is None and num_processes in (None, 1):
        return
    if coordinator_address is None or num_processes is None or (
            process_id is None):
        raise ValueError("initialize needs coordinator_address, "
                         "num_processes and process_id together")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def _device_type() -> str:
    """``cuda`` under NCCL, ``cpu`` under gloo: where a rank's tensors live."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _need_group():
    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost.initialize() "
                           "first")


def global_mesh(axis: str = "lm"):
    """1-D mesh over every rank: the landmark-shard axis of distributed
    BA."""
    _need_group()
    return init_device_mesh(_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def grid_mesh(data: int, model: int, axes: Sequence[str] = ("data", "lm")):
    """2-D mesh: sequences over ``data``, landmark blocks over ``model``."""
    _need_group()
    return init_device_mesh(_device_type(), (data, model),
                            mesh_dim_names=tuple(axes))


def as_group(mesh):
    """The process group of a 1-D device mesh, a group itself, or None (the
    default group)."""
    if mesh is None or isinstance(mesh, dist.ProcessGroup):
        return mesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh: expected a DeviceMesh or a ProcessGroup, "
                        f"got {type(mesh).__name__}")
    if mesh.ndim != 1:
        raise ValueError(f"expected a 1-D mesh, got {mesh.ndim} dimensions")
    return mesh.get_group()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the group's ranks, in place."""
    COMM["all_reduce", _nbytes(t)] += 1
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (all of one shape), in rank order."""
    COMM["all_gather", _nbytes(t)] += 1
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def shift_right(t: torch.Tensor, out: torch.Tensor, group=None) -> bool:
    """Send ``t`` to the next rank and receive the previous rank's into
    ``out``: one send and one receive per rank at most (the first rank
    receives nothing, the last sends nothing).  True when ``out`` was
    filled."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    pg = group if group is not None else dist.group.WORLD
    ops = []
    if rank + 1 < world:
        COMM["send", _nbytes(t)] += 1
        ops.append(dist.P2POp(dist.isend, t.contiguous(),
                              dist.get_global_rank(pg, rank + 1), group))
    if rank > 0:
        COMM["recv", _nbytes(out)] += 1
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(pg, rank - 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return rank > 0
