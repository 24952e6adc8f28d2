"""The data-parallel group under evo_tpu's mesh names (counterpart:
evo_tpu/parallel/mesh.py).

evo_tpu drives every device of a host from one process and shards the
blocked [nb, B, ...] arrays over a one-dimensional ``jax.sharding.Mesh``
named 'data'.  The PyTorch idiom is one process per card: the mesh here is
the default ``torch.distributed`` group (see ``distributed.py``), one rank
per card along the data axis, and a ``DataMesh`` holds what a caller needs
of it (rank, world size, the process's device).  Sharding keeps this
rank's rows of each block; the models sum their statistics over the group
themselves, where evo_tpu's GSPMD inserts the reductions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from evo_tpu_torch.parallel.distributed import (
    gather_global,
    local_rows,
    process_device,
    rank_world,
)

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The data axis: this process's ``rank`` of ``world_size`` ranks (one
    per card) and its ``device``."""

    rank: int
    world_size: int
    device: torch.device
    axis: str = DATA_AXIS


def make_mesh(device=None) -> DataMesh:
    """The data-parallel group as a ``DataMesh`` on ``device`` (None: the
    process's card, cuda:{LOCAL_RANK % device_count})."""
    rank, world = rank_world()
    return DataMesh(rank=rank, world_size=world, device=process_device(device))


def get_mesh() -> DataMesh:
    """``make_mesh()`` of the current group and card."""
    return make_mesh()


def _leaves(fn, tree):
    from evo_tpu_torch.models.base import _map_leaves

    return _map_leaves(fn, tree)


def shard_blocked(tree, mesh: DataMesh = None):
    """This rank's rows of each block of a blocked tree ([nb, B, ...]
    leaves: Data, EState) on the mesh's device; leaves of fewer dimensions
    (parameters) are moved whole."""
    mesh = mesh or get_mesh()
    return _leaves(lambda a: local_rows(torch.as_tensor(a)).to(mesh.device), tree)


def replicate(tree, mesh: DataMesh = None):
    """Every tensor of ``tree`` broadcast from rank 0, on the mesh's
    device (moved only, without a group)."""
    mesh = mesh or get_mesh()

    def bcast(a):
        t = torch.as_tensor(a).to(mesh.device)
        if mesh.world_size > 1:
            comm = t if dist.get_backend() == "nccl" else t.cpu()
            dist.broadcast(comm, src=0)
            t = comm.to(mesh.device)
        return t

    return _leaves(bcast, tree)


def pprint(*args, **kwargs):
    """Print on rank 0 only (reference parallel.py:23-42)."""
    if rank_world()[0] == 0:
        print(*args, **kwargs)


def gather_to_host(x) -> np.ndarray:
    """The full global value of ``x`` on the host of every rank (reference
    gather_from_processes, parallel.py:154-173)."""
    return gather_global(x)
