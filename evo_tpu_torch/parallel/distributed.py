"""Data parallelism over torch.distributed: one process per card.

Counterpart: evo_tpu/parallel/distributed.py.  The reference deploys as
``mpirun -n K``; evo_tpu as one JAX process per host whose global arrays
are sharded over a device mesh.  Here each process drives one card (or the
CPU) and holds only its own rows of every block, and the processes form
the default ``torch.distributed`` group:

  mpirun -n K python main.py   ->  torchrun --nproc_per_node=K main.py,
                                   each process calling init_distributed()
  Scatterv rows to ranks       ->  each process loads ONLY its rows:
                                   make_global_data(y_local, n_blocks)
  Allreduce of suff. stats     ->  the models' em_step sums its epoch's
                                   accumulators, counters and F over the
                                   ranks in one all_reduce (SUM) of a flat
                                   float64 buffer after the block loop
  rank-0 bcast of Theta^0      ->  the same seed on every rank, statistics
                                   from global sums (global_init_stats)
  Gatherv to rank 0            ->  gather_global: every rank gets the value

The global layout of a blocked tensor [nb, B, ...] is evo_tpu's: each
block's B axis is [rank 0 rows | rank 1 rows | ...], so block b of rank p
holds global rows b*B + p*B_local ... b*B + (p+1)*B_local.  Checkpoints
and gathers mean the same in both packages.  The EA draws the global
block's random numbers on every rank and keeps its own rows
(``block_rows``), so a row's draws depend on (seed, epoch, block, global
row) and not on the number of ranks.

With no group every function here is the single-process identity and the
models issue no collective.  NCCL carries the collectives on CUDA tensors;
gloo (the CPU, or several ranks sharing one card) gets them staged through
host memory.

Recipe (one process per card):

    from evo_tpu_torch import BSC, init_states
    from evo_tpu_torch.parallel import (distribute_estate, init_distributed,
                                        make_global_data, process_device)
    rank, world = init_distributed()      # reads torchrun's environment
    dev = process_device()
    data = make_global_data(y_local, n_blocks=nb, device=dev)
    cfg, estate = init_states(N=N_global, ..., n_blocks=nb, device=dev)
    estate = distribute_estate(estate)    # this rank's rows
    params = BSC(D=D, H=H, device=dev).standard_init(data, y_host=y_local)
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from evo_tpu_torch._device import resolve_device

# torchrun's environment (the counterpart of JAX_COORDINATOR_ADDRESS)
_ENV_TRIGGERS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")
INIT_TIMEOUT = datetime.timedelta(seconds=60)


def active() -> bool:
    """Whether a default process group is up."""
    return dist.is_available() and dist.is_initialized()


def rank_world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if not active():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def process_device(device=None) -> torch.device:
    """This process's device: ``device`` (None: the card), where a card
    without an index is cuda:{LOCAL_RANK % device_count}.  No card raises,
    as at every entry point of the port."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def init_distributed(backend: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None, init_method: Optional[str] = None,
                     timeout: datetime.timedelta = INIT_TIMEOUT,
                     device=None) -> Tuple[int, int]:
    """Bring up the default process group; a no-op returning (0, 1) when
    neither arguments nor torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR) ask for one, and idempotent once it is up.
    Returns (rank, world size).

    ``backend`` None means NCCL when ``device`` (see ``process_device``) is
    a card and gloo on the CPU; a named backend is used as named.  On a
    card the process's current device is set first.  ``init_method``
    (``tcp://host:port``, ``file:///path``) defaults to torchrun's
    ``env://``."""
    if active():
        return rank_world()
    want = (rank is not None or world_size is not None or init_method is not None
            or any(os.environ.get(k) for k in _ENV_TRIGGERS))
    if not want:
        return 0, 1
    dev = process_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    return rank_world()


def _comm_device() -> torch.device:
    """Where the default group's collectives take their tensors: the
    current card for NCCL, host memory for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def block_rows(B_local: int) -> Optional[Tuple[int, int]]:
    """(offset of this rank's rows in the global block, global block size)
    for the EA's draws, or None without a group."""
    if not active():
        return None
    rank, world = rank_world()
    return rank * B_local, world * B_local


def allreduce_sums(*dicts) -> tuple:
    """The dicts of tensors with each tensor summed over the ranks, in one
    all_reduce (SUM) of a flat float64 buffer (integer counters are exact
    in it below 2^53); each sum comes back in its tensor's dtype and
    device.  Without a group the dicts are returned as they are and nothing
    is issued."""
    if not active():
        return dicts
    parts = [t for d in dicts for t in d.values()]
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in parts])
    comm = flat.to(_comm_device())
    dist.all_reduce(comm)
    flat = comm.to(flat.device)
    out, i = [], 0
    for d in dicts:
        out.append({})
        for k, t in d.items():
            out[-1][k] = flat[i:i + t.numel()].reshape(t.shape).to(t.dtype)
            i += t.numel()
    return tuple(out)


def barrier() -> None:
    """Wait for every rank (nothing without a group)."""
    if active():
        dist.barrier()


def _allgather(t: torch.Tensor) -> torch.Tensor:
    """[W, ...] on the host: every rank's equal-shaped tensor ``t``."""
    is_bool = t.dtype == torch.bool
    if is_bool:  # NCCL has no bool
        t = t.view(torch.uint8)
    t = t.to(_comm_device()).contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    res = torch.stack(out).cpu()
    return res.view(torch.bool) if is_bool else res


def allsum_host(*arrays) -> tuple:
    """Each host array summed over the ranks in float64, the same on every
    rank: the reference's ``comm.allreduce`` for init-time statistics
    (reference _models.py:242-263).  The identity without a group."""
    arrays = [np.asarray(a, dtype=np.float64) for a in arrays]
    if not active():
        return tuple(arrays)
    (sums,) = allreduce_sums({i: torch.from_numpy(a) for i, a in enumerate(arrays)})
    return tuple(sums[i].numpy() for i in range(len(arrays)))


def make_global_array(local, device=None) -> torch.Tensor:
    """This rank's rows [nb, B_local, ...] of a blocked tensor, on
    ``device`` (None: the process's card).  The global tensor is never
    assembled: it is [rank 0 rows | rank 1 rows | ...] along B."""
    local = local if isinstance(local, torch.Tensor) else torch.from_numpy(np.asarray(local))
    return local.to(process_device(device))


def distribute_tree(tree_local, device=None):
    """``make_global_array`` on every tensor field of a dataclass (Data,
    EState, the params)."""
    from evo_tpu_torch.models.base import _map_leaves

    return _map_leaves(lambda a: make_global_array(a, device), tree_local)


def local_rows(a: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a blocked tensor [nb, B_global, ...] in the
    global layout (the whole tensor without a group, or for fewer than two
    dimensions)."""
    rank, world = rank_world()
    if world == 1 or a.dim() < 2:
        return a
    if a.shape[1] % world:
        raise ValueError(f"the block size {a.shape[1]} does not divide among {world} ranks")
    Bl = a.shape[1] // world
    return a[:, rank * Bl:(rank + 1) * Bl].contiguous()


def distribute_estate(estate, device=None):
    """This rank's rows of a full ``EState`` (as ``init_states`` draws it
    for the global N), on ``device`` (None: the process's card)."""
    from evo_tpu_torch.models.base import _map_leaves

    dev = process_device(device)
    return _map_leaves(lambda a: local_rows(a).to(dev), estate)


def make_global_data(y_local: np.ndarray, x_local: Optional[np.ndarray] = None,
                     n_blocks: int = 1, device=None, dtype=torch.float32):
    """``Data`` of this rank's rows [N_local, D] (NaN marking missing
    entries, as in ``make_data``), blocked [n_blocks, N_local / n_blocks,
    D] on ``device`` (None: the process's card).  Every rank passes the same
    N_local, a multiple of n_blocks (nothing is padded: padding rows would
    land in every rank's share).  The ``incomplete`` flag is OR-reduced over
    the ranks, so that every rank takes the same path."""
    from evo_tpu_torch.models.base import make_data

    y_local = np.asarray(y_local)
    N_local = y_local.shape[0]
    if N_local % n_blocks:
        raise ValueError(f"N_local={N_local} must be a multiple of n_blocks={n_blocks} "
                         "with several processes (pad the rows upstream)")
    data = make_data(y_local, x=x_local, n_blocks=n_blocks, dtype=dtype,
                     device=process_device(device))
    if active():
        got = _allgather(torch.tensor([N_local, int(data.incomplete)])).numpy()
        if not (got[:, 0] == N_local).all():
            raise ValueError(f"the ranks hold unequal row counts {got[:, 0].tolist()}")
        data.incomplete = bool(got[:, 1].any())
    return data


def local_host_rows(data):
    """This rank's valid rows of ``data`` as flat host arrays (y [N, D],
    m [N, D], valid [N])."""
    D = data.D
    return (data.y.reshape(-1, D).cpu().numpy(), data.x_infr.reshape(-1, D).cpu().numpy(),
            data.row_valid.reshape(-1).cpu().numpy())


def global_init_stats(data, y_host=None, D: int = None):
    """(N, y_mean [D], ss_resid, m_sum) over every rank's rows, the same on
    every rank: the global row count, the masked mean sum(y m) / N (the
    reference's incomplete-data normalization, _models.py:249), the masked
    squared residual sum(((y - y_mean) m)^2) and the observed-entry count
    sum(m).  ``y_host`` is this rank's flat host rows (NaN marking missing
    entries), else the data's valid rows are read back.  evo_tpu's
    function of the same name, in float64."""
    if y_host is not None:
        y_raw = np.asarray(y_host).reshape(-1, D)
        m = ~np.isnan(y_raw)
        y = np.where(m, y_raw, 0.0)
    else:
        y, m, valid = local_host_rows(data)
        y, m = y[valid], m[valid]
    y = y.astype(np.float64)
    mf = m.astype(np.float64)
    (part,) = allsum_host(np.concatenate([[np.float64(y.shape[0])], (y * mf).sum(0),
                                          [mf.sum()]]))
    N = part[0]
    y_mean = part[1:-1] / N
    m_sum = part[-1]
    (ss_resid,) = allsum_host(np.asarray([(((y - y_mean) * mf) ** 2).sum()]))
    return N, y_mean, float(ss_resid[0]), float(m_sum)


def gather_global(x) -> np.ndarray:
    """The full value of a tensor on every rank, on the host: blocked
    tensors [nb, B_local, ...] are gathered into the global layout
    [nb, B_global, ...] (the reference's Gatherv, parallel.py:154-173, but
    to every rank); tensors of fewer dimensions are replicated and come
    back as they are."""
    x = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if not active() or x.dim() < 2:
        return x.cpu().numpy()
    return torch.cat(list(_allgather(x)), dim=1).numpy()
