"""Initialization of the truncated variational state sets K^(n).

Counterpart: evo_tpu/variational/state_init.py:26-221.  The draws run on the
host with NumPy exactly as in evo_tpu, so the same seed gives the same
initial states in both packages; the result is moved to the device as int8,
or with ``packed_states`` as lane-major packed uint8 (ops.bitpack).
"""

from __future__ import annotations

import dataclasses
from itertools import combinations
from typing import Optional

import numpy as np
import torch

from evo_tpu_torch._device import resolve_device
from evo_tpu_torch.ops.bitpack import pack_bits_lane_host
from evo_tpu_torch.variational.config import EAConfig


@dataclasses.dataclass
class EState:
    """Per-datapoint truncated posterior state, blocked like ``Data``.

    ss:  int8 0/1 [nb, B, S, H] — the state sets K^(n); with
         ``EAConfig.packed_states`` lane-major packed uint8 [nb, B, S, ceil(H/8)]
    lpj: float [nb, B, S_perm + S] — their log-pseudo-joints
    """

    ss: torch.Tensor
    lpj: torch.Tensor


def full_state_matrix(H: int) -> np.ndarray:
    """All 2^H binary states, ordered by number of ON bits, then by
    combination order (the reference's ``sm`` enumeration)."""
    if H > 16:
        raise ValueError(f"full enumeration too large for H={H}")
    rows = []
    for g in range(H + 1):
        for comb in combinations(range(H), g):
            row = np.zeros(H, dtype=bool)
            row[list(comb)] = True
            rows.append(row)
    return np.stack(rows, axis=0)


def _pack_rows(ss: np.ndarray) -> np.ndarray:
    """[..., H] bool -> [..., W] uint64 keys (host-side, via packbits)."""
    H = ss.shape[-1]
    W = -(-H // 64)
    pad = W * 64 - H
    if pad:
        ss = np.concatenate([ss, np.zeros(ss.shape[:-1] + (pad,), bool)], axis=-1)
    packed = np.packbits(ss, axis=-1)
    return np.ascontiguousarray(packed).view(np.uint64).reshape(ss.shape[:-1] + (W,))


def _mark_duplicate_rows(keys: np.ndarray) -> np.ndarray:
    """keys [N, S, W] -> dup mask [N, S]: True where an identical state occurs
    elsewhere within the same n (one representative per group is kept)."""
    N, S, W = keys.shape
    n_idx = np.repeat(np.arange(N, dtype=np.uint64), S)
    flat = keys.reshape(N * S, W)
    order = np.lexsort(tuple(flat[:, w] for w in range(W)) + (n_idx,))
    sorted_flat = flat[order]
    sorted_n = n_idx[order]
    same = (sorted_flat[1:] == sorted_flat[:-1]).all(axis=1) & (sorted_n[1:] == sorted_n[:-1])
    dup = np.empty(N * S, dtype=bool)
    dup[order] = np.concatenate([[False], same])
    return dup.reshape(N, S)


def draw_initial_states(
    rng: np.random.Generator,
    N: int,
    S: int,
    H: int,
    p_init_Kn: float,
    exclude_allzero: bool,
    background: bool,
    max_rounds: int = 1000,
    chunk: int = 8192,
) -> np.ndarray:
    """Draw unique-per-datapoint Bernoulli(p_init_Kn) states with a
    vectorized redraw loop, in row chunks to bound host memory.  The same
    generator state gives the same states as evo_tpu's function."""
    H_ = H - 1 if background else H
    if S + (1 if exclude_allzero else 0) > 2**H_:
        raise ValueError("S too large for 2^H")
    out = np.empty((N, S, H_ + (1 if background else 0)), dtype=bool)
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        ss = rng.random((hi - lo, S, H_), dtype=np.float32) < p_init_Kn
        # only datapoints that had a redraw can hold a duplicate next round;
        # checking just those (in order) consumes the same random numbers
        # in the same order as checking all, so the states are unchanged
        active = np.arange(hi - lo)
        for _ in range(max_rounds):
            sub = ss[active]
            bad = _mark_duplicate_rows(_pack_rows(sub))
            if exclude_allzero:
                bad |= ~sub.any(axis=2)
            n_bad = int(bad.sum())
            if n_bad == 0:
                break
            sub[bad] = rng.random((n_bad, H_), dtype=np.float32) < p_init_Kn
            ss[active] = sub
            active = active[bad.any(axis=1)]
        else:
            raise RuntimeError("could not draw unique initial states")
        out[lo:hi, :, :H_] = ss
    if background:
        out[:, :, -1] = True
    return out


def init_states(
    N: int,
    S: int,
    H: int,
    parent_selection: str = "fit",
    mutation_algorithm: str = "randflip",
    no_parents: int = 10,
    no_children: int = 1,
    no_generations: int = 1,
    bitflip_prob: Optional[float] = None,
    Mprime: Optional[int] = None,
    p_init_Kn: Optional[float] = None,
    allzero: bool = False,
    background: bool = False,
    seed: int = 0,
    n_blocks: int = 1,
    dtype=torch.float32,
    packed_states: bool = False,
    unification: bool = True,
    reject_worse: bool = True,
    device=None,
):
    """Build (EAConfig, EState) for a fresh experiment.

    Defaults as in the reference (utils.py:155-228): p_init_Kn = 1/H,
    Mprime = S, permanent states off.  S == 2^H_ switches to exact E-steps:
    K^(n) is the full state enumeration and the EA is off.
    ``packed_states`` stores the states lane-major bit-packed, as evo_tpu
    does.  ``device`` None means the CUDA card."""
    dev = resolve_device(device)
    H_ = H - 1 if background else H
    exact = S == 2**H_ and not background
    cfg = EAConfig(
        S=S, H=H, n_parents=no_parents, n_children=no_children,
        n_generations=no_generations, parent_selection=parent_selection,
        mutation_algorithm=mutation_algorithm, bitflip_prob=bitflip_prob,
        Mprime=Mprime, allzero=allzero and not background,
        background=background, exact=exact, n_blocks=n_blocks,
        packed_states=packed_states, unification=unification,
        reject_worse=reject_worse,
    )
    if exact:
        if H_ >= 12:
            raise ValueError(f"Exact E-steps too expensive for H={H_}")
        sm = full_state_matrix(H_)
        if cfg.allzero:
            sm = sm[1:]  # the all-zero state is the permanent one
            cfg = dataclasses.replace(cfg, S=sm.shape[0])
        ss = np.broadcast_to(sm[None], (N,) + sm.shape)
    else:
        rng = np.random.default_rng(seed)
        ss = draw_initial_states(
            rng, N, S, H, p_init_Kn if p_init_Kn is not None else 1.0 / H,
            exclude_allzero=cfg.allzero, background=background)
    if N % n_blocks:
        raise ValueError("n_blocks must divide N (after padding)")
    B = N // n_blocks
    ss = np.ascontiguousarray(ss.reshape(n_blocks, B, ss.shape[1], ss.shape[2]))
    ss = pack_bits_lane_host(ss) if packed_states else ss.view(np.int8)
    estate = EState(
        ss=torch.from_numpy(ss).to(dev),
        lpj=torch.zeros((n_blocks, B, cfg.S_perm + cfg.S), dtype=dtype, device=dev),
    )
    return cfg, estate
