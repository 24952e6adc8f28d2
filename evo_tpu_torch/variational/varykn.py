"""Truncation-set update: merge new candidate states into K^(n).

Counterpart: evo_tpu/variational/varykn.py:29-163 (``_prune_to_mprime``, the
unification merge ``vary_Kn``, its position-preserving form
``vary_Kn_swap`` and the non-unification ``vary_Kn_whole_set``), batched
over datapoints.  The rows may be int8 states or lane-major packed uint8
states (ops.bitpack): the merges only move rows.  evo_tpu leans on
``lax.top_k`` preferring lower indices on ties, so that an old state wins a
tie against a child; a stable descending sort gives the same order.
``_prune_to_mprime`` and ``vary_Kn``'s plain form live beside its CUDA
kernel in ops/varykn_merge.py.
"""

from __future__ import annotations

import torch

from evo_tpu_torch.ops.varykn_merge import (
    _prune_to_mprime,
    _rows,
    fits,
    vary_Kn_plain,
    varykn_merge,
)
from evo_tpu_torch.variational.config import EAConfig
from evo_tpu_torch.variational.selection import stable_topk_idx


def vary_Kn(ss: torch.Tensor, lpj: torch.Tensor, children: torch.Tensor,
            child_lpj: torch.Tensor, Mprime: int):
    """ss [B, S, W], lpj [B, S], children [B, T, W], child_lpj [B, T] with
    -inf at duplicates.  Returns (ss_new [B, S, W], lpj_new [B, S],
    n_sub [B], idx [B, S]); idx points into concat(old, children).  On CUDA
    tensors inside the kernel's envelope (``ops.varykn_merge.fits``) one
    launch of csrc/varykn_merge.cu computes it, elsewhere its plain twin
    ``vary_Kn_plain``: the same results bit for bit."""
    if ss.device.type == "cuda" and fits(ss, lpj, children, child_lpj):
        return varykn_merge(ss, lpj, children, child_lpj, Mprime)
    return vary_Kn_plain(ss, lpj, children, child_lpj, Mprime)


def vary_Kn_swap(ss: torch.Tensor, lpj: torch.Tensor, children: torch.Tensor,
                 child_lpj: torch.Tensor, Mprime: int):
    """Position-preserving form of ``vary_Kn``: the same K^(n) set, but the
    rows that survive keep their slot.  The j-th best eligible child takes
    the slot of the j-th worst old state iff it is strictly better (ties
    keep the old row), as the reference swaps (utils.py:294-319).  Same
    arguments and results as ``vary_Kn``; the M = min(T, S) slots are
    distinct per datapoint, so one scatter does evo_tpu's M selects."""
    B, S = lpj.shape
    M = min(child_lpj.shape[-1], S)
    child_lpj = _prune_to_mprime(child_lpj, Mprime)
    cidx = stable_topk_idx(child_lpj, M)  # best children first
    cval = torch.gather(child_lpj, -1, cidx)
    wpos = stable_topk_idx(-lpj, M)  # worst old slots first
    swap = cval > torch.gather(lpj, -1, wpos)  # [B, M]
    iota = torch.arange(S, device=lpj.device).expand(B, S)

    def put(old, new):
        """old with new written to the slots wpos where swap holds (the
        other slots wpos get their own old values back)."""
        if old.dim() == 3:
            at = wpos[..., None].expand(-1, -1, old.shape[-1])
            return old.scatter(1, at, torch.where(swap[..., None], new, old.gather(1, at)))
        return old.scatter(1, wpos, torch.where(swap, new, old.gather(1, wpos)))

    ss_new = put(ss, _rows(children, cidx).to(ss.dtype))
    return ss_new, put(lpj, cval), swap.sum(dim=-1), put(iota, S + cidx)


def vary_Kn_whole_set(ss: torch.Tensor, lpj: torch.Tensor, children: torch.Tensor,
                      child_lpj_raw: torch.Tensor, new_unique: torch.Tensor,
                      reject_worse: bool = True):
    """Non-unification merge (reference utils.py:325-335): the children
    [B, S, W] replace the whole K^(n) of a datapoint, unconditionally
    without ``reject_worse``, else only if the summed raw lpj (duplicates
    included) does not fall; a tie accepts.  On rejection both counters are
    zero.  Returns (ss_new, lpj_new, n_uni [B], n_sub [B], idx [B, S])."""
    B, S = lpj.shape
    if children.shape[1] != S:
        raise ValueError("whole-set mode needs exactly S children")
    if reject_worse:
        accept = child_lpj_raw.sum(dim=-1) >= lpj.sum(dim=-1)
    else:
        accept = torch.ones(B, dtype=torch.bool, device=lpj.device)
    ss_new = torch.where(accept[:, None, None], children.to(ss.dtype), ss)
    lpj_new = torch.where(accept[:, None], child_lpj_raw, lpj)
    n = torch.where(accept, new_unique.sum(dim=-1), 0)
    iota = torch.arange(S, device=lpj.device)
    idx = torch.where(accept[:, None], S + iota, iota)
    return ss_new, lpj_new, n, n, idx


def merge_states(cfg: EAConfig, ss, lpj, children, child_lpj, new_unique, child_lpj_raw):
    """The merge ``cfg`` asks for (evo_tpu/models/bsc.py:292-303): the
    unification merge, sorted (``vary_Kn``) or slot-stable (``swap_merge``),
    or the whole-set replacement (``unification=False``).  Returns (ss_new,
    lpj_new, n_uni [B], n_sub [B], idx [B, S])."""
    if not cfg.unification:
        return vary_Kn_whole_set(ss, lpj, children, child_lpj_raw, new_unique,
                                 cfg.reject_worse)
    merge = vary_Kn_swap if cfg.swap_merge else vary_Kn
    ss_new, lpj_new, n_sub, idx = merge(ss, lpj, children, child_lpj, cfg.mprime)
    return ss_new, lpj_new, new_unique.sum(dim=1), n_sub, idx
