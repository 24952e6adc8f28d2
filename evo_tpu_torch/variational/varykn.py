"""Truncation-set update: merge new candidate states into K^(n).

Counterpart: evo_tpu/variational/varykn.py:29-80 (``_prune_to_mprime`` and
the unification merge ``vary_Kn``), batched over datapoints.  The new K^(n)
is the top S of (old states, then eligible children) by lpj.  evo_tpu leans
on ``lax.top_k`` preferring lower indices on ties, so that an old state wins
a tie against a child; a stable descending sort gives the same order.
"""

from __future__ import annotations

import torch

from evo_tpu_torch.variational.selection import stable_topk_idx


def _prune_to_mprime(child_lpj: torch.Tensor, Mprime: int) -> torch.Tensor:
    """[B, T] -> [B, T]: all but the Mprime best children of each row masked
    to -inf.  Every child strictly better than the Mprime-th value stays;
    ties at that value are kept in index order up to Mprime in all."""
    T = child_lpj.shape[-1]
    if Mprime >= T:
        return child_lpj
    kth = torch.sort(child_lpj, dim=-1, descending=True)[0][..., Mprime - 1:Mprime]
    greater = child_lpj > kth
    n_greater = greater.sum(dim=-1, keepdim=True)
    tie = child_lpj == kth
    tie_rank = torch.cumsum(tie.to(torch.int64), dim=-1)  # 1-based among ties
    keep = greater | (tie & (tie_rank <= Mprime - n_greater))
    return torch.where(keep, child_lpj, float("-inf"))


def vary_Kn(ss: torch.Tensor, lpj: torch.Tensor, children: torch.Tensor,
            child_lpj: torch.Tensor, Mprime: int):
    """ss [B, S, H], lpj [B, S], children [B, T, H], child_lpj [B, T] with
    -inf at duplicates.  Returns (ss_new [B, S, H], lpj_new [B, S],
    n_sub [B], idx [B, S]); idx points into concat(old, children)."""
    S = lpj.shape[-1]
    child_lpj = _prune_to_mprime(child_lpj, Mprime)
    combined = torch.cat([lpj, child_lpj], dim=-1)
    idx = stable_topk_idx(combined, S)
    vals = torch.gather(combined, -1, idx)
    pool = torch.cat([ss, children.to(ss.dtype)], dim=1)
    ss_new = torch.gather(pool, 1, idx[..., None].expand(-1, -1, ss.shape[-1]))
    return ss_new, vals, (idx >= S).sum(dim=-1), idx
