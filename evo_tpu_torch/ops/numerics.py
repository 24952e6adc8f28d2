"""Numerical stabilization for log-pseudo-joints and free energies.

Counterpart: evo_tpu/ops/numerics.py (same constants, the same
mask-then-replace order of ``reset_lpj`` and the same counts).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Reference constants (_models.py:55-56): B_max = 0.0, B_max_shft = +inf.
B_MAX = 0.0
B_MAX_SHFT = float("inf")


def eps_lpj(dtype) -> float:
    """Most negative representable lpj."""
    return float(torch.finfo(dtype).min)


class LpjResetCounts(NamedTuple):
    n_nan: torch.Tensor
    n_small: torch.Tensor
    n_inf: torch.Tensor


def reset_lpj(lpj: torch.Tensor, valid=None):
    """Clamp NaN / sub-floor / infinite lpj values, counting occurrences.

    All masks are taken from the input before any replacement, then applied
    in order: NaN -> floor, < floor -> floor, +-inf -> B_MAX.  So -inf ends
    as B_MAX (it is both sub-floor and infinite), as in evo_tpu.  ``valid``
    [leading dims] restricts the counts to valid rows.  Returns
    (lpj, LpjResetCounts) with int64 counts."""
    floor = eps_lpj(lpj.dtype)
    is_nan = torch.isnan(lpj)
    is_small = lpj < floor
    is_inf = torch.isinf(lpj)
    out = torch.where(is_nan, floor, lpj)
    out = torch.where(is_small, floor, out)
    out = torch.where(is_inf, B_MAX, out)
    if valid is not None:
        v = valid.reshape(valid.shape + (1,) * (lpj.ndim - valid.ndim))
        is_nan, is_small, is_inf = is_nan & v, is_small & v, is_inf & v
    return out, LpjResetCounts(is_nan.sum(), is_small.sum(), is_inf.sum())


def row_shift(lpj: torch.Tensor) -> torch.Tensor:
    """Per-row stabilization shift B = min(B_max - max(lpj), B_max_shft)."""
    return torch.clamp(B_MAX - lpj.amax(dim=-1), max=B_MAX_SHFT)


def shifted_logsumexp(lpj: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last axis with the reference's B-shift."""
    B = row_shift(lpj)
    return torch.log(torch.exp(lpj + B[..., None]).sum(dim=-1)) - B


def free_energy_from_lpj(lpj: torch.Tensor, ljc, row_valid=None) -> torch.Tensor:
    """F = ljc + (1/N) sum_n logsumexp_s lpj[n, s] over valid rows."""
    lse = shifted_logsumexp(lpj)
    if row_valid is None:
        return ljc + lse.sum() / lpj.shape[0]
    w = row_valid.to(lse.dtype)
    return ljc + (lse * w).sum() / torch.clamp(w.sum(), min=1.0)


def posterior_weights(lpj: torch.Tensor) -> torch.Tensor:
    """Truncated posterior responsibilities r[n,s] = pjc / sum_s' pjc with
    pjc = exp(lpj + B); the normalizer includes every state of the row."""
    B = row_shift(lpj)
    pjc = torch.exp(lpj + B[..., None])
    denom = pjc.sum(dim=-1, keepdim=True)
    return pjc / torch.clamp(denom, min=torch.finfo(lpj.dtype).tiny)
