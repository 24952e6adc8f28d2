"""Parent selection for the evolutionary E-step, batched over datapoints.

Counterpart: evo_tpu/variational/selection.py:21-60.  Gumbel-top-k sampling
without replacement, with the floored-lpj rule of ``fitparents_idx``.
``lax.top_k`` prefers lower indices on ties and ``torch.topk`` promises no
order, so the top k are taken from a stable descending sort.

Every function takes its Gumbel noise pre-drawn (``gumbel``) or draws it
from ``generator``; the tests pass in the noise evo_tpu drew, and the
indices then agree exactly.
"""

from __future__ import annotations

import torch


def stable_topk_idx(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of the last axis, lower index first
    on ties (the order of ``jax.lax.top_k``)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def draw_gumbel(shape, generator: torch.Generator, device,
                dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(dtype).tiny)))


def fitparents_idx(lpj: torch.Tensor, k: int, generator=None, gumbel=None):
    """[..., K] lpj -> [..., k] indices sampled without replacement with
    probability proportional to fitness = lpj - 2*min(min(lpj), 0).
    Reset-floored lpjs (<= finfo.min/2) are left out of the shift and get
    zero weight."""
    fin = torch.finfo(lpj.dtype)
    floored = lpj <= 0.5 * fin.min
    m = torch.clamp(torch.where(floored, 0.0, lpj).amin(dim=-1, keepdim=True), max=0.0)
    fitness = torch.where(floored, 0.0, lpj - 2.0 * m)
    logw = torch.log(fitness + fin.tiny)
    if gumbel is None:
        gumbel = draw_gumbel(lpj.shape, generator, lpj.device, lpj.dtype)
    return stable_topk_idx(logw + gumbel, k)


def randparents_idx(shape, k: int, generator=None, gumbel=None,
                    device=None, dtype=torch.float32):
    """[..., n_candidates] shape -> [..., k] indices sampled uniformly
    without replacement."""
    if gumbel is None:
        gumbel = draw_gumbel(shape, generator, device, dtype)
    return stable_topk_idx(gumbel, k)


def select_idx(selection: str, lpj: torch.Tensor, k: int, generator=None,
               gumbel=None):
    if selection == "fit":
        return fitparents_idx(lpj, k, generator, gumbel)
    if selection == "rand":
        return randparents_idx(lpj.shape, k, generator, gumbel, lpj.device, lpj.dtype)
    raise ValueError(selection)
