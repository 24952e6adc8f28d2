"""Evolutionary generation of new candidate states for a block of
datapoints.

Counterpart: evo_tpu/variational/evolve.py:139-258 ``evolve_states_block``,
with the same seen-set bookkeeping: every generation yields exactly
``children_per_gen`` children per datapoint; a child that equals a state of
K^(n) or any earlier child is masked (lpj -inf, new_unique False) rather
than dropped, and the next generation selects its parents among this
generation's children with their true lpjs.

The random numbers are drawn per generation from ``generator``, or taken
from ``draws`` (one (selection gumbel, mutation noise) pair per generation)
so that a test can feed in what evo_tpu drew.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from evo_tpu_torch.ops.bitpack import dedup_keys, dup_against, dup_within
from evo_tpu_torch.variational.config import EAConfig
from evo_tpu_torch.variational.mutation import MUTATION_FNS, draw_noise
from evo_tpu_torch.variational.selection import draw_gumbel, select_idx


def evolve_states_block(
    ss_b: torch.Tensor,  # [B, S, H] int8 — current K^(n)
    lpj_b: torch.Tensor,  # [B, S]
    lpj_fn_block: Callable,  # [B, C, H] int8 -> ([B, C], keys [B, C, W] | None, aux)
    cfg: EAConfig,
    sparseness,  # pi*H of the current model
    generator: Optional[torch.Generator] = None,
    ss_dkeys: Optional[torch.Tensor] = None,  # [B, S, W] dedup keys of ss_b
    draws: Optional[Sequence] = None,
):
    """Returns (children [B, T, H] int8, child_lpj [B, T] with -inf at
    duplicates, new_unique [B, T], child_lpj_raw [B, T], aux_list)."""
    if cfg.allzero or cfg.background:
        raise NotImplementedError("permanent states are not ported yet")
    B, S, H = ss_b.shape
    if H != cfg.H:
        raise ValueError(f"states have H={H}, config H={cfg.H}")
    C = cfg.children_per_gen
    mutate = MUTATION_FNS[cfg.mutation_algorithm]
    if ss_dkeys is None:
        ss_dkeys = dedup_keys(ss_b)
    seen_keys = ss_dkeys
    seen_valid = torch.ones((B, S), dtype=torch.bool, device=ss_b.device)

    pool_states, pool_lpj = ss_b, lpj_b
    out_states, out_lpj, out_new, out_raw, aux_list = [], [], [], [], []
    for g in range(cfg.n_generations):
        n_pool = pool_states.shape[1]
        n_par = min(n_pool, cfg.n_parents)
        if draws is None:
            gumbel = draw_gumbel((B, n_pool), generator, ss_b.device, pool_lpj.dtype)
            noise = draw_noise(cfg.mutation_algorithm, B, n_par, cfg.n_children,
                               cfg.H_mut, generator, ss_b.device)
        else:
            gumbel, noise = draws[g]
        pidx = select_idx(cfg.parent_selection, pool_lpj, n_par, gumbel=gumbel)
        parents = torch.gather(pool_states, 1, pidx[..., None].expand(-1, -1, H)) != 0
        children = mutate(parents, cfg.n_children, noise, sparseness,
                          cfg.bitflip_prob).to(ss_b.dtype)
        if children.shape != (B, C, H):
            raise AssertionError((children.shape, (B, C, H)))

        child_lpj, ckeys, aux = lpj_fn_block(children)
        aux_list.append(aux)
        if ckeys is None:
            ckeys = dedup_keys(children)
        new_unique = ~(dup_against(ckeys, seen_keys, seen_valid) | dup_within(ckeys))
        seen_keys = torch.cat([seen_keys, ckeys], dim=1)
        seen_valid = torch.cat([seen_valid, new_unique], dim=1)

        out_states.append(children)
        out_lpj.append(torch.where(new_unique, child_lpj, float("-inf")))
        out_new.append(new_unique)
        out_raw.append(child_lpj)
        pool_states, pool_lpj = children, child_lpj

    return (torch.cat(out_states, dim=1), torch.cat(out_lpj, dim=1),
            torch.cat(out_new, dim=1), torch.cat(out_raw, dim=1), aux_list)
