"""Evolutionary generation of new candidate states for a block of
datapoints.

Counterpart: evo_tpu/variational/evolve.py:139-258 ``evolve_states_block``,
with the same seen-set bookkeeping: every generation yields exactly
``children_per_gen`` children per datapoint; a child that equals a state of
K^(n), the permanent all-zero state (``allzero``) or any earlier child is
masked (lpj -inf, new_unique False) rather than dropped, and the next
generation selects its parents among this generation's children with their
true lpjs.  With ``background`` the EA mutates the first H - 1 units and
sets the last one.

States given as uint8 are lane-major packed (ops.bitpack), as evo_tpu's
``packed=True``: the seen-set keys come from the bytes
(``dedup_keys_packed``), only the parents are unpacked, and the children are
packed right after mutation.

The random numbers are drawn per generation from ``generator``, or taken
from ``draws`` (one (selection gumbel, mutation noise) pair per generation)
so that a test can feed in what evo_tpu drew.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from evo_tpu_torch.ops.bitpack import (
    dedup_keys,
    dedup_keys_packed,
    dup_against,
    dup_within,
    n_bytes_lane,
    pack_bits_lane,
    unpack_bits_lane,
)
from evo_tpu_torch.variational.config import EAConfig
from evo_tpu_torch.variational.mutation import MUTATION_FNS, draw_noise
from evo_tpu_torch.variational.selection import draw_gumbel, select_idx


def evolve_states_block(
    ss_b: torch.Tensor,  # [B, S, H] int8, or packed uint8 [B, S, ceil(H/8)] — K^(n)
    lpj_b: torch.Tensor,  # [B, S]
    lpj_fn_block: Callable,  # states like ss_b -> ([B, C], keys [B, C, W] | None, aux)
    cfg: EAConfig,
    sparseness,  # pi*H of the current model
    generator: Optional[torch.Generator] = None,
    ss_dkeys: Optional[torch.Tensor] = None,  # [B, S, W] dedup keys of ss_b
    draws: Optional[Sequence] = None,
):
    """Returns (children [B, T, H or ceil(H/8)] like ss_b, child_lpj [B, T]
    with -inf at duplicates, new_unique [B, T], child_lpj_raw [B, T],
    aux_list).  Keys returned by ``lpj_fn_block`` must be those of
    ``keys_of`` below for the same states."""
    B, S, Hrep = ss_b.shape
    H = cfg.H
    packed = ss_b.dtype == torch.uint8
    if Hrep != (n_bytes_lane(H) if packed else H):
        raise ValueError(f"states {tuple(ss_b.shape)} do not match H={H} (packed={packed})")
    keys_of = dedup_keys_packed if packed else dedup_keys
    C = cfg.children_per_gen
    mutate = MUTATION_FNS[cfg.mutation_algorithm]
    dev = ss_b.device
    seen_keys = keys_of(ss_b) if ss_dkeys is None else ss_dkeys
    seen_valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    if cfg.allzero:
        zero = torch.zeros((1, Hrep), dtype=torch.uint8 if packed else torch.int8, device=dev)
        zero_key = keys_of(zero).expand(B, -1, -1)
        seen_keys = torch.cat([zero_key, seen_keys], dim=1)
        seen_valid = torch.cat([torch.ones_like(seen_valid[:, :1]), seen_valid], dim=1)

    pool_states, pool_lpj = ss_b, lpj_b
    out_states, out_lpj, out_new, out_raw, aux_list = [], [], [], [], []
    for g in range(cfg.n_generations):
        n_pool = pool_states.shape[1]
        n_par = min(n_pool, cfg.n_parents)
        if draws is None:
            gumbel = draw_gumbel((B, n_pool), generator, dev, pool_lpj.dtype)
            noise = draw_noise(cfg.mutation_algorithm, B, n_par, cfg.n_children,
                               cfg.H_mut, generator, dev)
        else:
            gumbel, noise = draws[g]
        pidx = select_idx(cfg.parent_selection, pool_lpj, n_par, gumbel=gumbel)
        parents = torch.gather(pool_states, 1, pidx[..., None].expand(-1, -1, Hrep))
        parents = unpack_bits_lane(parents, H) if packed else parents != 0
        children = mutate(parents[..., :cfg.H_mut], cfg.n_children, noise, sparseness,
                          cfg.bitflip_prob)
        if cfg.background:
            children = torch.cat([children, torch.ones_like(children[..., :1])], dim=-1)
        children = pack_bits_lane(children) if packed else children.to(ss_b.dtype)
        if children.shape != (B, C, Hrep):
            raise AssertionError((children.shape, (B, C, Hrep)))

        child_lpj, ckeys, aux = lpj_fn_block(children)
        aux_list.append(aux)
        if ckeys is None:
            ckeys = keys_of(children)
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
