"""Mutation operators generating children from parents, batched over
datapoints.

Counterpart: evo_tpu/variational/mutation.py:17-95 (all five operators).
Each operator maps parents [B, P, H] (bool) to children [B, C, H] (bool),
parent-major.  Its random numbers come pre-drawn in ``noise`` (the tests
pass in what evo_tpu drew, and the children then agree exactly) or are drawn
from ``generator`` by ``draw_noise``.  The noise of each operator is what
evo_tpu's operator draws from its key:

  randflip          flip index [B, P, 1] (one child per parent) or
                    uniforms [B, P, H] (several children per parent)
  sparseflip        uniforms [B, P*C, H]
  cross             crossover points [B, P*(P-1)/2] in [1, H)
  cross_randflip    (crossover points, flip index [B, P*(P-1), 1])
  cross_sparseflip  (crossover points, uniforms [B, P*(P-1), H])
"""

from __future__ import annotations

import functools
from itertools import combinations

import torch

from evo_tpu_torch.variational.selection import stable_topk_idx


def _n_pairs(P: int) -> int:
    return P * (P - 1) // 2


@functools.lru_cache(maxsize=64)
def _pair_index(P: int, device: torch.device):
    """The first and second parents (ia, ib) of every unordered pair of P
    parents, made once per P and device, so that a captured CUDA graph of
    the EA finds them on the card."""
    pairs = list(combinations(range(P), 2))
    return (torch.tensor([p[0] for p in pairs], device=device),
            torch.tensor([p[1] for p in pairs], device=device))


def draw_noise(algorithm: str, B: int, P: int, C: int, H: int,
               generator: torch.Generator, device):
    """Draw the random numbers operator ``algorithm`` consumes."""
    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=generator, device=device)

    if algorithm == "randflip":
        return randint(0, H, B, P, 1) if C == 1 else rand(B, P, H)
    if algorithm == "sparseflip":
        return rand(B, P * C, H)
    cp = randint(1, H, B, _n_pairs(P))
    if algorithm == "cross":
        return cp
    if algorithm == "cross_randflip":
        return cp, randint(0, H, B, 2 * _n_pairs(P), 1)
    if algorithm == "cross_sparseflip":
        return cp, rand(B, 2 * _n_pairs(P), H)
    raise ValueError(algorithm)


def randflip(parents, n_children: int, noise, sparseness=None, p_bf=None):
    """Each child of a parent flips exactly one bit, distinct across that
    parent's children (reference eas.py:10-43)."""
    B, P, H = parents.shape
    if n_children == 1:
        flip_idx = noise  # [B, P, 1]
    else:
        flip_idx = stable_topk_idx(noise, n_children)  # [B, P, C]
    children = parents.repeat_interleave(n_children, dim=1)
    onehot = torch.nn.functional.one_hot(
        flip_idx.reshape(B, P * n_children).long(), H).to(torch.bool)
    return children ^ onehot


def sparseflip(parents, n_children: int, noise, sparseness=None, p_bf=None):
    """Bitflips with per-parent probabilities p_0 (0->1) and p_1 (1->0) that
    keep the expected number of flips at p_bf*H while driving the number of
    ON bits toward ``sparseness`` (reference eas.py:46-100)."""
    B, P, H = parents.shape
    dtype = torch.float32
    s_abs = parents.sum(dim=-1).to(dtype)  # [B, P]
    Hf = float(H)
    eps = torch.finfo(dtype).tiny
    alpha = ((Hf - s_abs) * ((Hf * p_bf) - (sparseness - s_abs))
             / ((sparseness - s_abs + Hf * p_bf) * s_abs + eps))
    p_0 = (Hf * p_bf) / (Hf + (alpha - 1.0) * s_abs + eps)
    p_1 = alpha * p_0
    p = torch.where(parents, p_1[..., None], p_0[..., None])
    p = p.repeat_interleave(n_children, dim=1)
    children = parents.repeat_interleave(n_children, dim=1)
    return children ^ (noise < p)


def cross(parents, n_children=None, noise=None, sparseness=None, p_bf=None):
    """One-point crossover of every unordered parent pair, two children per
    pair, interleaved (reference eas.py:103-125); ``noise`` holds the
    crossover points [B, n_pairs] in [1, H)."""
    B, P, H = parents.shape
    ia, ib = _pair_index(P, parents.device)
    tail = torch.arange(H, device=parents.device) >= noise[..., None]  # [B, np, H]
    A, Bp = parents[:, ia], parents[:, ib]
    c1 = torch.where(tail, Bp, A)
    c2 = torch.where(tail, A, Bp)
    return torch.stack([c1, c2], dim=2).reshape(B, 2 * _n_pairs(P), H)


def cross_randflip(parents, n_children=None, noise=None, sparseness=None, p_bf=None):
    cp, flips = noise
    return randflip(cross(parents, noise=cp), 1, flips)


def cross_sparseflip(parents, n_children=None, noise=None, sparseness=None, p_bf=None):
    cp, u = noise
    return sparseflip(cross(parents, noise=cp), 1, u, sparseness, p_bf)


MUTATION_FNS = {
    "randflip": randflip,
    "sparseflip": sparseflip,
    "cross": cross,
    "cross_randflip": cross_randflip,
    "cross_sparseflip": cross_sparseflip,
}
