"""The port's evolutionary E-step against evo_tpu's, fed with evo_tpu's own
random numbers.

jax.random and torch.Generator give different numbers, so each test draws
the noise with jax.random from the key stream evo_tpu uses and passes it
into the port's function.  Selection, mutation, merge and the seen-set
bookkeeping are then integer or select logic on the same inputs and must
agree exactly (no tolerance).  Whole EA trajectories agree only in
distribution; test_torch_bsc.py covers those.
"""

from itertools import combinations

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from evo_tpu.ops import bitpack as jbp
from evo_tpu.variational import mutation as jmut
from evo_tpu.variational import selection as jsel
from evo_tpu.variational.config import EAConfig as JEAConfig
from evo_tpu.variational.evolve import evolve_states_block as j_evolve
from evo_tpu.variational.varykn import vary_Kn as j_vary_Kn
from evo_tpu.variational.varykn import vary_Kn_swap as j_vary_Kn_swap
from evo_tpu.variational.varykn import vary_Kn_whole_set as j_whole_set
from evo_tpu_torch.ops import bitpack as tbp
from evo_tpu_torch.variational import mutation as tmut
from evo_tpu_torch.variational import selection as tsel
from evo_tpu_torch.variational.config import EAConfig
from evo_tpu_torch.variational.evolve import evolve_states_block as t_evolve
from evo_tpu_torch.variational.varykn import _prune_to_mprime, vary_Kn as t_vary_Kn
from evo_tpu_torch.variational.varykn import vary_Kn_swap as t_vary_Kn_swap
from evo_tpu_torch.variational.varykn import vary_Kn_whole_set as t_whole_set

FLOOR = float(np.finfo(np.float32).min)


def _keys(n, seed=0):
    return jax.random.split(jax.random.key(seed), n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mutation_noise(alg, key, P, C, H):
    """What evo_tpu's operator `alg` draws from `key` (mutation.py)."""
    npairs = P * (P - 1) // 2
    if alg == "randflip":
        return (jax.random.randint(key, (P, 1), 0, H) if C == 1
                else jax.random.uniform(key, (P, H)))
    if alg == "sparseflip":
        return jax.random.uniform(key, (P * C, H), dtype=jnp.float32)
    if alg == "cross":
        return jax.random.randint(key, (npairs,), 1, H)
    k1, k2 = jax.random.split(key)
    cp = jax.random.randint(k1, (npairs,), 1, H)
    if alg == "cross_randflip":
        return cp, jax.random.randint(k2, (2 * npairs, 1), 0, H)
    return cp, jax.random.uniform(k2, (2 * npairs, H), dtype=jnp.float32)


def _vnoise(alg, keys, P, C, H):
    out = jax.jit(jax.vmap(lambda k: _mutation_noise(alg, k, P, C, H)))(keys)
    return tuple(map(_t, out)) if isinstance(out, tuple) else _t(out)


@pytest.mark.parametrize("selection", ["fit", "rand"])
def test_selection_exact_given_gumbel(selection):
    B, K, k = 32, 20, 6
    rng = np.random.default_rng(0)
    lpj = (rng.standard_normal((B, K)) * 30 - 100).astype(np.float32)
    lpj[0, :3] = FLOOR          # reset-floored entries get zero weight
    lpj[1, 4:9] = lpj[1, 3]     # ties
    keys = _keys(B)
    gumbel = jax.vmap(lambda kk: jax.random.gumbel(kk, (K,), jnp.float32))(keys)
    want = jax.vmap(lambda kk, l: jsel.select_idx(selection, kk, l, K, k))(
        keys, jnp.asarray(lpj))
    got = tsel.select_idx(selection, torch.from_numpy(lpj), k, gumbel=_t(gumbel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if selection == "fit":
        assert not np.isin([0, 1, 2], got[0].numpy()).any()


@pytest.mark.parametrize("alg,C", [("randflip", 1), ("randflip", 3), ("sparseflip", 2),
                                   ("cross", None), ("cross_randflip", None),
                                   ("cross_sparseflip", None)])
def test_mutation_exact_given_noise(alg, C):
    B, P, H = 16, 4, 24
    rng = np.random.default_rng(1)
    parents = rng.random((B, P, H)) < 0.2
    keys = _keys(B, seed=2)
    sparseness, p_bf = 3.0, 0.1
    want = jax.jit(jax.vmap(
        lambda kk, p: jmut.MUTATION_FNS[alg](kk, p, C, sparseness, p_bf)))(
        keys, jnp.asarray(parents))
    got = tmut.MUTATION_FNS[alg](torch.from_numpy(parents), C,
                                 _vnoise(alg, keys, P, C, H), torch.tensor(sparseness), p_bf)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mutation_noise_shapes():
    g = torch.Generator().manual_seed(0)
    P, H = 4, 24
    npairs = len(list(combinations(range(P), 2)))
    assert tmut.draw_noise("randflip", 3, P, 1, H, g, "cpu").shape == (3, P, 1)
    assert tmut.draw_noise("sparseflip", 3, P, 2, H, g, "cpu").shape == (3, 2 * P, H)
    cp, u = tmut.draw_noise("cross_sparseflip", 3, P, None, H, g, "cpu")
    assert cp.shape == (3, npairs) and u.shape == (3, 2 * npairs, H)
    assert 1 <= int(cp.min()) and int(cp.max()) < H


def test_vary_Kn_ties_exact():
    """Old states win ties against children, ties among children at the
    Mprime-th value go by index, and -inf duplicates never enter."""
    B, S, T, H = 6, 5, 7, 10
    rng = np.random.default_rng(3)
    ss = (rng.random((B, S, H)) < 0.3).astype(np.int8)
    ch = (rng.random((B, T, H)) < 0.3).astype(np.int8)
    lpj = rng.integers(-6, 0, (B, S)).astype(np.float32)
    clpj = rng.integers(-6, 0, (B, T)).astype(np.float32)
    clpj[0, :4] = -np.inf
    clpj[1] = -1.0
    lpj[1] = -1.0
    for Mprime in (S, 2):
        want = jax.vmap(j_vary_Kn, in_axes=(0, 0, 0, 0, None))(
            jnp.asarray(ss), jnp.asarray(lpj), jnp.asarray(ch), jnp.asarray(clpj), Mprime)
        got = t_vary_Kn(_t(ss), _t(lpj), _t(ch), _t(clpj), Mprime)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(got[2][1]) == 0  # all ties: no substitution


def test_prune_to_mprime_keeps_later_better_child():
    clpj = np.array([[-np.inf, -np.inf, -np.inf, -2.0, -1.0, -2.0]], np.float32)
    got = _prune_to_mprime(_t(clpj), 2).numpy()
    np.testing.assert_array_equal(got, [[-np.inf] * 3 + [-2.0, -1.0, -np.inf]])


def _int_lpj_fns(H, seed, packed=False):
    """An lpj with integer values: exact in f32 on both sides, so the
    fitness values the next generation selects on are identical.  With
    ``packed`` the states come lane-major packed and are unpacked first."""
    w = np.random.default_rng(seed).integers(-5, 6, H).astype(np.float32)

    def j_fn(states):
        if packed:
            states = jbp.unpack_bits_lane(states, H)
        return (states.astype(jnp.float32) @ jnp.asarray(w)) - 20.0, None, ()

    def t_fn(states):
        if packed:
            states = tbp.unpack_bits_lane(states, H)
        return states.to(torch.float32) @ torch.from_numpy(w) - 20.0, None, torch.zeros(3)

    return j_fn, t_fn


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("perm", [None, "allzero", "background"])
@pytest.mark.parametrize("alg,sel,H", [("randflip", "fit", 12), ("sparseflip", "rand", 12),
                                       ("cross_randflip", "fit", 70)])
def test_evolve_states_block_bookkeeping_exact(alg, sel, H, perm, packed):
    """Children, their masked and raw lpj and new_unique equal evo_tpu's
    on int8 and on packed states, with no permanent state, the all-zero
    one (its key pre-seeded in the seen set, from packed zeros when
    packed) and the background unit (mutated on H - 1 units, then set)."""
    B, S = 24, 8
    kw = dict(S=S, H=H, n_parents=4, n_children=2, n_generations=2,
              parent_selection=sel, mutation_algorithm=alg,
              bitflip_prob=0.1 if "sparse" in alg else None,
              allzero=perm == "allzero", background=perm == "background")
    jcfg, tcfg = JEAConfig(**kw), EAConfig(**kw)
    rng = np.random.default_rng(4)
    ss = (rng.random((B, S, H)) < 2.0 / H).astype(np.int8)
    ss[:, 1] = ss[:, 0]  # a duplicate inside K^(n)
    if perm == "background":
        ss[..., -1] = 1
    if packed:
        ss = jbp.pack_bits_lane_host(ss)
    j_fn, t_fn = _int_lpj_fns(H, seed=5, packed=packed)
    lpj = np.asarray(j_fn(jnp.asarray(ss))[0])
    keys = _keys(B, seed=6)
    sparseness = 2.0

    want = jax.jit(lambda k, s, l: j_evolve(k, s, l, j_fn, jcfg, sparseness,
                                            packed=packed))(
        keys, jnp.asarray(ss), jnp.asarray(lpj))

    # the same draws as evolve.py's sel_mut: fold_in(key, g), split
    def jax_draws(k, g, n_pool):
        k_sel, k_mut = jax.random.split(jax.random.fold_in(k, g))
        return (jax.random.gumbel(k_sel, (n_pool,), jnp.float32),
                _mutation_noise(alg, k_mut, tcfg.n_parents, tcfg.n_children, tcfg.H_mut))

    draws, n_pool = [], S
    for g in range(tcfg.n_generations):
        gum, noise = jax.jit(jax.vmap(lambda k: jax_draws(k, g, n_pool)))(keys)
        draws.append((_t(gum), tuple(map(_t, noise)) if isinstance(noise, tuple)
                      else _t(noise)))
        n_pool = tcfg.children_per_gen
    got = t_evolve(_t(ss), _t(lpj), t_fn, tcfg, torch.tensor(sparseness), draws=draws)

    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    new_unique = got[2].numpy()
    assert new_unique.any() and not new_unique.all()
    children = tbp.unpack_bits_lane(got[0], H) if packed else got[0] != 0
    if perm == "background":
        assert bool(children[..., -1].all())
    if perm == "allzero":  # a zero child is never new
        assert not new_unique[children.numpy().sum(-1) == 0].any()


@pytest.mark.parametrize("rows", ["int8", "uint8"])
@pytest.mark.parametrize("merge", ["swap", "whole_set", "whole_set_accept_all"])
def test_swap_and_whole_set_merges_exact(merge, rows):
    """vary_Kn_swap (slot-stable; old states win ties, -inf duplicates never
    enter, Mprime caps the swaps) and vary_Kn_whole_set (with and without
    reject_worse; a tie of the summed lpj accepts, a rejection zeroes both
    counters) against evo_tpu's, vmapped, on int8 and on packed rows.
    Integer lpj values make every sum exact on both sides."""
    B, S, H = 8, 6, 20
    rng = np.random.default_rng(7)
    T = 9 if merge == "swap" else S

    def states(n):
        if rows == "uint8":
            return rng.integers(0, 256, (B, n, -(-H // 8))).astype(np.uint8)
        return (rng.random((B, n, H)) < 0.3).astype(np.int8)

    ss, ch = states(S), states(T)
    lpj = rng.integers(-6, 0, (B, S)).astype(np.float32)
    clpj = rng.integers(-6, 0, (B, T)).astype(np.float32)
    clpj[0, :4] = -np.inf
    clpj[1], lpj[1] = -1.0, -1.0  # all ties
    new_unique = rng.random((B, T)) < 0.7
    if merge != "swap":
        clpj = rng.integers(-6, 0, (B, T)).astype(np.float32)
        clpj[2] = lpj[2][::-1]  # equal sums: accepted
        clpj[3] = lpj[3] - 1.0  # worse: rejected under reject_worse
    if merge == "swap":
        for Mprime in (S, 2):
            want = jax.vmap(j_vary_Kn_swap, in_axes=(0, 0, 0, 0, None))(
                jnp.asarray(ss), jnp.asarray(lpj), jnp.asarray(ch), jnp.asarray(clpj), Mprime)
            got = t_vary_Kn_swap(_t(ss), _t(lpj), _t(ch), _t(clpj), Mprime)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert int(got[2][1]) == 0 and got[0].dtype == _t(ss).dtype
        return
    reject = merge == "whole_set"
    want = jax.vmap(j_whole_set, in_axes=(0, 0, 0, 0, 0, None))(
        jnp.asarray(ss), jnp.asarray(lpj), jnp.asarray(ch), jnp.asarray(clpj),
        jnp.asarray(new_unique), reject)
    got = t_whole_set(_t(ss), _t(lpj), _t(ch), _t(clpj), _t(new_unique), reject)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    accepted = got[4][:, 0].numpy() == S
    assert accepted[2] and accepted[3] != reject
    assert int(got[2][3]) == int(got[3][3]) == (0 if reject else int(new_unique[3].sum()))
