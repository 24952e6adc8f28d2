"""The port's public names against evo_tpu's, and the pieces behind them
that the earlier slices lacked: BSC.generate_from_hidden, fitparents,
randparents and the per-datapoint evolve_states."""

import importlib
import importlib.util
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from evo_tpu.models.bsc import BSC as JBSC, BSCParams as JParams
from evo_tpu.ops.bitpack import dedup_keys as j_dedup_keys
from evo_tpu.ops.bitpack import dup_against as j_dup_against
from evo_tpu.ops.bitpack import dup_within as j_dup_within
from evo_tpu.variational import fitparents as j_fitparents
from evo_tpu.variational import randparents as j_randparents
from evo_tpu_torch import BSC, EAConfig
from evo_tpu_torch.models.bsc import BSCParams
from evo_tpu_torch.variational import evolve_states, fitparents, randparents

# evo_tpu packages whose export lists the port mirrors (parallel, data
# parallelism over torch.distributed, the last to be ported)
PACKAGES = ("models", "variational", "ops", "prepost", "parallel")


def _exports(mod):
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_exports_match_evo_tpu(pkg):
    j = importlib.import_module(f"evo_tpu.{pkg}")
    t = importlib.import_module(f"evo_tpu_torch.{pkg}")
    missing = _exports(j) - _exports(t)
    assert not missing, sorted(missing)


def test_parallel_is_named_as_not_ported():
    """No package of evo_tpu is left unported: parallel has its
    counterpart, and so has every other package with an export list."""
    assert "parallel" in PACKAGES
    for pkg in PACKAGES:
        assert importlib.util.find_spec(f"evo_tpu.{pkg}") is not None
        assert importlib.util.find_spec(f"evo_tpu_torch.{pkg}") is not None


def test_generate_from_hidden_matches_evo_tpu():
    rng = np.random.default_rng(0)
    D, H, N = 9, 6, 40
    W = rng.standard_normal((D, H)).astype(np.float32)
    s = rng.random((N, H)) < 0.3
    jp = JParams(W=jnp.asarray(W), pi=jnp.asarray(0.3, jnp.float32),
                 sigma=jnp.asarray(0.5, jnp.float32), pies=jnp.full((H,), 0.3, jnp.float32))
    tp = BSCParams(W=torch.from_numpy(W), pi=torch.tensor(0.3), sigma=torch.tensor(0.5),
                   pies=torch.full((H,), 0.3))
    jout = JBSC(D=D, H=H).generate_from_hidden(jax.random.key(0), jp, jnp.asarray(s))
    tout = BSC(D=D, H=H, device="cpu").generate_from_hidden(
        tp, torch.from_numpy(s), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(tout["y_mean"].numpy(), np.asarray(jout["y_mean"]),
                               rtol=1e-6, atol=1e-6)
    assert tout["y"].shape == (N, D) and torch.equal(tout["s"], torch.from_numpy(s))
    resid = (tout["y"] - tout["y_mean"]).numpy()
    assert 0.3 < resid.std() < 0.7  # sigma = 0.5 noise on top


def test_generate_data_keeps_its_draws():
    """generate_data draws as its earlier inline body did: the states
    (rand <= pi), then the noise (randn), from one generator."""
    D, H, N = 9, 6, 50
    g = torch.Generator().manual_seed(1)
    p = BSCParams(W=torch.randn(D, H, generator=g), pi=torch.tensor(0.25),
                  sigma=torch.tensor(0.7), pies=torch.full((H,), 0.25))
    got = BSC(D=D, H=H, device="cpu").generate_data(p, N, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    s = torch.rand((N, H), generator=g) <= p.pi
    y_mean = s.to(torch.float32) @ p.W.T
    noise = torch.randn(y_mean.shape, generator=g, dtype=torch.float32)
    assert torch.equal(got["s"], s)
    assert torch.equal(got["y_mean"], y_mean)
    assert torch.equal(got["y"], y_mean + p.sigma * noise)


def test_fitparents_randparents_match_evo_tpu():
    """With evo_tpu's Gumbel noise the port picks the same parents; drawn
    from a generator, parents are distinct rows of the candidates."""
    rng = np.random.default_rng(2)
    K, H, k = 12, 7, 5
    cand = (rng.random((K, H)) < 0.4).astype(np.int8)
    cand[:, 0] = 1
    cand[np.arange(K), 1 + np.arange(K) % (H - 1)] ^= 1
    lpj = rng.standard_normal(K).astype(np.float32) * 5 - 3
    lpj[3] = np.finfo(np.float32).min  # a reset-floored entry gets no weight
    key = jax.random.key(4)
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, (K,), jnp.float32)))
    want = np.asarray(j_fitparents(key, jnp.asarray(cand), k, jnp.asarray(lpj)))
    got = fitparents(torch.from_numpy(cand), k, torch.from_numpy(lpj), gumbel=gumbel)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(j_randparents(key, jnp.asarray(cand), k))
    got = randparents(torch.from_numpy(cand), k, gumbel=gumbel)
    np.testing.assert_array_equal(got.numpy(), want)

    rows = {tuple(r) for r in cand}
    g = torch.Generator().manual_seed(0)
    batch = torch.from_numpy(np.stack([cand, cand[::-1].copy()]))
    for par in (fitparents(batch, k, torch.from_numpy(np.stack([lpj, lpj])), generator=g),
                randparents(batch, k, generator=g)):
        assert par.shape == (2, k, H)
        for b in range(2):
            picked = [tuple(r) for r in par[b].numpy()]
            assert set(picked) <= rows and len(set(picked)) == k
    floored = torch.from_numpy(cand[3])
    for _ in range(20):
        par = fitparents(torch.from_numpy(cand), k, torch.from_numpy(lpj), generator=g)
        assert not (par == floored).all(dim=1).any()


@pytest.mark.parametrize("mutation", ["randflip", "cross"])
def test_evolve_states_contract(mutation):
    H, S = 5, 6
    cfg = EAConfig(S=S, H=H, n_parents=4, n_children=3, n_generations=2,
                   mutation_algorithm=mutation)
    rng = np.random.default_rng(3)
    ss = np.unique((rng.random((40, H)) < 0.4).astype(np.int8), axis=0)[:S]
    w = torch.from_numpy(rng.standard_normal(H).astype(np.float32))

    def lpj_fn(states):
        return states.to(torch.float32) @ w - states.sum(-1).to(torch.float32)

    ss_t = torch.from_numpy(ss)
    children, child_lpj, new_unique, raw = evolve_states(
        ss_t, lpj_fn(ss_t), lpj_fn, cfg, 1.5, generator=torch.Generator().manual_seed(7))
    T, C = cfg.n_new, cfg.children_per_gen
    assert children.shape == (T, H) and children.dtype == torch.int8
    assert child_lpj.shape == raw.shape == new_unique.shape == (T,)
    np.testing.assert_array_equal(raw.numpy(), lpj_fn(children).numpy())
    assert torch.equal(child_lpj[new_unique], raw[new_unique])
    assert bool(torch.isneginf(child_lpj[~new_unique]).all())
    assert bool((~new_unique).any()), "no duplicate to check at this size"
    K = {tuple(r) for r in ss}
    fresh = [tuple(r) for r in children[new_unique].numpy()]
    assert not set(fresh) & K and len(set(fresh)) == len(fresh)

    # evo_tpu's dedup masks on the same children, generation by generation
    seen = j_dedup_keys(jnp.asarray(ss))
    seen_valid = jnp.ones((S,), bool)
    for g in range(cfg.n_generations):
        ck = j_dedup_keys(jnp.asarray(children[g * C:(g + 1) * C].numpy()))
        uniq = ~(j_dup_against(ck, seen, seen_valid) | j_dup_within(ck))
        np.testing.assert_array_equal(new_unique[g * C:(g + 1) * C].numpy(), np.asarray(uniq))
        seen = jnp.concatenate([seen, ck])
        seen_valid = jnp.concatenate([seen_valid, uniq])
