"""The E-step options of EAConfig in the port against evo_tpu: the
permanent states (``allzero``, ``background``), the merges ``swap_merge``
and ``unification=False`` (either ``reject_worse``), and packed states in
exact mode.

Exact mode (S = 2^H, with ``allzero`` 2^H - 1 plus the permanent zero
state) has no random draws, so three epochs from the same Theta^0 and data
must agree with evo_tpu's to the tolerances of the exact-mode tests of
each model (tests/test_torch_bsc.py, tests/test_torch_sssc.py): EBSC F
within 1e-4 |F|, W within 1e-3 max|W|, pi, pies and sigma within 1e-4
relative; ES3C F and every parameter within 1e-5.  EA runs draw from other
generators than evo_tpu's, so they are held to what holds in distribution:
the swap merge gives the same sets and F as the sorted merge from the same
draws, every option yields well-formed epochs, and the background bars run
converges as evo_tpu's does (tests/test_ea_statistical_parity.py:206).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from evo_tpu.models.base import make_data as j_make_data
from evo_tpu.models.bsc import BSC as JBSC, BSCParams as JBSCParams
from evo_tpu.models.sssc import SSSC as JSSSC, SSSCParams as JSSSCParams
from evo_tpu.utils.bars import generate_bars_dict
from evo_tpu.variational.state_init import init_states as j_init_states
from evo_tpu_torch import BSC, SSSC, convert, init_states, make_data
from evo_tpu_torch.ops.bitpack import unpack_bits_lane


def _bsc_bars(H, N, seed=0):
    D = (H // 2) ** 2
    p = JBSCParams(W=jnp.asarray(10.0 * generate_bars_dict(H), jnp.float32),
                   pi=jnp.asarray(2.0 / H, jnp.float32), sigma=jnp.asarray(1.0, jnp.float32),
                   pies=jnp.full((H,), 2.0 / H, jnp.float32))
    Y = np.asarray(JBSC(D=D, H=H).generate_data(jax.random.key(seed), p, N)["y"])
    return D, p, Y


def _sssc_data(H, D, N, seed=2):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(H, H)) * 0.3
    p = JSSSCParams(W=jnp.asarray(rng.normal(size=(D, H)), jnp.float32),
                    pies=jnp.asarray(rng.uniform(0.1, 0.4, H), jnp.float32),
                    mus=jnp.asarray(rng.normal(size=H), jnp.float32),
                    Psi=jnp.asarray(A @ A.T + np.eye(H), jnp.float32),
                    sigma2=jnp.asarray(0.8, jnp.float32))
    return np.asarray(JSSSC(D=D, H=H).generate_data(jax.random.key(seed), p, N)["y"])


def _rel_err(t, j):
    j = np.asarray(j)
    return np.abs(t.detach().cpu().numpy() - j).max() / max(np.abs(j).max(), 1e-30)


@pytest.mark.parametrize("kind,variant", [("bsc", "allzero"), ("bsc", "allzero_incomplete"),
                                          ("bsc", "packed"), ("sssc", "allzero"),
                                          ("sssc", "allzero_incomplete"), ("sssc", "packed")])
def test_exact_mode_options_match_evo_tpu(kind, variant):
    """Exact-mode epochs with the permanent all-zero state (complete data,
    and 15% missing entries with reconstruction) and with packed states
    (EBSC at H = 10, ES3C at H = 6) against evo_tpu's em_step."""
    incomplete = variant.endswith("incomplete")
    opts = dict(packed_states=True) if variant == "packed" else dict(allzero=True)
    if kind == "bsc":
        H, N = (10, 200) if variant == "packed" else (6, 200)
        D, _, Y = _bsc_bars(H, N)
        jmodel, tmodel = JBSC(D=D, H=H), BSC(D=D, H=H, device="cpu")
    else:
        H, D, N = 6, 9, 256
        Y = _sssc_data(H, D, N)
        jmodel, tmodel = JSSSC(D=D, H=H), SSSC(D=D, H=H, device="cpu")
    if incomplete:
        Y = np.where(np.random.default_rng(3).random(Y.shape) < 0.15, np.nan, Y)
    jdata = j_make_data(Y, n_blocks=2)
    jcfg, jstate = j_init_states(N=N, S=2**H, H=H, n_blocks=2, **opts)
    tcfg, tstate = init_states(N=N, S=2**H, H=H, n_blocks=2, device="cpu", **opts)
    assert jcfg.exact and tcfg.exact and tcfg.S == jcfg.S and tcfg.S_perm == jcfg.S_perm
    np.testing.assert_array_equal(tstate.ss.numpy(), np.asarray(jstate.ss))
    tdata = convert.data_from_numpy(jdata, "cpu")
    jparams = jmodel.standard_init(jdata, seed=1)
    if kind == "bsc":
        tparams, rtol = convert.params_from_numpy(jparams, "cpu"), 1e-4
    else:
        tparams, rtol = convert.sssc_params_from_numpy(jparams, "cpu"), 1e-5
    gen = torch.Generator().manual_seed(0)
    for e in range(3):
        jparams, jstate, jstats, jrec = jmodel.em_step(
            jparams, jstate, jdata, jax.random.key(e), jcfg, do_reconstruction=incomplete)
        tparams, tstate, tstats, trec = tmodel.em_step(
            tparams, tstate, tdata, gen, tcfg, do_reconstruction=incomplete)
        Fj = float(jstats.F)
        assert abs(float(tstats.F) - Fj) <= rtol * abs(Fj), (e, float(tstats.F), Fj)
        for f in vars(tparams):
            tol = 1e-3 if (kind, f) == ("bsc", "W") else rtol
            assert _rel_err(getattr(tparams, f), getattr(jparams, f)) <= tol, (e, f)
        if incomplete:
            assert _rel_err(trec, jrec) <= 1e-5, e
        assert tuple(tstate.lpj.shape) == tuple(jstate.lpj.shape)
        np.testing.assert_array_equal(tstate.ss.numpy(), np.asarray(jstate.ss))


def _ea_setup(kind, H=6, D=9, N=64, S=8, swap_merge=False, **opts):
    Y = _sssc_data(H, D, N) if kind == "sssc" else _bsc_bars(H, N)[2]
    model = (BSC if kind == "bsc" else SSSC)(D=Y.shape[1], H=H, device="cpu")
    data = make_data(Y, n_blocks=2, device="cpu")
    cfg, estate = init_states(N=N, S=S, H=H, no_parents=4, no_children=2, no_generations=2,
                              n_blocks=2, seed=1, device="cpu", **opts)
    cfg = dataclasses.replace(cfg, swap_merge=swap_merge)
    return model, data, cfg, estate, model.standard_init(data, seed=0)


@pytest.mark.parametrize("kind", ["bsc", "sssc"])
def test_swap_merge_gives_the_sorted_merge_sets_and_F(kind):
    """swap_merge changes only the row order of the merged K^(n): from the
    same states and draws, each datapoint's set, the substitution count and
    F equal the sorted merge's (F and W up to the order of their f32 sums),
    as tests/test_evolve_varykn.py shows for evo_tpu."""
    model, data, cfg, estate, params = _ea_setup(kind)
    out = {}
    for swap in (False, True):
        out[swap] = model.em_step(params, estate, data, torch.Generator().manual_seed(5),
                                  dataclasses.replace(cfg, swap_merge=swap))
    (pa, ea, sa, _), (pb, eb, sb, _) = out[False], out[True]
    assert float(sb.F) == pytest.approx(float(sa.F), rel=1e-5)
    assert float(sa.S_sub) == float(sb.S_sub) > 0
    np.testing.assert_allclose(pb.W.numpy(), pa.W.numpy(), rtol=2e-4, atol=2e-5)
    a = ea.ss.reshape(-1, cfg.S, cfg.H).numpy()
    b = eb.ss.reshape(-1, cfg.S, cfg.H).numpy()
    for n in range(a.shape[0]):
        assert {r.tobytes() for r in a[n]} == {r.tobytes() for r in b[n]}, n
    assert not np.array_equal(a, b)  # the rows did move


@pytest.mark.parametrize("kind", ["bsc", "sssc"])
@pytest.mark.parametrize("opts", [dict(allzero=True), dict(background=True),
                                  dict(unification=False), dict(unification=False,
                                                                reject_worse=False),
                                  dict(background=True, packed_states=True)])
def test_ea_options_give_well_formed_epochs(kind, opts):
    """Three EA epochs under each option, on incomplete data with
    reconstruction: finite F and parameters, the stored lpj S_perm + S wide,
    the background unit on in every state and its pies pinned at
    1 - 1.1e-5, and with unification=False and no reject_worse every
    datapoint's set replaced (S_sub = S_nunique)."""
    S = 8 if opts.get("unification", True) else 4 * 2 * 2  # whole-set: n_new == S
    model, data, cfg, estate, params = _ea_setup(kind, S=S, **opts)
    Y = np.where(np.random.default_rng(4).random((64, model.D)) < 0.1, np.nan,
                 data.y.reshape(-1, model.D).numpy())
    data = make_data(Y, n_blocks=2, device="cpu")
    gen = torch.Generator().manual_seed(2)
    for _ in range(3):
        params, estate, stats, y_rec = model.em_step(params, estate, data, gen, cfg,
                                                     do_reconstruction=True)
        assert np.isfinite(float(stats.F))
        assert all(bool(torch.isfinite(v).all()) for v in vars(params).values())
        assert bool(torch.isfinite(y_rec).all())
        assert tuple(estate.lpj.shape) == (2, 32, cfg.S_perm + cfg.S)
        states = unpack_bits_lane(estate.ss, cfg.H) if cfg.packed_states else estate.ss != 0
        if cfg.background:
            assert bool(states[..., -1].all())
            assert float(params.pies[-1]) == pytest.approx(1.0 - 1.1e-5, abs=1e-7)
        if cfg.allzero:
            assert not bool((states.sum(-1) == 0).any())
        if not cfg.unification and not cfg.reject_worse:
            assert float(stats.S_sub) == float(stats.S_nunique)


def test_background_bars_run_converges():
    """EBSC bars training with the background unit (H = 8, N = 300, S = 20,
    sparseflip, 20 epochs), from the data and W0 of
    tests/test_ea_statistical_parity.py's fixture: as there, every run
    learns (F up by more than 5) and the mean F ends within 25 of the
    generating model's."""
    H, N, S = 8, 300, 20
    D, params_gen, Y = _bsc_bars(H, N)
    L_gen = float(JBSC(D=D, H=H).exact_free_energy(params_gen, j_make_data(Y)))
    ymean = Y.mean(0)
    sig0 = float(np.sqrt(((Y - ymean) ** 2).mean(0).sum() / D))
    W0 = ymean[:, None] + np.random.default_rng(4).normal(scale=sig0 / 4, size=(D, H))
    model = BSC(D=D, H=H, device="cpu")
    data = make_data(Y, device="cpu")
    Fs = []
    for seed in (0, 1, 2):
        params = convert.params_from_numpy(JBSCParams(
            W=jnp.asarray(W0, jnp.float32), pi=jnp.asarray(1.0 / H), sigma=jnp.asarray(sig0),
            pies=jnp.full((H,), 1.0 / H)), "cpu")
        cfg, estate = init_states(N=N, S=S, H=H, mutation_algorithm="sparseflip",
                                  no_parents=10, no_children=1, no_generations=1,
                                  bitflip_prob=2.0 / H, background=True, seed=seed,
                                  device="cpu")
        gen = torch.Generator().manual_seed(seed)
        F0 = None
        for _ in range(20):
            params, estate, stats, _ = model.em_step(params, estate, data, gen, cfg)
            F0 = float(stats.F) if F0 is None else F0
        assert float(stats.F) > F0 + 5.0, (seed, F0, float(stats.F))
        Fs.append(float(stats.F))
    assert np.isfinite(Fs).all() and float(np.mean(Fs)) > L_gen - 25.0, (Fs, L_gen)


@pytest.mark.parametrize("kind", ["bsc", "sssc"])
@pytest.mark.parametrize("opts", [dict(allzero=True), dict(allzero=True, packed_states=True),
                                  dict(background=True, unification=False),
                                  dict(background=True, swap_merge=True),
                                  dict(packed_states=True, swap_merge=True)])
def test_kernel_wrappers_get_contiguous_inputs(kind, opts, monkeypatch):
    """The CUDA kernels take only contiguous tensors (their wrappers raise
    on the card otherwise), which the CPU's plain versions do not check:
    every tensor an epoch hands a kernel wrapper must be contiguous, also
    the responsibilities of K^(n) cut out beside the permanent state."""
    import evo_tpu_torch.models.bsc as mbsc
    import evo_tpu_torch.models.sssc as msssc

    module = mbsc if kind == "bsc" else msssc
    names = ("bsc_lpj", "bsc_suffstat") if kind == "bsc" else ("sssc_lpj", "sssc_suffstat")
    seen = []

    def checked(fn):
        def call(*args, **kw):
            tensors = [a for a in (*args, *kw.values()) if isinstance(a, torch.Tensor)]
            assert all(t.is_contiguous() for t in tensors), fn.__name__
            seen.append(fn.__name__)
            return fn(*args, **kw)
        return call

    for name in names:
        monkeypatch.setattr(module, name, checked(getattr(module, name)))
    S = 8 if opts.get("unification", True) else 4 * 2 * 2
    model, data, cfg, estate, params = _ea_setup(kind, S=S, **opts)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):  # the second epoch reads the first one's merged states
        params, estate = model.em_step(params, estate, data, gen, cfg)[:2]
    assert set(seen) == set(names)
    assert estate.ss.is_contiguous() and estate.lpj.is_contiguous()
