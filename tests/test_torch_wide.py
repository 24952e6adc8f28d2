"""The port's wide path against evo_tpu's XLA path: the widths above the
kernels' limits (ES3C H > 128, and H > 64 on incomplete data; EBSC
H > 1024), where both packages run plain array code.

- The wide lpj against evo_tpu's ``SSSC._lpj_states`` at H = 136 (shared G)
  and H = 72 (per-datapoint G_n): states up to |s| = H, and a Psi with a
  zero row and column for unit 0, whose states are flagged.  lpj within
  1e-3 relative (f32 Gram-form cancellation), the same bad flags, kappa and
  lambda within 1e-4 of their largest magnitude.
- The re-solved statistics against evo_tpu's re-solve branch (its
  ``slot_fn``, evo_tpu/models/sssc.py:509-539) on the same merged states.
- Whole exact-mode epochs with the envelope constants patched low, so that
  H = 8 takes the wide path, against evo_tpu's exact epochs on the CPU (its
  XLA path): F within 1e-4 relative, W within 1e-3 of its largest entry,
  sigma, pi and the other parameters within 1e-4.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from evo_tpu.models import sssc as jsssc_mod
from evo_tpu.models.base import make_data as j_make_data
from evo_tpu.models.bsc import BSC as JBSC, BSCParams as JBSCParams
from evo_tpu.models.sssc import SSSC as JSSSC, SSSCParams as JSSSCParams
from evo_tpu.variational.state_init import init_states as j_init_states
from evo_tpu_torch import BSC, SSSC, convert, init_states, make_data
from evo_tpu_torch.models import bsc as bsc_mod
from evo_tpu_torch.models import sssc as sssc_mod
from evo_tpu_torch.models.sssc import sssc_lpj_wide, sssc_suffstat_wide, wide_solves
from evo_tpu_torch.ops import bsc_lpj as bsc_lpj_ops
from evo_tpu_torch.ops import sssc_lpj as sssc_lpj_ops

ARGS = ("ss", "Wty", "y2", "G", "Psi", "mus", "pil_bar")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many small ops: the tier-1
    run's workers share the cores, and a thread pool per worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(B, K, H, D, masked, seed=0):
    """Random inputs of width H: sparse states (about 3 units on), one
    dense state a datapoint (|s| = H - 1 without unit 0, then H - 5, ...),
    a state with every unit on, and a Psi whose row and column of unit 0
    are zero, so that every state holding unit 0 must be flagged."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((D, H)) / np.sqrt(D)
    P0 = rng.standard_normal((H, H)) * 0.3
    Psi = P0 @ P0.T / H + np.eye(H)
    Psi[0, :] = Psi[:, 0] = 0.0
    Y = rng.standard_normal((B, D))
    m = rng.random((B, D)) > 0.2 if masked else np.ones((B, D), bool)
    Ym = Y * m
    G = np.einsum("di,bd,dj->bij", W, m, W) if masked else W.T @ W
    ss = (rng.random((B, K, H)) < 3.0 / H).astype(np.int8)
    ss[..., 0] = 0
    ss[:, 1, 0] = 1
    for b in range(B):
        ss[b, 0, :] = 0
        ss[b, 0, 1 + rng.permutation(H - 1)[:H - 1 - 5 * b]] = 1
    ss[-1, -1, :] = 1
    f32 = np.float32
    return dict(ss=ss, Wty=(Ym @ W).astype(f32), y2=(Ym * Ym).sum(-1).astype(f32),
                G=G.astype(f32), Psi=Psi.astype(f32), mus=rng.standard_normal(H).astype(f32),
                pil_bar=(rng.standard_normal(H) - 2.0).astype(f32), s2inv=f32(0.7))


@functools.cache
def _reference(H, masked):
    """(inputs, lpj, bad, kappa, lambda) of the problem of width H, with
    evo_tpu's _lpj_states over the block (one call a width: evo_tpu's
    recursion at H = 136 takes seconds to dispatch on the CPU)."""
    p = _problem(4, 5, H, D=40, masked=masked)
    lpj, _, kappa, lam = jax.vmap(
        JSSSC._lpj_states, in_axes=(0, 0 if masked else None, 0, 0, None, None, None, None))(
        *(jnp.asarray(p[k]) for k in ("ss", "G", "Wty", "y2", "Psi", "mus")), p["s2inv"],
        jnp.asarray(p["pil_bar"]))
    lpj = np.asarray(lpj)
    # _lpj_states routes its bad states to NaN
    return p, lpj, ~np.isfinite(lpj), np.asarray(kappa), np.asarray(lam)


def _port_states(p):
    """The port's per-state kappa and lambda, scattered from wide_solves."""
    t = {k: torch.from_numpy(np.asarray(p[k])) for k in ARGS}
    B, K, H = p["ss"].shape
    kappa = torch.zeros(B * K, H)
    lam = torch.zeros(B * K, H, H)
    for c in wide_solves(t["ss"], t["Wty"], t["G"], t["Psi"], t["mus"], float(p["s2inv"])):
        rows, A, ok = c["rows"], c["A"], ~c["bad"]
        n = A.shape[1]
        eye = torch.eye(n).expand(rows.numel(), n, n)
        lam_A = torch.linalg.lu_solve(c["LU_M"], c["piv_M"], eye)
        kappa[rows[:, None], A] = torch.where(ok[:, None], float(p["s2inv"]) * c["lam_u"]
                                              + c["a"], 0.0)
        lam[rows[:, None, None], A[:, :, None], A[:, None, :]] = torch.where(
            ok[:, None, None], lam_A, 0.0)
    return kappa.reshape(B, K, H).numpy(), lam.reshape(B, K, H, H).numpy()


@pytest.mark.parametrize("H,masked", [(136, False), (72, True)])
def test_wide_lpj_matches_evo_tpu_lpj_states(H, masked):
    p, want, want_bad, kappa_w, lam_w = _reference(H, masked)
    lpj, bad = sssc_lpj_wide(*(torch.from_numpy(np.asarray(p[k])) for k in ARGS),
                             float(p["s2inv"]))
    lpj, bad = lpj.numpy(), bad.numpy() > 0
    np.testing.assert_array_equal(bad, want_bad)
    np.testing.assert_array_equal(bad, p["ss"][..., 0] == 1)
    assert np.isnan(lpj[bad]).all() and np.isfinite(lpj[~bad]).all()
    assert p["ss"][~bad].sum(-1).max() == H - 1  # a dense state was solved
    np.testing.assert_allclose(lpj[~bad], want[~bad], rtol=1e-3)
    kappa, lam = _port_states(p)
    for got, ref in ((kappa, kappa_w), (lam, lam_w)):
        err = np.abs(got[~bad] - ref[~bad]).max()
        assert err <= 1e-4 * np.abs(ref[~bad]).max(), err


@pytest.mark.parametrize("H,masked", [(136, False), (72, True)])
def test_wide_statistics_match_evo_tpu_resolve(H, masked):
    """sssc_suffstat_wide against evo_tpu's re-solve of the merged set: per
    slot, _lpj_states' kappa and lambda summed with the responsibilities."""
    p, _, _, kappa, lam = _reference(H, masked)  # nan_to_num'ed, as the branch reads them
    rs = np.random.default_rng(4).random((4, 5)).astype(np.float32)
    rs[p["ss"][..., 0] == 1] = 0.0  # the flagged states, whose lpj is floored
    rs /= rs.sum(1, keepdims=True)
    got = sssc_suffstat_wide(
        torch.from_numpy(p["ss"]), torch.from_numpy(rs),
        *(torch.from_numpy(p[k]) for k in ("Wty", "G", "Psi", "mus")), float(p["s2inv"]))
    sf = p["ss"].astype(np.float32)
    xpt_s = np.einsum("bs,bsh->bh", rs, sf)
    xpt_sz = np.einsum("bs,bsh->bh", rs, kappa)
    want = (xpt_sz, xpt_s, np.einsum("bs,bsh,bsk->hk", rs, sf, sf),
            np.einsum("bs,bshj->hj", rs, lam) + np.einsum("bs,bsh,bsj->hj", rs, kappa, kappa),
            xpt_s.T @ xpt_sz, xpt_sz.T @ xpt_sz)
    for name, g, w in zip(("xpt_sz", "xpt_s", "xpt_ss", "xpt_szsz", "s_sz", "sz_sz"), got,
                          want):
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err)


def test_wide_solves_chunking_does_not_change_results(monkeypatch):
    """Chunks of a single state give the same lpj and statistics bit for
    bit as the default chunks."""
    p = _problem(4, 5, 72, D=40, masked=True, seed=5)
    args = [torch.from_numpy(np.asarray(p[k])) for k in ARGS]
    rs = torch.full((4, 5), 0.2)
    stat_args = (args[0], rs, args[1], args[3], args[4], args[5], float(p["s2inv"]))
    base = sssc_lpj_wide(*args, float(p["s2inv"])), sssc_suffstat_wide(*stat_args)
    monkeypatch.setattr(sssc_mod, "WIDE_CHUNK_BYTES", 1)
    tiny = sssc_lpj_wide(*args, float(p["s2inv"])), sssc_suffstat_wide(*stat_args)
    for a, b in zip(base[0] + base[1], tiny[0] + tiny[1]):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


def _no_kernel(*_, **__):
    raise AssertionError("a kernel wrapper was called on the wide path")


def _sssc_observations(H, D, N, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(H, H)) * 0.3
    p = JSSSCParams(W=jnp.asarray(rng.normal(size=(D, H)), jnp.float32),
                    pies=jnp.asarray(rng.uniform(0.1, 0.4, H), jnp.float32),
                    mus=jnp.asarray(rng.normal(size=H), jnp.float32),
                    Psi=jnp.asarray(A @ A.T + np.eye(H), jnp.float32),
                    sigma2=jnp.asarray(0.8, jnp.float32))
    return np.asarray(JSSSC(D=D, H=H).generate_data(jax.random.key(seed), p, N)["y"])


def _bsc_observations(H, D, N, seed):
    rng = np.random.default_rng(seed)
    p = JBSCParams(W=jnp.asarray(3.0 * rng.normal(size=(D, H)), jnp.float32),
                   pi=jnp.asarray(2.0 / H, jnp.float32), sigma=jnp.asarray(1.0, jnp.float32),
                   pies=jnp.full((H,), 2.0 / H, jnp.float32))
    return np.asarray(JBSC(D=D, H=H).generate_data(jax.random.key(seed), p, N)["y"])


@pytest.mark.parametrize("case", ["sssc", "sssc_incomplete", "bsc"])
def test_wide_exact_epochs_match_evo_tpu(case, monkeypatch):
    """Three exact-mode epochs (H = 8, S = 2^8) with the envelope constants
    patched below H, so that the port takes the wide path (its kernel
    wrappers would raise), against evo_tpu's exact-mode epochs on its XLA
    path; on incomplete data with reconstruction every epoch."""
    H, D, N = 8, 9, 192
    monkeypatch.setattr(sssc_lpj_ops, "MAX_H", 4)
    monkeypatch.setattr(sssc_lpj_ops, "MASKED_MAX_H", 4)
    monkeypatch.setattr(bsc_lpj_ops, "MAX_H", 4)
    for mod, names in ((sssc_mod, ("sssc_lpj", "sssc_suffstat")), (bsc_mod, ("bsc_lpj",))):
        for name in names:
            monkeypatch.setattr(mod, name, _no_kernel)
    kind = case.split("_")[0]
    if kind == "sssc":
        Y = _sssc_observations(H, D, N, seed=2)
        jmodel, tmodel = JSSSC(D=D, H=H), SSSC(D=D, H=H, device="cpu")
        to_t = convert.sssc_params_from_numpy
    else:
        Y = _bsc_observations(H, D, N, seed=2)
        jmodel, tmodel = JBSC(D=D, H=H), BSC(D=D, H=H, device="cpu")
        to_t = convert.params_from_numpy
    rec = case == "sssc_incomplete"
    if rec:
        Y = np.where(np.random.default_rng(3).random(Y.shape) < 0.15, np.nan, Y)
    jdata = j_make_data(Y, n_blocks=2)
    tdata = convert.data_from_numpy(jdata, "cpu")
    assert tmodel.wide(tdata) if kind == "sssc" else tmodel.wide()
    jcfg, jstate = j_init_states(N=N, S=2**H, H=H, n_blocks=2)
    tcfg, tstate = init_states(N=N, S=2**H, H=H, n_blocks=2, device="cpu")
    jparams = jmodel.standard_init(jdata, seed=1)
    tparams = to_t(jparams, "cpu")
    gen = torch.Generator().manual_seed(0)
    for e in range(3):
        jparams, jstate, jstats, _ = jmodel.em_step(jparams, jstate, jdata, jax.random.key(e),
                                                    jcfg, do_reconstruction=rec)
        tparams, tstate, tstats, _ = tmodel.em_step(tparams, tstate, tdata, gen, tcfg,
                                                    do_reconstruction=rec)
        Fj = float(jstats.F)
        assert abs(float(tstats.F) - Fj) <= 1e-4 * abs(Fj), (e, float(tstats.F), Fj)
        for f in vars(tparams):
            want = np.asarray(getattr(jparams, f))
            err = np.abs(getattr(tparams, f).numpy() - want).max()
            assert err <= (1e-3 if f == "W" else 1e-4) * np.abs(want).max(), (e, f, err)
    Lj = float(jmodel.exact_free_energy(jparams, jdata))
    assert float(tmodel.exact_free_energy(tparams, tdata)) == pytest.approx(Lj, rel=1e-4)


def test_bsc_ea_epoch_above_the_kernel_limit(monkeypatch):
    """EBSC at H = 1025 (the bsc_lpj kernel stops at 1024) runs an EA epoch
    with a finite F through lpj_gram, also with packed states, and never
    reaches the lpj kernel's wrapper."""
    monkeypatch.setattr(bsc_mod, "bsc_lpj", _no_kernel)
    H, D, N = 1025, 8, 16
    Y = np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)
    model, data = BSC(D=D, H=H, device="cpu"), make_data(Y, n_blocks=2, device="cpu")
    assert model.wide()
    for packed in (False, True):
        cfg, estate = init_states(N=N, S=4, H=H, no_parents=2, n_blocks=2, seed=0,
                                  device="cpu", packed_states=packed)
        params = model.standard_init(data, seed=0)
        for e in range(2):
            params, estate, stats, _ = model.em_step(params, estate, data,
                                                     torch.Generator().manual_seed(e), cfg)
            assert np.isfinite(float(stats.F)), (packed, e)
        assert estate.ss.dtype == (torch.uint8 if packed else torch.int8)


def test_sssc_resolve_branch_is_what_the_wide_path_mirrors(monkeypatch):
    """evo_tpu's re-solve branch (forced by STASH_MAX_H = 0) and the port's
    wide path agree over two exact-mode ES3C epochs at H = 6."""
    monkeypatch.setattr(jsssc_mod, "STASH_MAX_H", 0)
    monkeypatch.setattr(sssc_lpj_ops, "MAX_H", 4)
    H, D, N = 6, 7, 96
    Y = _sssc_observations(H, D, N, seed=6)
    jmodel, tmodel = JSSSC(D=D, H=H), SSSC(D=D, H=H, device="cpu")
    jdata = j_make_data(Y)
    jcfg, jstate = j_init_states(N=N, S=2**H, H=H)
    tcfg, tstate = init_states(N=N, S=2**H, H=H, device="cpu")
    jparams = jmodel.standard_init(jdata, seed=2)
    tparams, tdata = convert.sssc_params_from_numpy(jparams, "cpu"), convert.data_from_numpy(
        jdata, "cpu")
    for e in range(2):
        jparams, jstate, jstats, _ = jmodel.em_step(jparams, jstate, jdata, jax.random.key(e),
                                                    jcfg)
        tparams, tstate, tstats, _ = tmodel.em_step(tparams, tstate, tdata,
                                                    torch.Generator(), tcfg)
        assert float(tstats.F) == pytest.approx(float(jstats.F), rel=1e-4)
        for f in ("W", "pies", "mus", "Psi", "sigma2"):
            want = np.asarray(getattr(jparams, f))
            assert np.abs(getattr(tparams, f).numpy() - want).max() <= 1e-3 * np.abs(want).max()
