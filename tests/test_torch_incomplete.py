"""Incomplete data and reconstruction in the port against evo_tpu.

Exact mode (S = 2^H) has no random draws, so whole epochs with
``do_reconstruction=True`` from the same data and Theta^0 (carried over
with ``convert``) must agree to f32 rounding: F within 1e-5 |F|, every
parameter and the reconstruction within 1e-5 of their largest magnitude.
The cases: ES3C with the full ``to_learn`` and with (W, pies, sigma2), the
image apps' ES3C inpainting set; EBSC with x = x_infr and with x a strict
subset of x_infr (observed entries re-estimated, as
tests/test_reference_parity.py holds evo_tpu to the reference); and
complete data reconstructed everywhere (x = 0, the denoising set-up) for
both models.  EA-mode epochs draw from other generators than evo_tpu's, so
they are checked for finite values and for y_rec keeping the observed
entries exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from evo_tpu.models.base import make_data as j_make_data
from evo_tpu.models.bsc import BSC as JBSC, BSCParams as JBSCParams
from evo_tpu.models.sssc import SSSC as JSSSC, SSSCParams as JSSSCParams
from evo_tpu.variational.state_init import init_states as j_init_states
from evo_tpu_torch import BSC, SSSC, convert, init_states, make_data

N, D, H = 256, 9, 6
FULL = ("W", "pies", "mus", "sigma2", "Psi")
SUBSET = ("W", "pies", "sigma2")


def _observations(model, seed=2):
    """N datapoints of D = 9 from a random generating model of the kind."""
    rng = np.random.default_rng(seed)
    if model == "sssc":
        A = rng.normal(size=(H, H)) * 0.3
        p = JSSSCParams(W=jnp.asarray(rng.normal(size=(D, H)), jnp.float32),
                        pies=jnp.asarray(rng.uniform(0.1, 0.4, H), jnp.float32),
                        mus=jnp.asarray(rng.normal(size=H), jnp.float32),
                        Psi=jnp.asarray(A @ A.T + np.eye(H), jnp.float32),
                        sigma2=jnp.asarray(0.8, jnp.float32))
        return np.asarray(JSSSC(D=D, H=H).generate_data(jax.random.key(seed), p, N)["y"])
    p = JBSCParams(W=jnp.asarray(3.0 * rng.normal(size=(D, H)), jnp.float32),
                   pi=jnp.asarray(2.0 / H, jnp.float32), sigma=jnp.asarray(1.0, jnp.float32),
                   pies=jnp.full((H,), 2.0 / H, jnp.float32))
    return np.asarray(JBSC(D=D, H=H).generate_data(jax.random.key(seed), p, N)["y"])


def _missing(Y, frac=0.15, seed=3):
    """Y with ``frac`` of its entries set NaN, missing completely at random."""
    return np.where(np.random.default_rng(seed).random(Y.shape) < frac, np.nan, Y)


def _models(kind, to_learn=None):
    if kind == "sssc":
        tl = to_learn or FULL
        return JSSSC(D=D, H=H, to_learn=tl), SSSC(D=D, H=H, to_learn=tl, device="cpu")
    return JBSC(D=D, H=H), BSC(D=D, H=H, device="cpu")


def _close(t, j, rel=1e-5):
    j = np.asarray(j)
    err = np.abs(t.detach().cpu().numpy() - j).max()
    return err <= rel * max(np.abs(j).max(), 1e-30), err


CASES = {
    "sssc": ("sssc", FULL, "missing"),
    "sssc_w_pies_sigma2": ("sssc", SUBSET, "missing"),
    "bsc": ("bsc", None, "missing"),
    "bsc_x_subset_of_x_infr": ("bsc", None, "x_subset"),
    "sssc_complete_x0": ("sssc", FULL, "complete"),
    "bsc_complete_x0": ("bsc", None, "complete"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_exact_epochs_with_reconstruction_match_evo_tpu(case):
    kind, to_learn, layout = CASES[case]
    Y = _observations(kind)
    x = None
    if layout == "missing":
        Y = _missing(Y)
    elif layout == "x_subset":
        Y = _missing(Y)
        x = ~np.isnan(Y) & (np.random.default_rng(4).random(Y.shape) < 0.7)
    else:
        x = np.zeros(Y.shape, bool)
    jmodel, tmodel = _models(kind, to_learn)
    jdata = j_make_data(Y, x=x, n_blocks=2)
    assert jdata.incomplete == (layout != "complete")
    jcfg, jstate = j_init_states(N=N, S=2**H, H=H, n_blocks=2)
    tcfg, tstate = init_states(N=N, S=2**H, H=H, n_blocks=2, device="cpu")
    jparams = jmodel.standard_init(jdata, seed=1)
    to_t = convert.sssc_params_from_numpy if kind == "sssc" else convert.params_from_numpy
    tparams, tdata = to_t(jparams, "cpu"), convert.data_from_numpy(jdata, "cpu")
    fields = list(vars(tparams))
    gen = torch.Generator().manual_seed(0)
    for e in range(3):
        jparams, jstate, jstats, jrec = jmodel.em_step(
            jparams, jstate, jdata, jax.random.key(e), jcfg, do_reconstruction=True)
        tparams, tstate, tstats, trec = tmodel.em_step(
            tparams, tstate, tdata, gen, tcfg, do_reconstruction=True)
        Fj = float(jstats.F)
        assert abs(float(tstats.F) - Fj) <= 1e-5 * abs(Fj), (e, float(tstats.F), Fj)
        for f in fields:
            ok, err = _close(getattr(tparams, f), getattr(jparams, f))
            assert ok, (e, f, err)
        assert trec.shape == tdata.y.shape
        ok, err = _close(trec, jrec)
        assert ok, (e, "y_rec", err)
    Fj = float(jmodel.free_energy(jparams, jstate, jdata))
    assert float(tmodel.free_energy(tparams, tstate, tdata)) == pytest.approx(Fj, rel=1e-5)
    Lj = float(jmodel.exact_free_energy(jparams, jdata))
    assert float(tmodel.exact_free_energy(tparams, tdata)) == pytest.approx(Lj, rel=1e-5)


@pytest.mark.parametrize("kind", ["sssc", "bsc"])
@pytest.mark.parametrize("y_host", [False, True])
def test_standard_init_on_incomplete_data_matches_evo_tpu(kind, y_host):
    """Theta^0 from the observed entries: the mean normalized by N, the
    variance over the observed entries, from the blocked data or from the
    host copy with NaN markers."""
    Y = _missing(_observations(kind))
    jmodel, tmodel = _models(kind, SUBSET if kind == "sssc" else None)
    host = Y if y_host else None
    jp = jmodel.standard_init(j_make_data(Y, n_blocks=2), seed=3, y_host=host)
    tp = tmodel.standard_init(make_data(Y, n_blocks=2, device="cpu"), seed=3, y_host=host)
    for f, v in vars(tp).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(jp, f)), err_msg=f)
    if kind == "sssc":
        assert (tp.mus.numpy() == 1.0).all()  # mus is not learned: it starts at ones


@pytest.mark.parametrize("kind", ["sssc", "bsc"])
def test_ea_epochs_on_incomplete_data(kind):
    """EA mode (S = 8, 4 parents x 2 children): F and parameters finite,
    y_rec finite and equal to y on every observed entry."""
    Y = _missing(_observations(kind))
    _, tmodel = _models(kind, SUBSET if kind == "sssc" else None)
    data = make_data(Y, n_blocks=2, device="cpu")
    cfg, estate = init_states(N=N, S=8, H=H, no_parents=4, no_children=2, n_blocks=2,
                              seed=0, device="cpu")
    params = tmodel.standard_init(data, seed=0, y_host=Y)
    gen = torch.Generator().manual_seed(1)
    Fs = []
    for _ in range(3):
        params, estate, stats, y_rec = tmodel.em_step(params, estate, data, gen, cfg,
                                                      do_reconstruction=True)
        Fs.append(float(stats.F))
        assert all(bool(torch.isfinite(v).all()) for v in vars(params).values())
        assert bool(torch.isfinite(y_rec).all())
        assert torch.equal(y_rec[data.x], data.y[data.x])
        assert float(stats.S_nunique) > 0.0
    assert np.isfinite(Fs).all(), Fs
    assert not bool((y_rec[~data.x] == 0).all())  # the missing entries were estimated


@pytest.mark.parametrize("kind", ["sssc", "bsc"])
def test_incomplete_data_need_reconstruction(kind):
    Y = _missing(_observations(kind))
    _, tmodel = _models(kind)
    data = make_data(Y, device="cpu")
    cfg, estate = init_states(N=N, S=4, H=H, no_parents=2, device="cpu")
    params = tmodel.standard_init(data, seed=0)
    with pytest.raises(ValueError, match="do_reconstruction"):
        tmodel.em_step(params, estate, data, torch.Generator(), cfg)
