"""The port's ES3C (SSSC) model against evo_tpu's.

Exact mode (S = 2^H) has no random draws, so three epochs from the same
Theta^0 and data must agree to f32 tolerance: F within 1e-5 |F|, every
parameter within 1e-5 of its largest magnitude (the runs differ by about
1e-6; the port's BSC tests allow 1e-4 and 1e-3).  The two sides take the
lpj by other algorithms (the port's unpivoted LU of M' against evo_tpu's
XLA path, two Schur-recursion inverses), sum the statistics in other
orders and invert the M-step systems by other means, so they agree to f32
rounding, not bit for bit.  EA-mode runs draw from different generators:
the EA run here is a sanity check (F finite and rising), not a parity check.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from evo_tpu.models.base import make_data as j_make_data
from evo_tpu.models.sssc import SSSC as JSSSC, SSSCParams as JParams
from evo_tpu.variational.state_init import EState as JEState
from evo_tpu.variational.state_init import init_states as j_init_states
from evo_tpu_torch import SSSC, SSSCParams, convert, init_states, make_data

FIELDS = ("W", "pies", "mus", "Psi", "sigma2")


def _gen_params(rng, D, H):
    A = rng.normal(size=(H, H)) * 0.3
    return JParams(W=jnp.asarray(rng.normal(size=(D, H)), jnp.float32),
                   pies=jnp.asarray(rng.uniform(0.1, 0.4, H), jnp.float32),
                   mus=jnp.asarray(rng.normal(size=H), jnp.float32),
                   Psi=jnp.asarray(A @ A.T + np.eye(H), jnp.float32),
                   sigma2=jnp.asarray(0.8, jnp.float32))


def _data(H=6, D=9, N=256, seed=2):
    rng = np.random.default_rng(seed)
    params_gen = _gen_params(rng, D, H)
    Y = np.asarray(JSSSC(D=D, H=H).generate_data(jax.random.key(seed), params_gen, N)["y"])
    return params_gen, Y


def _close(t, j, rel=1e-5):
    j = np.asarray(j)
    return np.abs(t.detach().cpu().numpy() - j).max() <= rel * max(np.abs(j).max(), 1e-30)


def test_standard_init_matches_evo_tpu():
    _, Y = _data()
    for to_learn in (("W", "pies", "mus", "sigma2", "Psi"), ("W", "pies", "sigma2")):
        jp = JSSSC(D=9, H=6, to_learn=to_learn).standard_init(j_make_data(Y, n_blocks=2), seed=3)
        tp = SSSC(D=9, H=6, to_learn=to_learn, device="cpu").standard_init(
            make_data(Y, n_blocks=2, device="cpu"), seed=3)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)))
        tp_host = SSSC(D=9, H=6, device="cpu").standard_init(
            make_data(Y, n_blocks=2, device="cpu"), seed=3, y_host=Y)
        assert float(tp_host.sigma2) == float(np.asarray(jp.sigma2))


def test_check_params_matches_evo_tpu():
    rng = np.random.default_rng(4)
    H = 5
    p = JParams(W=jnp.asarray(rng.normal(size=(7, H)), jnp.float32),
                pies=jnp.asarray([0.0, 0.3, 1.0, 0.5, 2e-6], jnp.float32),
                mus=jnp.asarray(rng.normal(size=H), jnp.float32),
                Psi=jnp.asarray(rng.normal(size=(H, H)), jnp.float32),
                sigma2=jnp.asarray(-1.0, jnp.float32))
    want = JSSSC(D=7, H=H).check_params(p)
    got = SSSC(D=7, H=H, device="cpu").check_params(convert.sssc_params_from_numpy(p, "cpu"))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_exact_mode_epochs_match_evo_tpu():
    H, D, N = 6, 9, 256
    _, Y = _data(H, D, N)
    jmodel, tmodel = JSSSC(D=D, H=H), SSSC(D=D, H=H, device="cpu")
    jdata = j_make_data(Y, n_blocks=2)
    jcfg, jstate = j_init_states(N=N, S=2**H, H=H, n_blocks=2)
    assert jcfg.exact
    jparams = jmodel.standard_init(jdata, seed=1)
    tdata = convert.data_from_numpy(jdata, "cpu")
    tcfg, tstate = init_states(N=N, S=2**H, H=H, n_blocks=2, device="cpu")
    tparams = convert.sssc_params_from_numpy(jparams, "cpu")
    gen = torch.Generator().manual_seed(0)
    for e in range(3):
        jparams, jstate, jstats, _ = jmodel.em_step(jparams, jstate, jdata, jax.random.key(e), jcfg)
        tparams, tstate, tstats, _ = tmodel.em_step(tparams, tstate, tdata, gen, tcfg)
        Fj = float(jstats.F)
        assert abs(float(tstats.F) - Fj) <= 1e-5 * abs(Fj), (e, float(tstats.F), Fj)
        for f in FIELDS:
            assert _close(getattr(tparams, f), getattr(jparams, f)), (e, f)
        for f in ("n_guard_mus_freeze", "n_guard_psi_freeze", "n_reset_nan", "n_reset_small",
                  "n_reset_inf", "n_guard_sigma_floor"):
            assert int(getattr(tstats, f)) == int(getattr(jstats, f)), (e, f)
        assert float(tstats.guard_psi_renorm) == pytest.approx(
            float(jstats.guard_psi_renorm), rel=1e-5, abs=1e-6)
    Fj = float(jmodel.free_energy(jparams, jstate, jdata))
    assert float(tmodel.free_energy(tparams, tstate, tdata)) == pytest.approx(Fj, rel=1e-5)
    Lj = float(jmodel.exact_free_energy(jparams, jdata))
    assert float(tmodel.exact_free_energy(tparams, tdata)) == pytest.approx(Lj, rel=1e-5)


def test_dying_unit_guards_match_evo_tpu():
    """A unit in no state of K^(n), with a tiny prior, has its mus and Psi
    rows frozen by the dying-unit guards, and StepStats counts them, as in
    evo_tpu (tests/test_sssc.py).  The EA is off (an exact-mode config over
    the given states), so both sides see the same K^(n)."""
    H, N, D, S = 6, 64, 9, 8
    Y = np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)
    jmodel, tmodel = JSSSC(D=D, H=H), SSSC(D=D, H=H, device="cpu")
    jdata = j_make_data(Y)
    jparams = jmodel.standard_init(jdata, seed=0)
    jparams = JParams(W=jparams.W, pies=jparams.pies.at[H - 1].set(1e-4), mus=jparams.mus,
                      Psi=jparams.Psi, sigma2=jparams.sigma2)
    _, estate = init_states(N=N, S=S, H=H, no_parents=4, seed=1, device="cpu")
    estate.ss[..., H - 1] = 0
    jstate = JEState(ss=jnp.asarray(estate.ss.numpy()), lpj=jnp.asarray(estate.lpj.numpy()))
    jcfg = dataclasses.replace(j_init_states(N=N, S=2**H, H=H)[0], S=S)
    tcfg = dataclasses.replace(init_states(N=N, S=2**H, H=H, device="cpu")[0], S=S)
    assert jcfg.exact and tcfg.exact
    jp, _, jst, _ = jmodel.em_step(jparams, jstate, jdata, jax.random.key(3), jcfg)
    tp, _, tst, _ = tmodel.em_step(convert.sssc_params_from_numpy(jparams, "cpu"), estate,
                                   convert.data_from_numpy(jdata, "cpu"),
                                   torch.Generator(), tcfg)
    assert int(tst.n_guard_mus_freeze) == int(jst.n_guard_mus_freeze) >= 1
    assert int(tst.n_guard_psi_freeze) == int(jst.n_guard_psi_freeze) >= 1
    assert float(tst.F) == pytest.approx(float(jst.F), rel=1e-5)
    for f in FIELDS:
        assert _close(getattr(tp, f), getattr(jp, f)), f


def test_ea_run_rises():
    """EA mode at H = 8, N = 512 on data from the port's generate_data, with
    a fixed generator seed: F finite and rising, counters and guards sane."""
    H, D, N = 8, 16, 512
    g = torch.Generator().manual_seed(0)
    model = SSSC(D=D, H=H, device="cpu")
    A = torch.randn(H, H, generator=g) * 0.3
    params_gen = SSSCParams(W=torch.randn(D, H, generator=g), pies=torch.full((H,), 0.2),
                            mus=torch.randn(H, generator=g), Psi=A @ A.T + torch.eye(H),
                            sigma2=torch.tensor(0.5))
    sample = model.generate_data(params_gen, N, g)
    assert sample["y"].shape == (N, D) and sample["s"].dtype == torch.bool
    data = make_data(sample["y"].numpy(), n_blocks=2, device="cpu")
    cfg, estate = init_states(N=N, S=12, H=H, no_parents=5, no_children=2, n_blocks=2,
                              seed=0, device="cpu")
    params = model.standard_init(data, seed=0)
    gen = torch.Generator().manual_seed(1)
    Fs = []
    for _ in range(6):
        params, estate, stats, _ = model.em_step(params, estate, data, gen, cfg)
        Fs.append(float(stats.F))
        assert 0 < float(stats.S_nunique) <= cfg.n_new
        assert 0 <= float(stats.S_sub) <= cfg.S
        assert int(stats.n_reset_nan) == int(stats.n_reset_inf) == 0
        assert int(stats.n_guard_mus_freeze) == int(stats.n_guard_psi_freeze) == 0
        assert float(stats.guard_psi_renorm) >= 0.0
    assert np.isfinite(Fs).all() and all(b > a for a, b in zip(Fs, Fs[1:])), Fs
    assert Fs[-1] < float(model.exact_free_energy(params_gen, data)) + 1.0
    assert np.allclose(torch.diagonal(params.Psi).numpy(), 1.0)  # the gauge fix
    assert float(model.free_energy(params, estate, data)) > Fs[0]


def test_sssc_convert_round_trip():
    params_gen, _ = _data()
    back = convert.sssc_params_to_numpy(convert.sssc_params_from_numpy(params_gen, "cpu"))
    rebuilt = JParams(**{k: jnp.asarray(v) for k, v in back.items()})
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(rebuilt, f)),
                                      np.asarray(getattr(params_gen, f)))


def test_unported_paths_raise():
    """Incomplete data without reconstruction raise evo_tpu's ValueError;
    H > 128 and incomplete data at H > 64 (evo_tpu's XLA path, not
    ported) raise NotImplementedError.  Packed and permanent states and the
    other merges run now (tests/test_torch_eopts.py and
    tests/test_torch_packed.py hold them against evo_tpu)."""
    Y = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    model = SSSC(D=4, H=3, device="cpu")
    full = make_data(Y, device="cpu")
    cfg, estate = init_states(N=8, S=2, H=3, no_parents=2, device="cpu")
    Y[0, 0] = np.nan
    incomplete = make_data(Y, device="cpu")
    with pytest.raises(ValueError, match="do_reconstruction"):
        model.em_step(None, estate, incomplete, torch.Generator(), cfg)
    with pytest.raises(ValueError, match="do_reconstruction"):
        JSSSC(D=4, H=3).em_step(None, None, j_make_data(Y), jax.random.key(0), None)
    for change in (dict(packed_states=True), dict(allzero=True), dict(swap_merge=True),
                   dict(unification=False)):
        cfg_c, estate_c = init_states(N=8, S=2, H=3, no_parents=2, device="cpu", **{
            k: v for k, v in change.items() if k != "swap_merge"})
        cfg_c = dataclasses.replace(cfg_c, **change)
        stats = model.em_step(model.standard_init(full), estate_c, full, torch.Generator(),
                              cfg_c)[2]
        assert np.isfinite(float(stats.F)), change
    for H, data in ((129, full), (65, incomplete)):
        wide = SSSC(D=4, H=H, device="cpu")
        _, wstate = init_states(N=8, S=2, H=H, no_parents=2, device="cpu")
        wcfg = dataclasses.replace(cfg, H=H)
        with pytest.raises(NotImplementedError):
            wide.em_step(None, wstate, data, torch.Generator(), wcfg, do_reconstruction=True)


def test_entry_point_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SSSC(D=4, H=2)
