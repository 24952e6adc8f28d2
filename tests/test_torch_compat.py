"""The port's reference dict API (evo_tpu_torch/compat.py) on the CPU:
the six tests of tests/test_compat.py against it, and the same theta dict
through both packages' compat layers."""

import numpy as np
import pytest

from evo_tpu import compat as jcompat
from evo_tpu.utils.bars import generate_bars_dict
from evo_tpu_torch.compat import BSC, SSSC, init_states

CPU = dict(device="cpu")


def test_compat_bsc_reference_driver_pattern():
    H, S, N = 6, 12, 200
    D = (H // 2) ** 2
    model = BSC(D, H, S, **CPU)

    theta_gen = {"W": 8.0 * generate_bars_dict(H), "pi": 2.0 / H, "sigma": 1.0}
    data_gen = model.generate_data(theta_gen, N, seed=0)
    my_data = {"y": data_gen["y"],
               "x_infr": np.logical_not(np.isnan(data_gen["y"]))}

    theta = model.check_params(model.standard_init(my_data, seed=0))
    my_suff_stat = init_states(N, S, H, "fit", "randflip", 6, 1, 1, seed=0, **CPU)

    L_gen = model.free_energy(my_data, dict(theta_gen), my_suff_stat, full=True)

    Fs = []
    for e in range(15):
        F, S_nunique, S_sub, theta = model.step(theta, my_suff_stat, my_data)
        Fs.append(F)
    assert np.isfinite(Fs).all()
    assert Fs[-1] > Fs[0]
    assert Fs[-1] <= L_gen + 1.0
    assert sorted(theta) >= ["W", "pi", "pies", "sigma"]


def test_compat_sssc_with_reconstruction():
    """evo_tpu marks its copy slow (JAX compiles each new shape); the port
    runs it eagerly at the same size in about a second."""
    H, S, N, D = 4, 8, 60, 9
    rng = np.random.default_rng(0)
    Y = rng.normal(size=(N, D)) + 2.0
    Y[::5, :3] = np.nan
    my_data = {"y": Y, "x_infr": ~np.isnan(Y), "x": ~np.isnan(Y)}

    model = SSSC(D, H, S, to_learn=["W", "pies", "sigma2"], **CPU)
    theta = model.check_params(model.standard_init(my_data, seed=0))
    my_suff_stat = init_states(N, S, H, "fit", "randflip", 4, 1, 1, seed=0, **CPU)

    for e in range(3):
        F, _, _, theta = model.step(theta, my_suff_stat, my_data, do_reconstruction=True)
    assert "y_reconstructed" in my_data
    yr = my_data["y_reconstructed"]
    assert yr.shape == Y.shape and np.isfinite(yr).all()
    obs = ~np.isnan(Y)
    np.testing.assert_allclose(yr[obs], Y[obs], rtol=1e-5)


def test_compat_exact_free_energy_matches_core():
    import torch

    from evo_tpu_torch.models.base import make_data
    from evo_tpu_torch.models.bsc import BSC as CoreBSC, BSCParams

    H, D, N = 5, 8, 30
    rng = np.random.default_rng(1)
    W = rng.normal(size=(D, H))
    Y = rng.normal(size=(N, D))
    theta = {"W": W, "pi": 0.2, "sigma": 1.0}
    compat = BSC(D, H, 2**H, **CPU)
    F1 = compat.free_energy({"y": Y}, theta, full=True)
    core = CoreBSC(D=D, H=H, **CPU)
    params = BSCParams(W=torch.as_tensor(W, dtype=torch.float32), pi=torch.tensor(0.2),
                       sigma=torch.tensor(1.0), pies=torch.full((H,), 0.2))
    F2 = float(core.exact_free_energy(params, make_data(Y, **CPU)))
    np.testing.assert_allclose(F1, F2, rtol=1e-6)


def test_compat_data_cache_sees_inplace_mutation():
    """In-place changes of my_data['y'] between steps are picked up: the
    reference dict API reads y and x fresh every step."""
    H, S, N, D = 4, 8, 40, 6
    rng = np.random.default_rng(1)
    Y = rng.normal(size=(N, D)) + 1.0
    my_data = {"y": Y}

    model = BSC(D, H, S, **CPU)
    theta = model.check_params(model.standard_init(my_data, seed=0))
    my_suff_stat = init_states(N, S, H, "fit", "randflip", 4, 1, 1, seed=0, **CPU)
    F1, _, _, _ = model.step(dict(theta), dict(my_suff_stat, estate=my_suff_stat["estate"]),
                             my_data)

    # same object, other content -> another result
    Y *= 3.0
    my_suff_stat2 = init_states(N, S, H, "fit", "randflip", 4, 1, 1, seed=0, **CPU)
    F2, _, _, _ = model.step(dict(theta), my_suff_stat2, my_data)
    assert F1 != F2

    # back to the first content -> the first result (same estate and seed)
    Y /= 3.0
    my_suff_stat3 = init_states(N, S, H, "fit", "randflip", 4, 1, 1, seed=0, **CPU)
    F3, _, _, _ = model.step(dict(theta), my_suff_stat3, my_data)
    assert F1 == F3


def test_incomplete_without_reconstruction_raises():
    """The reference's assert (bsc.py:185-189): incomplete data without
    do_reconstruction would bias W."""
    import torch

    from evo_tpu_torch.models.base import make_data
    from evo_tpu_torch.models.bsc import BSC as CoreBSC
    from evo_tpu_torch.models.sssc import SSSC as CoreSSSC
    from evo_tpu_torch.variational.state_init import init_states as core_init

    N, H, D, S = 16, 4, 5, 6
    Y = np.random.default_rng(0).normal(size=(N, D))
    Y[0, 0] = np.nan
    data = make_data(Y, **CPU)
    cfg, estate = core_init(N=N, S=S, H=H, no_parents=3, **CPU)
    for model in (CoreBSC(D=D, H=H, **CPU), CoreSSSC(D=D, H=H, **CPU)):
        params = model.standard_init(data, seed=0)
        with pytest.raises(ValueError, match="do_reconstruction"):
            model.em_step(params, estate, data, torch.Generator(), cfg)


def test_compat_n_blocks_threads_into_data():
    """init_states' n_blocks reaches the data, whose blocks must match the
    estate's (evo_tpu marks its copy slow; here it runs in about a second)."""
    rng = np.random.default_rng(0)
    N, D, H, S = 64, 9, 6, 10
    Y = rng.normal(size=(N, D))
    model = BSC(D, H, S, **CPU)
    ss = init_states(N, S, H, "fit", "randflip", 5, 1, 1, n_blocks=4, **CPU)
    theta = model.check_params(model.standard_init({"y": Y}))
    Fprev = None
    for _ in range(3):
        F, n_uni, n_sub, theta = model.step(theta, ss, {"y": Y})
        assert np.isfinite(F)
        if Fprev is not None:  # monotone up to f32 reduction noise
            assert F >= Fprev - 1e-2 * abs(Fprev), (F, Fprev)
        Fprev = F
    assert model._data.n_blocks == 4
    Ftrunc = model.free_energy({"y": Y}, theta, ss, full=False)
    assert np.isfinite(Ftrunc)


def _bars_theta(H=6, seed=3):
    """A BSC theta dict as evo_tpu's compat returns it, and data drawn from
    the bars model with evo_tpu's compat."""
    D = (H // 2) ** 2
    j = jcompat.BSC(D, H, 2**H)
    theta_gen = {"W": 8.0 * generate_bars_dict(H), "pi": 2.0 / H, "sigma": 1.0}
    Y = j.generate_data(theta_gen, 80, seed=seed)["y"]
    theta = j.check_params(j.standard_init({"y": Y}, seed=seed))
    return j, Y, theta


def test_compat_free_energy_matches_evo_tpu():
    """The same theta dict (evo_tpu's compat's) gives the same exact and
    the same truncated free energy in both compat layers, to f32 tolerance."""
    j, Y, theta = _bars_theta()
    D, H = Y.shape[1], 6
    t = BSC(D, H, 2**H, **CPU)
    np.testing.assert_allclose(t.free_energy({"y": Y}, theta, full=True),
                               j.free_energy({"y": Y}, theta, full=True), rtol=2e-6)
    # SSSC: evo_tpu's standard_init dict, its own exact F
    js = jcompat.SSSC(D, 4, 16)
    theta_s = js.check_params(js.standard_init({"y": Y}, seed=1))
    np.testing.assert_allclose(SSSC(D, 4, 16, **CPU).free_energy({"y": Y}, theta_s),
                               js.free_energy({"y": Y}, theta_s), rtol=2e-6)


@pytest.mark.parametrize("kind", ["bsc", "sssc"])
def test_compat_exact_step_matches_evo_tpu(kind):
    """One exact-mode step (S = 2^H: no EA draws) of both compat layers
    from the same theta dict gives the same F and theta within rtol 1e-5;
    evo_tpu's dict passes through the port's check_params with its keys
    and values unchanged."""
    H = 6 if kind == "bsc" else 4
    j, Y, theta = _bars_theta(H=6)
    D, N = Y.shape[1], Y.shape[0]
    if kind == "sssc":
        j = jcompat.SSSC(D, H, 2**H)
        theta = j.check_params(j.standard_init({"y": Y}, seed=2))
        t = SSSC(D, H, 2**H, **CPU)
    else:
        t = BSC(D, H, 2**H, **CPU)
    checked = t.check_params(theta)
    assert sorted(checked) == sorted(theta)
    for k in theta:
        np.testing.assert_array_equal(checked[k], np.asarray(theta[k], np.float32))

    j_ss = jcompat.init_states(N, 2**H, H, n_blocks=2)
    t_ss = init_states(N, 2**H, H, n_blocks=2, **CPU)
    assert t_ss["cfg"].exact and j_ss["cfg"].exact
    Fj, _, _, theta_j = j.step(dict(theta), j_ss, {"y": Y})
    Ft, _, _, theta_t = t.step(dict(theta), t_ss, {"y": Y})
    np.testing.assert_allclose(Ft, Fj, rtol=1e-5)
    assert sorted(theta_t) == sorted(theta_j)
    for k in theta_j:
        scale = np.abs(np.asarray(theta_j[k])).max()
        np.testing.assert_allclose(theta_t[k], theta_j[k], rtol=1e-5, atol=1e-5 * scale)
