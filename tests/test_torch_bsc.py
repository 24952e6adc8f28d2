"""The port's EBSC epoch against evo_tpu's.

Exact mode (S = 2^H) has no random draws, so three epochs from the same
Theta^0 and data must agree to f32 tolerance: F within 1e-4 |F| (the two
sides sum the same f32 terms in different orders and invert the W system
by different algorithms), W within 1e-3 max|W|.  EA-mode runs draw from
different generators and agree only in distribution: the bars run must
converge to the generating model's F as evo_tpu's does.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import evo_tpu_torch
from evo_tpu.models.base import make_data as j_make_data
from evo_tpu.models.bsc import BSC as JBSC, BSCParams as JParams
from evo_tpu.utils.bars import generate_bars_dict
from evo_tpu.variational.state_init import draw_initial_states as j_draw
from evo_tpu.variational.state_init import init_states as j_init_states
from evo_tpu_torch import BSC, convert, init_states, make_data
from evo_tpu_torch.variational.state_init import draw_initial_states as t_draw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's EA generator seed for the bars run: the bars test is
# init-sensitive (CLAUDE.md "Testing conventions"); seed 0 is a
# converging basin for this data, Theta^0 and K^(n) (9 of seeds 0-11 are)
EA_SEED = 0


def _bars(H=8, N=400, pi=0.25):
    D = (H // 2) ** 2
    params_gen = JParams(W=jnp.asarray(10.0 * generate_bars_dict(H), jnp.float32),
                         pi=jnp.asarray(pi, jnp.float32), sigma=jnp.asarray(1.0, jnp.float32),
                         pies=jnp.full((H,), pi, jnp.float32))
    Y = np.asarray(JBSC(D=D, H=H).generate_data(jax.random.key(0), params_gen, N)["y"])
    return D, params_gen, Y


def test_exact_mode_epochs_match_evo_tpu():
    H, N = 6, 200
    D, params_gen, Y = _bars(H=H, N=N, pi=2.0 / H)
    jmodel, tmodel = JBSC(D=D, H=H), BSC(D=D, H=H, device="cpu")
    jdata = j_make_data(Y, n_blocks=2)
    jcfg, jstate = j_init_states(N=N, S=2**H, H=H, n_blocks=2)
    assert jcfg.exact
    jparams = jmodel.standard_init(jdata, seed=1)
    tdata = convert.data_from_numpy(jdata, "cpu")
    tcfg, tstate = init_states(N=N, S=2**H, H=H, n_blocks=2, device="cpu")
    assert tcfg.exact
    np.testing.assert_array_equal(tstate.ss.numpy(), np.asarray(jstate.ss))
    tparams = convert.params_from_numpy(jparams, "cpu")
    gen = torch.Generator().manual_seed(0)
    for e in range(3):
        jparams, jstate, jstats, _ = jmodel.em_step(
            jparams, jstate, jdata, jax.random.key(e), jcfg)
        tparams, tstate, tstats, _ = tmodel.em_step(tparams, tstate, tdata, gen, tcfg)
        Fj = float(jstats.F)
        assert abs(float(tstats.F) - Fj) <= 1e-4 * abs(Fj), (e, float(tstats.F), Fj)
        Wj = np.asarray(jparams.W)
        assert np.abs(tparams.W.numpy() - Wj).max() <= 1e-3 * np.abs(Wj).max()
        assert float(tparams.sigma) == pytest.approx(float(jparams.sigma), rel=1e-4)
        assert float(tparams.pi) == pytest.approx(float(jparams.pi), rel=1e-4)
    Fj = float(jmodel.free_energy(jparams, jstate, jdata))
    Ft = float(tmodel.free_energy(tparams, tstate, tdata))
    assert Ft == pytest.approx(Fj, rel=1e-4)


def test_ea_bars_run_converges():
    """The verify recipe's bars run (H = 8, N = 400, S = 20), with evo_tpu's
    data (key 0) and Theta^0 (standard_init seed 4) carried in."""
    H, N, S = 8, 400, 20
    D, params_gen, Y = _bars(H=H, N=N)
    jmodel, tmodel = JBSC(D=D, H=H), BSC(D=D, H=H, device="cpu")
    jdata = j_make_data(Y, n_blocks=2)
    _, jstate = j_init_states(N=N, S=S, H=H, n_blocks=2, seed=4)
    cfg, estate = init_states(N=N, S=S, H=H, no_parents=10, no_children=1,
                              no_generations=1, n_blocks=2, seed=4, device="cpu")
    np.testing.assert_array_equal(estate.ss.numpy(), np.asarray(jstate.ss))
    data = convert.data_from_numpy(jdata, "cpu")
    params = convert.params_from_numpy(jmodel.standard_init(jdata, seed=4), "cpu")
    L_gen = float(jmodel.exact_free_energy(params_gen, jdata))
    L_port = float(tmodel.exact_free_energy(convert.params_from_numpy(params_gen, "cpu"), data))
    assert L_port == pytest.approx(L_gen, rel=1e-5)

    gen = torch.Generator().manual_seed(EA_SEED)
    Fs = []
    for _ in range(40):
        params, estate, stats, _ = tmodel.em_step(params, estate, data, gen, cfg)
        Fs.append(float(stats.F))
    assert abs(Fs[-1] - L_gen) <= 0.5, (Fs[-1], L_gen)
    assert Fs[-1] > Fs[0] + 10.0
    assert float(stats.S_nunique) > 0.0
    assert float(params.sigma) == pytest.approx(1.0, abs=0.1)


@pytest.mark.parametrize("exclude_allzero,background", [(False, False), (True, False),
                                                      (False, True)])
def test_initial_states_match_evo_tpu(exclude_allzero, background):
    """Same NumPy generator state -> the same unique initial states (the
    port re-checks only datapoints that had a redraw)."""
    args = (300, 12, 6, 0.2, exclude_allzero, background)
    got = t_draw(np.random.default_rng(5), *args, chunk=128)
    want = j_draw(np.random.default_rng(5), *args, chunk=128)
    np.testing.assert_array_equal(got, want)


def test_convert_round_trip():
    D, params_gen, Y = _bars(H=4, N=30)
    jdata = j_make_data(Y, n_blocks=3, pad_multiple=4)
    t = convert.data_from_numpy(jdata, "cpu")
    back = convert.data_to_numpy(t)
    for k in ("y", "x_infr", "x", "row_valid"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jdata, k)))
    p = convert.params_to_numpy(convert.params_from_numpy(params_gen, "cpu"))
    rebuilt = JParams(**{k: jnp.asarray(v) for k, v in p.items()})
    np.testing.assert_array_equal(np.asarray(rebuilt.W), np.asarray(params_gen.W))
    _, jstate = j_init_states(N=32, S=5, H=4, no_parents=3, n_blocks=4, seed=2)
    e = convert.estate_to_numpy(convert.estate_from_numpy(jstate, "cpu"))
    assert e["ss"].dtype == np.int8
    np.testing.assert_array_equal(e["ss"], np.asarray(jstate.ss))
    np.testing.assert_array_equal(e["lpj"], np.asarray(jstate.lpj))
    # make_data of the port builds the same blocks as evo_tpu's
    mine = make_data(Y, n_blocks=3, pad_multiple=4, device="cpu")
    np.testing.assert_array_equal(mine.y.numpy(), np.asarray(jdata.y))
    np.testing.assert_array_equal(mine.row_valid.numpy(), np.asarray(jdata.row_valid))


@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("y_host", [False, True])
def test_standard_init_matches_evo_tpu(missing, y_host):
    """The default Theta^0 (noisy data mean, pi = 1/H, the data's sigma) on
    complete and on incomplete data, from the blocked data or from the host
    copy, equals evo_tpu's bit for bit."""
    D, _, Y = _bars(H=6, N=90)
    if missing:
        Y = np.where(np.random.default_rng(1).random(Y.shape) < 0.2, np.nan, Y)
    host = Y if y_host else None
    want = JBSC(D=D, H=6).standard_init(j_make_data(Y, n_blocks=3), seed=2, y_host=host)
    got = BSC(D=D, H=6, device="cpu").standard_init(make_data(Y, n_blocks=3, device="cpu"),
                                                    seed=2, y_host=host)
    for f in ("W", "pi", "sigma", "pies"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_check_params_matches_evo_tpu():
    rng = np.random.default_rng(4)
    p = JParams(W=jnp.asarray(rng.normal(size=(7, 5)), jnp.float32),
                pi=jnp.asarray(1.5, jnp.float32), sigma=jnp.asarray(-2.0, jnp.float32),
                pies=jnp.asarray([0.0, 0.3, 1.0, 0.5, 2e-6], jnp.float32))
    want = JBSC(D=7, H=5).check_params(p)
    got = BSC(D=7, H=5, device="cpu").check_params(convert.params_from_numpy(p, "cpu"))
    for f in ("W", "pi", "sigma", "pies"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Y = np.zeros((4, 4), np.float32)
    for call in (lambda: BSC(D=4, H=2), lambda: make_data(Y),
                 lambda: init_states(N=4, S=2, H=4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_unported_paths_raise():
    """Incomplete data without reconstruction raise evo_tpu's ValueError,
    as evo_tpu's em_step does; nothing else raises now: packed and
    permanent states and the other merges run (tests/test_torch_eopts.py
    and tests/test_torch_packed.py hold them against evo_tpu)."""
    rng = np.random.default_rng(0)
    Y = rng.normal(size=(8, 4)).astype(np.float32)
    full = make_data(Y, device="cpu")
    Y[0, 0] = np.nan
    data = make_data(Y, device="cpu")
    model = BSC(D=4, H=3, device="cpu")
    cfg, estate = init_states(N=8, S=2, H=3, no_parents=2, device="cpu")
    with pytest.raises(ValueError, match="do_reconstruction"):
        model.em_step(None, estate, data, torch.Generator(), cfg)
    with pytest.raises(ValueError, match="do_reconstruction"):
        JBSC(D=4, H=3).em_step(None, None, j_make_data(Y), jax.random.key(0), None)
    for change in (dict(packed_states=True), dict(allzero=True), dict(background=True),
                   dict(swap_merge=True), dict(unification=False)):
        cfg_c, estate_c = init_states(N=8, S=2, H=3, no_parents=2, device="cpu", **{
            k: v for k, v in change.items() if k != "swap_merge"})
        cfg_c = dataclasses.replace(cfg_c, **change)
        stats = model.em_step(model.standard_init(full), estate_c, full, torch.Generator(),
                              cfg_c, do_reconstruction=True)[2]
        assert np.isfinite(float(stats.F)), change


def test_package_imports_without_jax_or_evo_tpu():
    """Every evo_tpu_torch module, and chip_smoke.py, imports with jax and
    evo_tpu blocked, and chip_smoke.py's source names neither."""
    code = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "evo_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import evo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(evo_tpu_torch.__path__, "evo_tpu_torch.")]
for n in names:
    importlib.import_module(n)
importlib.import_module("chip_smoke")
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "evo_tpu")]
assert not bad, bad
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
    assert evo_tpu_torch.__version__
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = {a.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert "evo_tpu_torch" in roots and not roots & {"jax", "jaxlib", "evo_tpu"}, roots


def test_apps_import_without_jax_h5py_or_matplotlib():
    """Every evo_tpu_torch module, the trainer, the bars app and the
    checkpoint among them, imports with jax, evo_tpu, h5py and matplotlib
    all blocked (the card's machine need not have h5py or matplotlib), and
    an AutoTable and a visualizer can be made before either is needed."""
    code = r"""
import importlib, pkgutil, sys, tempfile, os

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "evo_tpu", "h5py", "matplotlib"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import evo_tpu_torch
for m in pkgutil.walk_packages(evo_tpu_torch.__path__, "evo_tpu_torch."):
    importlib.import_module(m.name)
from evo_tpu_torch.apps import bars, training
from evo_tpu_torch.apps.viz import BarsVisualizer
from evo_tpu_torch.utils import checkpoint
from evo_tpu_torch.utils.autotable import AutoTable
d = tempfile.mkdtemp()
AutoTable(os.path.join(d, "t.h5")).close()
BarsVisualizer(1, d).finalize()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "evo_tpu", "h5py", "matplotlib")]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
