"""The port's bars app and EMTrainer on the CPU (EVO_PLATFORM=cpu): the
counterparts of tests/test_apps.py's bars and trainer tests, the CLI
against examples/bars-test/main.py, and the port's trainer against
evo_tpu's on the same run in exact mode (F to 1e-4 relative, W to 1e-3 of
its largest entry, sigma and pi to 1e-4 relative)."""

import argparse
import importlib.util
import os
import sys
import tarfile
import warnings

import h5py
import numpy as np
import pytest
import torch

from evo_tpu_torch import BSC, SSSC, convert, init_states, make_data
from evo_tpu_torch.apps import bars
from evo_tpu_torch.apps.common import stdout_logger
from evo_tpu_torch.apps.training import EMTrainer, gather_reconstruction
from evo_tpu_torch.utils.datalog import DataLog, StoreToH5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("EVO_PLATFORM", "cpu")


def _ns(**kw):
    return argparse.Namespace(**kw)


def _common(**over):
    base = dict(output_directory=None, Ksize=10, parent_selection="fit",
                mutation_algorithm="randflip", no_parents=5, no_children=1,
                no_generations=1, bitflip_prob=None, no_epochs=4, seed=0, n_blocks=1,
                checkpoint_every=0, resume=None, viz_every=100, gif_framerate=None)
    base.update(over)
    return base


def _bars_args(**over):
    base = dict(algo="ebsc", H=6, bar_amp=8.0, neg_bars=False, no_data_points=100,
                pi_gen=None, sigma_gen=1.0)
    base.update(over)
    return base


def _h5(outdir, *names):
    with h5py.File(os.path.join(outdir, "training.h5"), "r") as f:
        return [np.asarray(f[n]) for n in names]


def test_bars_app_ebsc(tmp_path):
    args = _ns(**_bars_args(no_data_points=150),
               **_common(output_directory=str(tmp_path / "out")))
    out = bars.run(args)
    assert np.isfinite(out["F"]) and out["L_gen"] is not None
    F, W, Y = _h5(out["outdir"], "F", "W", "Y")
    assert F.shape == (4,) and W.shape == (4, 9, 6) and Y.shape == (1, 150, 9)
    assert float(F[-1]) == out["F"]
    assert not isinstance(sys.stdout, stdout_logger)  # the tee ends with the run


def test_bars_app_es3c(tmp_path):
    args = _ns(**_bars_args(algo="es3c", no_data_points=120, mu_gen=1.0, psi_gen=0.5),
               **_common(output_directory=str(tmp_path / "out")))
    out = bars.run(args)
    assert np.isfinite(out["F"]) and out["L_gen"] is not None
    F, Psi = _h5(out["outdir"], "F", "Psi")
    assert np.isfinite(F).all() and Psi.shape == (4, 6, 6)


def test_bars_app_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.delenv("EVO_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="EVO_PLATFORM=cpu"):
        bars.run(_ns(**_bars_args(), **_common(output_directory=str(out))))
    assert not out.exists()


def test_cli_takes_the_bars_example_flags(monkeypatch):
    """python -m evo_tpu_torch.apps.bars parses what examples/bars-test
    parses, to the same values."""
    spec = importlib.util.spec_from_file_location(
        "bars_example_main", os.path.join(REPO, "examples", "bars-test", "main.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    for argv in (["ebsc"], ["es3c", "-H", "10", "--mu_gen", "0.5", "--chunk_epochs", "4"],
                 ["ebsc", "--no_epochs", "3", "--neg_bars", "--Ksize", "7", "--tracefile",
                  "t.txt", "--resume", "c.npz", "--pi_gen", "0.1", "--viz_every", "2"]):
        monkeypatch.setattr(sys, "argv", ["main.py"] + argv)
        assert vars(bars.get_args(argv)) == vars(example.get_args())


def test_bars_app_checkpoint_resume(tmp_path):
    """A run resumed from its epoch-2 checkpoint equals the uninterrupted
    run bit for bit (epoch e draws from epoch_generator(seed, e))."""
    common = _bars_args()
    out1 = bars.run(_ns(**common, **_common(no_epochs=4, checkpoint_every=2,
                                            output_directory=str(tmp_path / "a"))))
    ckpt = os.path.join(out1["outdir"], "checkpoint.npz")
    assert int(np.load(ckpt)["epoch"]) == 4
    out2 = bars.run(_ns(**common, **_common(no_epochs=6, resume=ckpt,
                                            output_directory=str(tmp_path / "b"))))
    out3 = bars.run(_ns(**common, **_common(no_epochs=6, output_directory=str(tmp_path / "c"))))
    assert out2["F"] == out3["F"]
    for name in ("W", "sigma", "pi"):
        assert torch.equal(getattr(out2["params"], name), getattr(out3["params"], name))
    (F_b,), (F_c,) = _h5(out2["outdir"], "F"), _h5(out3["outdir"], "F")
    np.testing.assert_array_equal(F_b, F_c[4:])


def test_chunk_epochs_matches_per_epoch_run(tmp_path):
    """--chunk_epochs through em_steps: the same F and params bit for bit,
    one F row per epoch, a single W row (overwrite mode), and the
    checkpoint at the chunk boundary equal to the per-epoch run's."""
    common = _bars_args()
    out_ref = bars.run(_ns(**common, **_common(no_epochs=6, checkpoint_every=4,
                                               output_directory=str(tmp_path / "per_epoch"))))
    with pytest.warns(UserWarning, match="overwrite"):
        out_chk = bars.run(_ns(**common, **_common(
            no_epochs=6, checkpoint_every=4, chunk_epochs=4,
            output_directory=str(tmp_path / "chunked"))))
    assert out_chk["F"] == out_ref["F"]
    for name in ("W", "sigma", "pi"):
        assert torch.equal(getattr(out_chk["params"], name), getattr(out_ref["params"], name))
    F_chk, W_chk = _h5(out_chk["outdir"], "F", "W")
    (F_ref,) = _h5(out_ref["outdir"], "F")
    np.testing.assert_array_equal(F_chk, F_ref)
    assert F_chk.shape == (6,) and W_chk.shape[0] == 1
    np.testing.assert_array_equal(W_chk[0], out_ref["params"].W.numpy())
    with np.load(os.path.join(out_ref["outdir"], "checkpoint.npz")) as a, \
            np.load(os.path.join(out_chk["outdir"], "checkpoint.npz")) as b:
        assert int(a["epoch"]) == int(b["epoch"]) == 4
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _trainer_setup(tmp_path, N=100, H=6, **cfg_opts):
    rng = np.random.default_rng(0)
    Y = rng.normal(size=(N, (H // 2) ** 2)).astype(np.float32)
    model = BSC(D=Y.shape[1], H=H, device="cpu")
    data = make_data(Y, device="cpu")
    cfg, estate = init_states(N=N, S=8, H=H, no_parents=4, device="cpu", **cfg_opts)
    dlog = DataLog()
    dlog.set_handler(["*"], StoreToH5, str(tmp_path / "training.h5"))
    return model, cfg, model.standard_init(data, seed=0, y_host=Y), estate, data, dlog


@pytest.mark.parametrize("theta_append", [False, True])
def test_theta_assign_vs_append_modes(tmp_path, theta_append):
    model, cfg, params, estate, data, dlog = _trainer_setup(tmp_path)
    tr = EMTrainer(model, cfg, params, estate, data, dlog, str(tmp_path),
                   theta_append=theta_append)
    tr.run(3)
    dlog.close()
    F, W, sigma = _h5(str(tmp_path), "F", "W", "sigma")
    assert F.shape == (3,)
    assert W.shape[0] == sigma.shape[0] == (3 if theta_append else 1)
    np.testing.assert_array_equal(W[-1], tr.params.W.numpy())
    with pytest.raises(ValueError, match="theta_append=False"):
        EMTrainer(model, cfg, params, estate, data, dlog, str(tmp_path), chunk_epochs=2)


def test_tracefile_flag_produces_trace(tmp_path):
    args = _ns(**_bars_args(), **_common(no_epochs=2, output_directory=str(tmp_path / "out")))
    args.tracefile = "trace-%04d.txt"
    out = bars.run(args)
    with tarfile.open(os.path.join(out["outdir"], "traces.tgz")) as tar:
        content = tar.extractfile(tar.getmembers()[0]).read().decode()
    assert content.count("em_step:begin") == 2 and content.count("em_step:end") == 2
    assert "log:begin" in content and "epoch_callback:begin" in content


def test_device_trace_every_flag(tmp_path):
    args = _ns(**_bars_args(), **_common(no_epochs=2, output_directory=str(tmp_path / "out")))
    args.device_trace_every = 2
    out = bars.run(args)
    names = os.listdir(os.path.join(out["outdir"], "device_trace"))
    assert len(names) == 1 and names[0].endswith(".json")


def test_trainer_resume_at_final_epoch_returns_stats(tmp_path):
    common = _bars_args()
    out1 = bars.run(_ns(**common, **_common(no_epochs=4, checkpoint_every=4,
                                            output_directory=str(tmp_path / "a"))))
    out2 = bars.run(_ns(**common, **_common(
        no_epochs=4, resume=os.path.join(out1["outdir"], "checkpoint.npz"),
        output_directory=str(tmp_path / "b"))))
    # F of the checkpointed lpj under the final params: close to the last
    # logged F, which used the parameters before the last M-step
    assert np.isfinite(out2["F"])
    assert abs(out2["F"] - out1["F"]) < 1.5, (out2["F"], out1["F"])
    assert torch.equal(out2["params"].W, out1["params"].W)


def test_gather_reconstruction_drops_the_padding():
    Y = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)
    data = make_data(Y, n_blocks=2, device="cpu")  # padded to 8 rows
    assert data.y.shape == (2, 4, 3)
    np.testing.assert_array_equal(gather_reconstruction(data.y, 7), Y)


def test_bucket_overflow_warning_streak():
    """At 64 < H <= 128 (SSSC, complete data), 3 epochs in a row with
    nonzero n_reset_nan warn once; SSSC at H <= 64, on the wide path (H >
    128, or incomplete data at H > 64) and BSC never do."""
    complete = make_data(np.ones((4, 16), np.float32), device="cpu")
    incomplete = make_data(np.where(np.eye(4, 16) > 0, np.nan, 1.0), device="cpu")
    tr = EMTrainer.__new__(EMTrainer)
    tr._overflow_nan_streak, tr._overflow_warned = 0, False
    tr.model, tr.data = SSSC(D=16, H=100, device="cpu"), complete
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr._warn_bucket_overflow(3)
        tr._warn_bucket_overflow(0)  # the streak restarts
        tr._warn_bucket_overflow(5)
        tr._warn_bucket_overflow(5)
    with pytest.warns(RuntimeWarning, match="more than 16 active units"):
        tr._warn_bucket_overflow(5)
    assert tr._overflow_warned
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr._warn_bucket_overflow(5)  # once only
    for model, data in ((SSSC(D=16, H=32, device="cpu"), complete),
                        (SSSC(D=16, H=129, device="cpu"), complete),
                        (SSSC(D=16, H=100, device="cpu"), incomplete),
                        (BSC(D=16, H=100, device="cpu"), complete)):
        tr2 = EMTrainer.__new__(EMTrainer)
        tr2._overflow_nan_streak, tr2._overflow_warned = 0, False
        tr2.model, tr2.data = model, data
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            for _ in range(5):
                tr2._warn_bucket_overflow(7)


def test_trainer_matches_evo_tpu_exact_mode(tmp_path):
    """Both packages' EMTrainers on the same bars data and Theta^0 in exact
    mode (no random draw): F per epoch from each training.h5, and the final
    W, sigma and pi agree; the port runs chunk_epochs=2."""
    from evo_tpu.apps.training import EMTrainer as JTrainer
    from evo_tpu.models.base import make_data as j_make_data
    from evo_tpu.models.bsc import BSC as JBSC
    from evo_tpu.utils.datalog import DataLog as JDataLog
    from evo_tpu.utils.datalog import StoreToH5 as JStoreToH5
    from evo_tpu.variational.state_init import init_states as j_init_states
    from evo_tpu_torch.utils.bars import generate_bars_dict

    H, N, S, nb, epochs = 6, 200, 64, 2, 4
    D = (H // 2) ** 2
    rng = np.random.default_rng(5)
    s = rng.random((N, H)) <= 2.0 / H
    Y = (s @ (8.0 * generate_bars_dict(H)).T + rng.standard_normal((N, D))).astype(np.float32)

    jmodel, jdata = JBSC(D=D, H=H), j_make_data(Y, n_blocks=nb)
    jcfg, jstate = j_init_states(N=N, S=S, H=H, n_blocks=nb)
    jparams = jmodel.standard_init(jdata, seed=1)
    os.makedirs(tmp_path / "j")
    jlog = JDataLog()
    jlog.set_handler(["*"], JStoreToH5, str(tmp_path / "j" / "training.h5"))
    jtr = JTrainer(jmodel, jcfg, jparams, jstate, jdata, jlog, str(tmp_path / "j"), seed=3)
    jp, _, _ = jtr.run(epochs)
    jlog.close()

    tmodel, tdata = BSC(D=D, H=H, device="cpu"), make_data(Y, n_blocks=nb, device="cpu")
    tcfg, tstate = init_states(N=N, S=S, H=H, n_blocks=nb, device="cpu")
    assert tcfg.exact and jcfg.exact
    tlog = DataLog()
    os.makedirs(tmp_path / "t")
    tlog.set_handler(["*"], StoreToH5, str(tmp_path / "t" / "training.h5"))
    ttr = EMTrainer(tmodel, tcfg, convert.params_from_numpy(jparams, "cpu"), tstate, tdata,
                    tlog, str(tmp_path / "t"), seed=3, theta_append=False, chunk_epochs=2)
    tp, _, _ = ttr.run(epochs)
    tlog.close()

    (Fj,), (Ft,) = _h5(str(tmp_path / "j"), "F"), _h5(str(tmp_path / "t"), "F")
    assert Fj.shape == Ft.shape == (epochs,)
    np.testing.assert_allclose(Ft, Fj, rtol=1e-4)
    Wj = np.asarray(jp.W)
    assert np.abs(tp.W.numpy() - Wj).max() <= 1e-3 * np.abs(Wj).max()
    assert float(tp.sigma) == pytest.approx(float(jp.sigma), rel=1e-4)
    assert float(tp.pi) == pytest.approx(float(jp.pi), rel=1e-4)
