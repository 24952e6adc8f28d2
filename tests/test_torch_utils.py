"""The port's utils/ and prepost.viz: the counterparts of
tests/test_utils.py's autotable, datalog, tracing, checkpoint and grid
tests on evo_tpu_torch's modules, the bars dictionary against evo_tpu's,
and checkpoints carried between the two packages in both directions."""

import json
import os
import tarfile

import h5py
import numpy as np
import jax
import pytest
import torch

from evo_tpu.models.base import make_data as j_make_data
from evo_tpu.models.bsc import BSC as JBSC
from evo_tpu.models.sssc import SSSC as JSSSC
from evo_tpu.utils.bars import generate_bars_dict as j_generate_bars_dict
from evo_tpu.utils.checkpoint import load_checkpoint as j_load
from evo_tpu.utils.checkpoint import save_checkpoint as j_save
from evo_tpu.variational.state_init import init_states as j_init_states
from evo_tpu_torch import BSC, SSSC, convert, init_states, make_data
from evo_tpu_torch.prepost import make_grid, save_grid, scale
from evo_tpu_torch.utils import tracing
from evo_tpu_torch.utils.autotable import AutoTable
from evo_tpu_torch.utils.bars import generate_bars_dict
from evo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from evo_tpu_torch.utils.datalog import DataLog, StoreToH5, StoreToTxt, TextPrinter


# ------------------------------------------------------------- bars, grids


@pytest.mark.parametrize("H,neg", [(8, False), (12, True), (6, True)])
def test_generate_bars_dict_matches_evo_tpu(H, neg):
    np.testing.assert_array_equal(generate_bars_dict(H, neg), j_generate_bars_dict(H, neg))


def test_make_grid_shape_and_scale(rng, tmp_path):
    g = make_grid(rng.random((10, 4, 4)), ncol=4, pad=1)
    assert g.shape == (3 * 5 + 1, 4 * 5 + 1)
    assert g.min() == 0.0 and g.max() == 1.0
    assert make_grid(rng.random((3, 4, 4, 3)), ncol=2).shape == (2 * 5 + 1, 2 * 5 + 1, 3)
    np.testing.assert_array_equal(scale(np.array([2.0, 4.0, 3.0])), [0.0, 1.0, 0.5])
    save_grid(str(tmp_path / "g.png"), rng.random((6, 4, 4)), ncol=3)
    assert os.path.getsize(tmp_path / "g.png") > 0


# ------------------------------------------------------- autotable / datalog


def test_autotable_append_and_assign(tmp_path):
    f = str(tmp_path / "t.h5")
    tbl = AutoTable(f)
    assert not os.path.exists(f)  # h5py and the file wait for the first write
    tbl.append("F", 1.5)
    tbl.append("F", 2.5)
    tbl.append("W", np.ones((3, 2)))
    tbl.assign("latest", np.arange(4))
    tbl.assign("latest", np.arange(4) + 1)
    tbl.append("name", "EBSC")
    tbl.close()
    with pytest.raises(ValueError, match="closed"):
        tbl.append("F", 3.5)
    with h5py.File(f) as h5:
        np.testing.assert_allclose(h5["F"][:], [1.5, 2.5])
        assert h5["W"].shape == (1, 3, 2)
        np.testing.assert_allclose(h5["latest"][:], [[1, 2, 3, 4]])
        assert h5["name"][0] == b"EBSC"


def test_autotable_failed_append_leaves_no_phantom_row(tmp_path):
    path = str(tmp_path / "t.h5")
    tab = AutoTable(path)
    tab.append("W", np.ones((3, 2)))
    with pytest.raises(ValueError):
        tab.append("W", np.ones((4, 2)))
    tab.append("W", 2 * np.ones((3, 2)))
    tab.close()
    with h5py.File(path) as f:
        assert f["W"].shape[0] == 2
        assert np.allclose(f["W"][1], 2.0)


def test_autotable_async_writes(tmp_path):
    """Same contents; shape errors at the call site; values snapshotted
    when enqueued; close() drains the queue."""
    path = str(tmp_path / "a.h5")
    tab = AutoTable(path, async_writes=True)
    buf = np.ones((3, 2))
    tab.append("W", buf)
    buf[:] = -1.0  # changed after the enqueue: the stored row stays ones
    tab.append("W", 2 * np.ones((3, 2)))
    with pytest.raises(ValueError):
        tab.append("W", np.ones((4, 2)))
    tab.append("F", 1.5)
    tab.assign("latest", np.arange(4))
    tab.assign("latest", np.arange(4) + 1)
    tab.close()
    with h5py.File(path) as f:
        assert f["W"].shape == (2, 3, 2)
        assert np.allclose(f["W"][0], 1.0) and np.allclose(f["W"][1], 2.0)
        np.testing.assert_allclose(f["F"][:], [1.5])
        np.testing.assert_allclose(f["latest"][:], [[1, 2, 3, 4]])


def test_autotable_large_rows_get_one_row_chunks(tmp_path):
    path = str(tmp_path / "c.h5")
    tab = AutoTable(path)
    tab.append("img", np.zeros((64, 48, 3), np.float32))  # 36 KB row
    tab.append("F", 1.0)
    tab.close()
    with h5py.File(path) as f:
        assert f["img"].chunks == (1, 64, 48, 3)
        assert f["img"].compression == "gzip"


def test_datalog_routing_and_wildcard(tmp_path, capsys):
    f = str(tmp_path / "log.h5")
    txt = str(tmp_path / "log.txt")
    dlog = DataLog()
    dlog.set_handler(["*"], StoreToH5, f)
    dlog.set_handler(["F"], StoreToTxt, txt)
    dlog.set_handler(["F"], TextPrinter)
    assert not dlog.ignored("F")
    assert not dlog.ignored("anything")
    dlog.append("F", -12.0)
    dlog.append_all({"F": -11.0, "pi": 0.1})
    dlog.progress("half", completed=0.5)
    dlog.close()
    with h5py.File(f) as h5:
        np.testing.assert_allclose(h5["F"][:], [-12.0, -11.0])
        np.testing.assert_allclose(h5["pi"][:], [0.1])
    assert "F = -12.0" in open(txt).read()
    out = capsys.readouterr().out
    assert "F = -11.0" in out and "half" in out and "50%" in out


def test_datalog_ignored_without_handlers(tmp_path):
    dlog = DataLog()
    assert dlog.ignored("F")
    dlog.assign("W", 1.0)  # reaches no handler
    with pytest.raises(TypeError):
        dlog.set_handler("F", dict)
    dlog.set_handler("W", StoreToTxt, str(tmp_path / "w.txt"))
    with pytest.raises(NotImplementedError):
        dlog.assign("W", 1.0)
    dlog.close()


# ---------------------------------------------------------------- tracing


def test_tracing_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tracing.set_tracefile("trace-%04d.txt")

    def work():
        with tracing.span("work"):
            tracing.tracepoint("inside")
            return 42

    assert work() == 42
    tracing.close("traces.tgz")
    with tarfile.open("traces.tgz") as tar:
        assert tar.getnames() == ["trace-0000.txt"]
        content = tar.extractfile(tar.getmembers()[0]).read().decode()
    assert "work:begin" in content and "inside" in content and "work:end" in content
    tracing.tracepoint("after close")  # a no-op


def test_tracing_archive_is_gzip_and_merges(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for rank in range(2):
        tracing.set_tracefile(f"trace-{rank:04d}.txt")
        tracing.tracepoint(f"rank{rank}")
        tracing.close("traces.tgz")
    with open("traces.tgz", "rb") as f:
        assert f.read(2) == b"\x1f\x8b"
    with tarfile.open("traces.tgz", "r:gz") as tar:
        names = sorted(tar.getnames())
        blobs = [tar.extractfile(n).read().decode() for n in names]
    assert len(names) == 2 and "rank0" in blobs[0] and "rank1" in blobs[1]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "dt")
    tracing.set_tracefile(str(tmp_path / "trace.txt"))
    with tracing.device_trace(logdir):
        with tracing.span("my_region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    tracing.close(archive=None)
    (name,) = os.listdir(logdir)
    assert name.startswith("trace-") and name.endswith(".json")
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "my_region" for e in events)


# ------------------------------------------------------------- checkpoint


def _bsc_run(N=32, H=6, D=9, **opts):
    model = BSC(D=D, H=H, device="cpu")
    Y = np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)
    data = make_data(Y, device="cpu")
    cfg, estate = init_states(N=N, S=8, H=H, no_parents=4, device="cpu", **opts)
    params = model.standard_init(data, seed=0)
    return model, data, cfg, estate, params


def test_checkpoint_roundtrip(tmp_path):
    model, data, cfg, estate, params = _bsc_run()
    gen = torch.Generator().manual_seed(0)
    params, estate, _, _ = model.em_step(params, estate, data, gen, cfg)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, params, estate, epoch=7, seed=3)
    params2, estate2, epoch, seed = load_checkpoint(path, params_like=params)
    assert (epoch, seed) == (7, 3)
    for name in vars(params):
        assert torch.equal(getattr(params, name), getattr(params2, name))
    assert torch.equal(estate.ss, estate2.ss) and estate2.ss.dtype == torch.int8
    assert torch.equal(estate.lpj, estate2.lpj)
    # resumed training continues exactly like uninterrupted training
    a = model.em_step(params, estate, data, torch.Generator().manual_seed(1), cfg)
    b = model.em_step(params2, estate2, data, torch.Generator().manual_seed(1), cfg)
    assert float(a[2].F) == float(b[2].F)
    assert torch.equal(a[1].ss, b[1].ss)
    with pytest.raises(ValueError, match="uint32"):
        save_checkpoint(path, params, estate, epoch=7, seed=2**32)


def test_checkpoint_fingerprint_rejects_changed_config(tmp_path):
    import dataclasses as dc

    model, data, cfg, estate, params = _bsc_run()
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, params, estate, epoch=3, seed=3, cfg=cfg, model=model, data=data)
    load_checkpoint(path, params_like=params, cfg=cfg, model=model, data=data)
    cfg_mut = dc.replace(cfg, mutation_algorithm="sparseflip", bitflip_prob=0.1)
    with pytest.raises(ValueError, match="mutation_algorithm"):
        load_checkpoint(path, params_like=params, cfg=cfg_mut, model=model, data=data)
    with pytest.raises(ValueError, match="model.H"):
        load_checkpoint(path, params_like=params, cfg=cfg,
                        model=BSC(D=9, H=8, device="cpu"), data=data)
    # files written without a fingerprint skip the check
    path2 = str(tmp_path / "old.npz")
    save_checkpoint(path2, params, estate, epoch=3, seed=3)
    load_checkpoint(path2, params_like=params, cfg=cfg_mut, model=model, data=data)


def _both_sides(kind, packed):
    """The same run in both packages: data, config, states and Theta^0."""
    N, H, D = 40, 6, 9
    Y = np.random.default_rng(1).normal(size=(N, D)).astype(np.float32)
    jmodel = (JBSC if kind == "bsc" else JSSSC)(D=D, H=H)
    tmodel = (BSC if kind == "bsc" else SSSC)(D=D, H=H, device="cpu")
    jdata = j_make_data(Y, n_blocks=2)
    tdata = make_data(Y, n_blocks=2, device="cpu")
    opts = dict(N=N, S=8, H=H, no_parents=4, n_blocks=2, seed=2, packed_states=packed)
    jcfg, jstate = j_init_states(**opts)
    tcfg, tstate = init_states(device="cpu", **opts)
    np.testing.assert_array_equal(tstate.ss.numpy(), np.asarray(jstate.ss))
    jparams = jmodel.standard_init(jdata, seed=1)
    to_t = convert.params_from_numpy if kind == "bsc" else convert.sssc_params_from_numpy
    return (jmodel, jdata, jcfg, jstate, jparams), (tmodel, tdata, tcfg, tstate,
                                                    to_t(jparams, "cpu"))


def _assert_same(tparams, tstate, jparams, jstate):
    for name in vars(tparams):
        np.testing.assert_array_equal(getattr(tparams, name).numpy(),
                                      np.asarray(getattr(jparams, name)))
    np.testing.assert_array_equal(tstate.ss.numpy(), np.asarray(jstate.ss))
    np.testing.assert_array_equal(tstate.lpj.numpy(), np.asarray(jstate.lpj))


@pytest.mark.parametrize("kind,packed", [("bsc", False), ("bsc", True), ("sssc", False)])
def test_checkpoint_crosses_packages(tmp_path, kind, packed):
    (jm, jd, jc, js, jp), (tm, td, tc, ts, tp) = _both_sides(kind, packed)
    ts.lpj.normal_(generator=torch.Generator().manual_seed(0))
    js = type(js)(ss=js.ss, lpj=jax.numpy.asarray(ts.lpj.numpy()))
    seed = 12345

    # the port writes, evo_tpu reads
    p = str(tmp_path / "port.npz")
    save_checkpoint(p, tp, ts, epoch=5, seed=seed, cfg=tc, model=tm, data=td)
    jp2, js2, epoch, key = j_load(p, params_like=jp, cfg=jc, model=jm, data=jd)
    assert epoch == 5
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(key)),
                                  np.asarray(jax.random.key_data(jax.random.key(seed))))
    np.testing.assert_array_equal(np.load(p)["rng_key"], [0, seed])
    _assert_same(tp, ts, jp2, js2)

    # evo_tpu writes, the port reads
    j = str(tmp_path / "jax.npz")
    j_save(j, jp, js, 5, jax.random.key(seed), cfg=jc, model=jm, data=jd)
    tp2, ts2, epoch, got_seed = load_checkpoint(j, params_like=tp, cfg=tc, model=tm, data=td)
    assert (epoch, got_seed) == (5, seed)
    assert ts2.ss.dtype == (torch.uint8 if packed else torch.int8)
    _assert_same(tp2, ts2, jp, js)

    with np.load(p) as a, np.load(j) as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(str(a["fingerprint_json"])) == json.loads(str(b["fingerprint_json"]))
        for name in set(a.files) - {"fingerprint_json"}:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_rng_key_is_jax_key_data():
    """A seed is written as [0, seed], JAX's key_data of key(seed) in its
    default 32-bit mode (seeds above 32 bits keep their low word)."""
    for seed in (0, 5, 2**32 - 1):
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(jax.random.key(seed))),
                                      [0, seed])
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jax.random.key(2**33 + 7))),
                                  [0, 7])


def test_checkpoint_reads_byte_major_packed_states(tmp_path):
    """Packed states without packed_format (byte-major np.packbits) are
    converted to the lane-major layout."""
    from evo_tpu_torch.ops.bitpack import unpack_bits_lane

    model, data, cfg, estate, params = _bsc_run(H=11, packed_states=True)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, params, estate, epoch=2, seed=1)
    with np.load(path) as z:
        blobs = {k: z[k] for k in z.files if k != "packed_format"}
    bits = unpack_bits_lane(estate.ss, 11).numpy()
    blobs["estate_ss_packed"] = np.packbits(bits, axis=-1, bitorder="little")
    np.savez_compressed(path, **blobs)
    _, estate2, _, _ = load_checkpoint(path, params_like=params)
    assert torch.equal(estate2.ss, estate.ss)
