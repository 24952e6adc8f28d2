"""EBSC on incomplete data (each state's lpj under its own datapoint's Gram
G_n = W^T diag(m_n) W, ``lpj_gram`` in plain torch) against the benchmark's
plain float64 reference, ``portbench/reference/bsc_masked.py``, on the CPU:
a 24 x 24 gray image in 4 x 4 patches (N = 441, D = 16), 40% of the pixels
missing, H = 24, S = 8, as the image apps build it (the benchmark's image
generator), at a seeded random Theta.  One epoch's kept lpjs, F,
Theta_{t+1} (W, pi, sigma, pies), reconstruction and merged image; the
reference against ``reference/bsc.py`` on complete rows; flat patches;
the spans ``bsc.gram`` and ``bsc.masked_lpj`` and their counters; the
readers of cell ``ebsc_p8h256.inpaint`` (``portbench/metrics/masked_bsc*``)
and their yardstick (``portbench/reference/masked_bsc_bounds.py``); and
the whole harness on a tiny cell of the same model.

Tolerances (relative; the program computes in float32, TF32 off; the
readings are this file's problem on the CPU, the control's the reference
in float32 with TF32 products):

- lpj, each state's |port - reference| over the magnitude of the terms
  its Gram form adds (the harness's measure): 1e-5.  The port reads
  2.8e-7 (y2 - 2 s.Wty + s^T G_n s in f32 over 16 entries), the control
  5.0e-4 (W s from TF32 operands).
- F, |port - reference| / |reference|: 1e-7.  The port reads 3.0e-9 (a
  sum of 441 logsumexps in f32), the control 9.5e-7.
- Theta_{t+1}, ||port - reference|| / ||reference|| on each leaf: 1e-5.
  The port reads 7.2e-9 (sigma) to 1.3e-6 (W: the f32 equilibrated
  inverse of sum <s s^T>), the control 9.4e-7 (sigma) to 6.7e-4 (W).
- the reconstruction [N, D], the same measure: 1e-5.  The port reads
  1.8e-7 (sum_s r W s in f32), the control 1.2e-4.
- the merged image (mean and median, in pixels, the port's merge of its
  reconstruction against the reference's merge of its own): 1e-3 px.  The
  port reads 8.9e-6 px, the control 5.9e-3 (mean) and 1.2e-2 px (median).

``test_tf32_products_fail_a_tolerance`` holds the control to the same
tolerances: it fails at least one of each comparison.
"""

import json
import os
import shutil
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from evo_tpu_torch import BSC, SSSC, init_states, make_data
from evo_tpu_torch.apps import images
from evo_tpu_torch.models import block_graphs
from evo_tpu_torch.models.base import block_gram
from evo_tpu_torch.models.bsc import BSCParams, lpj_gram
from evo_tpu_torch.ops import sssc_lpj as sssc_lpj_ops
from evo_tpu_torch.prepost.device_merge import DeviceMerger
from evo_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench import run as runmod  # noqa: E402
from portbench import spec  # noqa: E402
from portbench.generators import image as image_gen  # noqa: E402
from portbench.harness import Run  # noqa: E402
from portbench.reference import bounds, masked_bsc_bounds  # noqa: E402
from portbench.reference import bsc as bsc_ref  # noqa: E402
from portbench.reference import bsc_masked as ref  # noqa: E402
from portbench.reference import images as ref_images  # noqa: E402
from portbench.reference.precision import Prec  # noqa: E402

H, S, PATCH, SIZE, MISSING = 24, 8, 4, 24, 0.4
EA = dict(parent_selection="fit", mutation_algorithm="randflip", n_parents=4, n_children=1,
          n_generations=1)
CONFIG = dict(model="bsc_masked", model_class="BSC", app_algo="ebsc", patch=PATCH, H=H, S=S,
              ea=EA)
TRAFFIC = dict(task="inpainting", missing=MISSING, merge_every=3,
               image=dict(kind="gray", size=SIZE))
TOL = dict(lpj=1e-5, F=1e-7, theta=1e-5, y_rec=1e-5, image=1e-3)
CONTROL = Prec(torch.float32, tf32=True)


@pytest.fixture(autouse=True)
def _closed():
    tracing.close(archive=None)
    yield
    tracing.close(archive=None)


def _job(seed=20261019):
    """The image apps' pieces (the benchmark's generator, on the CPU) with
    a seeded random Theta in place of Theta^0: W ~ N(0, 12^2), pi = 0.15,
    sigma = 9 (pixel units, the patches DC-centred)."""
    job = image_gen.make(TRAFFIC, CONFIG, seed, torch.device("cpu"))
    D = job["data"].D
    rng = np.random.default_rng(seed + 1)
    job["params"] = BSCParams(W=torch.tensor(rng.normal(scale=12.0, size=(D, H)),
                                             dtype=torch.float32),
                              pi=torch.tensor(0.15), sigma=torch.tensor(9.0),
                              pies=torch.full((H,), 0.15))
    return job


def _rows(job):
    """The reference's rows from the raw corrupted image: (y [N, D] with 0
    at the missing entries, observed m, dc), float64 / bool."""
    Y, dc = ref_images.patches(job["ref"]["image"]["corrupted"], PATCH)
    m = ~np.isnan(Y)
    return torch.as_tensor(np.where(m, Y, 0.0)), torch.as_tensor(m), dc


def _ref_theta(params, prec=Prec()):
    return ref.checked({k: getattr(params, k) for k in ("W", "pi", "sigma")}, prec)


def _rel(p, r):
    p, r = torch.as_tensor(p).double(), torch.as_tensor(r).double()
    return float((p - r).norm() / r.norm())


def _lpj_gap(lp, want, mag):
    return float(((lp.double() - want) / mag).abs().max())


def _ref_epoch(job, ss, prec):
    """The reference's epoch on states ss [N, S, H] from Theta_t: (lpj,
    magnitude, Theta_{t+1}, F, reconstruction [N, D])."""
    y, m, _ = _rows(job)
    th = _ref_theta(job["params"], prec)
    N, D = y.shape
    sums = ref.zero_sums(D, H, prec, "cpu")
    lp, mag, y_rec = ref.block(sums, y.to(prec.dtype), m, m, torch.ones(N, dtype=torch.bool), ss,
                               th, prec, True)
    new, F = ref.finish(sums, th, prec, D, H, incomplete=True, to_learn=job["model"].to_learn)
    return lp, mag, new, float(F), y_rec


def _port_epoch(job):
    """One inpainting epoch of the port: (Theta_{t+1}, F, the kept states
    [N, S, H] and their lpj, the reconstruction [N, D])."""
    model, data = job["model"], job["data"]
    assert isinstance(model, BSC) and data.incomplete
    new, est, stats, y_rec = model.em_step(job["params"], job["estate"], data,
                                           torch.Generator().manual_seed(5), job["cfg"],
                                           do_reconstruction=True)
    return new, float(stats.F), est.ss[0], est.lpj[0], y_rec[0]


@pytest.fixture(scope="module")
def epoch():
    job = _job()
    new, F, ss, lpj, y_rec = _port_epoch(job)
    return job, new, F, ss, lpj, y_rec


def test_masked_lpj_matches_the_reference():
    """``lpj_gram`` under each datapoint's G_n, of the initial K^(n)."""
    job = _job()
    data, p = job["data"], job["params"]
    G, Wty, y2 = block_gram(p.W, data.y[0], data.x_infr[0], True)
    assert G.dim() == 3
    ss = job["estate"].ss[0]
    lp = lpj_gram(ss, Wty, y2, G, -0.5 / p.sigma**2, torch.log(p.pi / (1 - p.pi)))
    y, m, _ = _rows(job)
    want, mag = ref.lpj(y, m, ss, _ref_theta(p), Prec())
    assert _lpj_gap(lp, want, mag) < TOL["lpj"]


def test_an_inpainting_epoch_matches_the_reference(epoch):
    job, new, F, ss, lpj, y_rec = epoch
    want_lp, mag, want, want_F, want_rec = _ref_epoch(job, ss, Prec())
    assert _lpj_gap(lpj, want_lp, mag) < TOL["lpj"]  # each kept state's lpj
    assert abs(F - want_F) / abs(want_F) < TOL["F"]
    for k in ref.PARAMS:
        assert _rel(getattr(new, k), want[k]) < TOL["theta"], k
    assert _rel(y_rec, want_rec) < TOL["y_rec"]
    y, m, _ = _rows(job)
    assert torch.equal(y_rec[m], y[m].float())  # the observed entries are kept


def test_the_merged_image_matches_the_reference(epoch):
    """The port's merge (``DeviceMerger``, on the CPU) of its reconstruction
    against the reference's merge of the reference's."""
    job, _, _, ss, _, y_rec = epoch
    _, _, _, _, want_rec = _ref_epoch(job, ss, Prec())
    _, _, dc = _rows(job)
    clean = job["ref"]["image"]["clean"]
    ovp = images._patches(job["ref"]["image"]["corrupted"], SimpleNamespace(
        patch_height=PATCH, patch_width=None))
    out = DeviceMerger(ovp, clean, device="cpu")(y_rec[None], torch.as_tensor(dc).float())
    mean, median = ref_images.merge(want_rec.numpy(), dc, clean.shape, PATCH)
    assert float(np.abs(out["mean"].double().numpy() - mean).max()) < TOL["image"]
    assert float(np.abs(out["median"].double().numpy() - median).max()) < TOL["image"]


def test_tf32_products_fail_a_tolerance(epoch):
    """The reference in float32 with TF32 products, put in the program's
    place, breaks at least one tolerance of each comparison above."""
    job, _, _, ss, _, _ = epoch
    want_lp, mag, want, want_F, want_rec = _ref_epoch(job, ss, Prec())
    lp, _, got, got_F, got_rec = _ref_epoch(job, ss, CONTROL)
    assert _lpj_gap(lp, want_lp, mag) > TOL["lpj"]
    over = [abs(got_F - want_F) / abs(want_F) / TOL["F"]]
    over += [_rel(got[k], want[k]) / TOL["theta"] for k in ref.PARAMS]
    assert max(over) > 1.0
    assert _rel(got_rec, want_rec) > TOL["y_rec"]
    _, _, dc = _rows(job)
    shape = job["ref"]["image"]["clean"].shape
    a = ref_images.merge(want_rec.numpy(), dc, shape, PATCH)[0]
    b = ref_images.merge(got_rec.double().numpy(), dc, shape, PATCH)[0]
    assert float(np.abs(a - b).max()) > TOL["image"]


def test_on_complete_rows_the_reference_is_the_complete_one():
    """With every entry observed, ``bsc_masked`` gives ``reference/bsc.py``'s
    lpj, magnitude, sums, Theta_{t+1} and F on the same rows."""
    rng = np.random.default_rng(3)
    N, D = 50, 16
    y = torch.as_tensor(rng.normal(scale=20.0, size=(N, D)))
    ss = torch.as_tensor((rng.random((N, S, H)) < 0.1).astype(np.int8))
    th = bsc_ref.checked(dict(W=torch.as_tensor(rng.normal(scale=12.0, size=(D, H))),
                              pi=torch.tensor(0.15, dtype=torch.float64),
                              sigma=torch.tensor(9.0, dtype=torch.float64)), Prec())
    m = torch.ones(N, D, dtype=torch.bool)
    valid = torch.ones(N, dtype=torch.bool)
    a, b = bsc_ref.zero_sums(D, H, Prec(), "cpu"), ref.zero_sums(D, H, Prec(), "cpu")
    lp_a, mag_a = bsc_ref.block(a, y, valid, ss, th, Prec())
    lp_b, mag_b, _ = ref.block(b, y, m, torch.zeros_like(m), valid, ss, th, Prec(), False)
    torch.testing.assert_close(lp_b, lp_a, rtol=1e-13, atol=0)
    torch.testing.assert_close(mag_b, mag_a, rtol=1e-13, atol=0)
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=1e-12, atol=0)
    new_a, F_a = bsc_ref.finish(a, th, Prec(), D, H)
    new_b, F_b = ref.finish(b, th, Prec(), D, H, incomplete=False)
    for k in new_a:
        torch.testing.assert_close(new_b[k], new_a[k], rtol=1e-12, atol=0)
    torch.testing.assert_close(F_b, F_a, rtol=1e-13, atol=0)
    assert set(ref.lpj(y, m, ss, th, Prec())[0].shape) == {N, S}


def test_flat_patches_read_zero_after_the_floor():
    """A datapoint whose observed entries are all 0 (a flat patch after DC
    centring): its empty state's lpj is 0, and so is the magnitude of its
    terms, which the reference floors at the smallest normal float; the
    port's lpj of that state is exactly 0 too, so the gap reads 0, and any
    difference reads far above every limit."""
    job = _job()
    y, m, _ = _rows(job)
    flat = np.flatnonzero(((y == 0) | ~m).all(1).numpy())
    assert flat.size > 0  # the gray image's flat rectangles
    n = int(flat[0])
    ss = job["estate"].ss[0, n:n + 1].clone()
    ss[0, 0] = 0
    th = _ref_theta(job["params"])
    want, mag = ref.lpj(y[n:n + 1], m[n:n + 1], ss, th, Prec())
    assert want[0, 0] == 0.0 and mag[0, 0] == torch.finfo(torch.float64).tiny
    assert torch.equal(mag[0] > 1.0, (ss[0] != 0).any(-1))  # only empty states read 0
    p, data = job["params"], job["data"]
    G, Wty, y2 = block_gram(p.W, data.y[0, n:n + 1], data.x_infr[0, n:n + 1], True)
    lp = lpj_gram(ss, Wty, y2, G, -0.5 / p.sigma**2, torch.log(p.pi / (1 - p.pi)))
    assert lp[0, 0] == 0.0
    assert _lpj_gap(lp[:, :1], want[:, :1], mag[:, :1]) == 0.0
    assert _lpj_gap(want[:, :1] + 1e-30, want[:, :1], mag[:, :1]) > 1.0


def test_theta0_is_the_ports_standard_init():
    job = image_gen.make(TRAFFIC, CONFIG, 77, torch.device("cpu"))
    y, m, _ = _rows(job)
    Y = np.where(m.numpy(), y.numpy(), np.nan)
    want = ref.theta0(Y, 77, H, to_learn=job["model"].to_learn)
    p = job["params"]
    assert sorted(want) == sorted(ref.PARAMS)
    for k, v in want.items():
        assert _rel(getattr(p, k), v) < 1e-6, k


# ------------------------------------------------------------ spans, counters


def _traced_spans(tmp_path, model, Y, epochs=2, rec=None, S_=5):
    """The spans of ``epochs`` traced epochs of ``model`` on rows Y (NaN at
    missing entries; 2 blocks)."""
    N = Y.shape[0]
    data = make_data(Y, n_blocks=2, device="cpu")
    cfg, estate = init_states(N=N, S=S_, H=model.H, no_parents=3, no_children=1,
                              no_generations=1, n_blocks=2, seed=7, device="cpu")
    params = model.standard_init(data, seed=8, y_host=Y)
    tracing.set_tracefile(str(tmp_path / "t.txt"))
    gen = torch.Generator().manual_seed(9)
    for _ in range(epochs):
        params, estate, _, _ = model.em_step(params, estate, data, gen, cfg,
                                             do_reconstruction=data.incomplete if rec is None
                                             else rec)
    tracing.close(archive=None)
    return tracing.records().spans


def _rows_tiny(incomplete, N=48, D=9):
    rng = np.random.default_rng(6)
    Y = rng.standard_normal((N, D)).astype(np.float32)
    if incomplete:
        Y[rng.random(Y.shape) < 1.0 / 3.0] = np.nan
    return Y


def test_the_masked_ebsc_spans_count_a_hand_count(tmp_path):
    """Each block of an incomplete EBSC epoch builds G_n once, in the
    ``em_step.lpj`` of K^(n), then takes K^(n)'s lpj in ``bsc.masked_lpj``
    (24 rows, 24 x 5 states, 24 x 9 entries, 24 x 5 x 6 state entries);
    the children's lpj (24 x 3 x 1 states) is a ``bsc.masked_lpj`` in the
    ``em_step.lpj`` nested in ``em_step.ea``."""
    spans = _traced_spans(tmp_path, BSC(D=9, H=6, device="cpu"), _rows_tiny(True))
    by_id = {s.id: s for s in spans}
    grams = [s for s in spans if s.name == "bsc.gram"]
    assert len(grams) == 2 * 2  # two epochs of two blocks
    for g in grams:
        assert g.counts == {"bsc.gram_rows": 24, "bsc.gram_cells": 216}
        parent = by_id[g.parent]
        assert parent.name == "em_step.lpj" and parent.parent is None
        assert [s.name for s in spans if s.parent == parent.id] == ["bsc.gram",
                                                                     "bsc.masked_lpj"]
    lpjs = [s for s in spans if s.name == "bsc.masked_lpj"]
    assert len(lpjs) == 2 * 2 * 2
    kn = [s for s in lpjs if by_id[s.parent].parent is None]
    children = [s for s in lpjs if by_id[s.parent].parent is not None]
    assert len(kn) == len(children) == 4
    for s in kn:
        assert s.counts == {"bsc.masked_lpj_rows": 24, "bsc.masked_lpj_states": 120,
                            "bsc.masked_lpj_cells": 216, "bsc.masked_lpj_units": 720}
    for s in children:
        assert by_id[by_id[s.parent].parent].name == "em_step.ea"
        assert by_id[s.parent].name == "em_step.lpj"
        assert s.counts == {"bsc.masked_lpj_rows": 24, "bsc.masked_lpj_states": 72,
                            "bsc.masked_lpj_cells": 216, "bsc.masked_lpj_units": 432}


def test_tracing_changes_no_bit_of_an_incomplete_ebsc_epoch():
    Y = _rows_tiny(True)
    model = BSC(D=9, H=6, device="cpu")
    data = make_data(Y, n_blocks=2, device="cpu")
    outs = []
    for traced in (False, True):
        cfg, estate = init_states(N=48, S=5, H=6, no_parents=3, no_children=1,
                                  no_generations=1, n_blocks=2, seed=7, device="cpu")
        params = model.standard_init(data, seed=8, y_host=Y)
        if traced:
            tracing.set_tracefile(os.devnull)
        outs.append(model.em_step(params, estate, data, torch.Generator().manual_seed(9), cfg,
                                  do_reconstruction=True))
        tracing.close(archive=None)
    (p0, e0, s0, r0), (p1, e1, s1, r1) = outs
    assert all(torch.equal(getattr(p0, k), getattr(p1, k)) for k in ("W", "pi", "sigma", "pies"))
    assert torch.equal(e0.ss, e1.ss) and torch.equal(e0.lpj, e1.lpj)
    assert torch.equal(s0.F, s1.F) and torch.equal(r0, r1)


@pytest.fixture
def graphs_on_cpu(monkeypatch):
    """The graphed path on the CPU, as ``tests/test_torch_bsc_graph.py``
    stands it in: it engages, and a phase's "graph" replays the phase."""
    monkeypatch.setattr(block_graphs, "engages", lambda *a: True)
    monkeypatch.setattr(block_graphs.PhaseGraphs, "warm_up", lambda self, fn: fn())
    monkeypatch.setattr(block_graphs.PhaseGraphs, "_capture_one",
                        lambda self, fn: SimpleNamespace(replay=fn))


MINE = {"bsc.gram", "bsc.masked_lpj"}


def test_no_masked_ebsc_span_on_complete_data(tmp_path):
    """Neither span opens on complete EBSC data, with or without the
    reconstruction."""
    for rec in (False, True):
        spans = _traced_spans(tmp_path, BSC(D=9, H=6, device="cpu"), _rows_tiny(False), rec=rec)
        names = {s.name for s in spans}
        assert "em_step.lpj" in names and not names & MINE


def test_no_masked_ebsc_span_on_the_graphed_path(tmp_path, graphs_on_cpu):
    model = BSC(D=9, H=6, device="cpu")
    spans = _traced_spans(tmp_path, model, _rows_tiny(False), epochs=3)
    names = {s.name for s in spans}
    assert model._graphs is not None and model._graphs.captured
    assert "em_step.lpj" in names and not names & MINE


@pytest.mark.parametrize("wide", [False, True], ids=["kernels", "wide"])
def test_no_masked_ebsc_span_in_es3c_on_incomplete_data(tmp_path, monkeypatch, wide):
    if wide:
        monkeypatch.setattr(sssc_lpj_ops, "MASKED_MAX_H", 4)
    model = SSSC(D=9, H=6, to_learn=("W", "pies", "sigma2"), device="cpu")
    spans = _traced_spans(tmp_path, model, _rows_tiny(True))
    names = {s.name for s in spans}
    assert "em_step.lpj" in names and not names & MINE
    assert ("wide.gram" in names) == wide


# ------------------------------------------------------------ the readers


def _span(name, t, host_ms, device_ms, counts=None):
    return SimpleNamespace(name=name, begin_ns=t, end_ns=t + 5, host_self_ns=int(1e6 * host_ms),
                           device_ms=device_ms, device_self_ms=device_ms, counts=counts)


def _ctx(spans, epochs=2, peaks=bounds.PEAKS["NVIDIA H100 80GB HBM3"]):
    """A ctx whose window (markers at 5 and 1000) holds ``spans``, with a
    bsc.gram and a bsc.masked_lpj span outside it (t = 2000)."""
    outside = [_span("bsc.gram", 2000, 50.0, 50.0, {"bsc.gram_cells": 10**12}),
               _span("bsc.masked_lpj", 2001, 50.0, 50.0, {"bsc.masked_lpj_states": 10**12})]
    recs = SimpleNamespace(spans=spans + outside,
                           markers=[(5, "portbench.window:begin"), (1000, "portbench.window:end")])
    return SimpleNamespace(records=recs, epochs=epochs, window_s=0.7, peaks=peaks)


COUNTS_G = {"bsc.gram_rows": 1000, "bsc.gram_cells": 64000}
COUNTS_K = {"bsc.masked_lpj_rows": 1000, "bsc.masked_lpj_states": 64000,
            "bsc.masked_lpj_cells": 64000, "bsc.masked_lpj_units": 64000 * 256}
COUNTS_C = {"bsc.masked_lpj_rows": 1000, "bsc.masked_lpj_states": 10000,
            "bsc.masked_lpj_cells": 64000, "bsc.masked_lpj_units": 10000 * 256}
WINDOW = [_span("em_step.lpj", 10, 1.0, 20.0), _span("bsc.gram", 11, 0.5, 6.0, COUNTS_G),
          _span("bsc.masked_lpj", 12, 2.0, 3.0, COUNTS_K),
          _span("em_step.ea", 13, 1.0, 9.0), _span("em_step.lpj", 14, 0.1, 2.0),
          _span("bsc.masked_lpj", 15, 0.5, 1.0, COUNTS_C),
          _span("bsc.gram", 20, 1.5, 4.0, COUNTS_G),
          _span("bsc.masked_lpj", 21, 4.0, 5.0, COUNTS_K),
          _span("bsc.masked_lpj", 22, 0.5, 1.0, COUNTS_C),
          _span("em_step.suffstat", 30, 0.5, 1.0)]
READERS = ("masked_bsc.gram_device_ms", "masked_bsc.lpj_device_ms", "masked_bsc.host_ms",
           "masked_bsc_roofline")


def _read(name, ctx):
    return spec.reader(name)(ctx)


def test_the_masked_bsc_readers_read_the_window():
    ctx = _ctx(WINDOW)
    assert _read("masked_bsc.epoch_ms", ctx) == pytest.approx(350.0)
    assert _read("masked_bsc.gram_device_ms", ctx) == pytest.approx((6.0 + 4.0) / 2)
    assert _read("masked_bsc.lpj_device_ms", ctx) == pytest.approx((3.0 + 1.0 + 5.0 + 1.0) / 2)
    assert _read("masked_bsc.host_ms", ctx) == pytest.approx(
        (0.5 + 2.0 + 0.5 + 1.5 + 4.0 + 0.5) / 2)
    f32, _, bw = ctx.peaks
    # 5 B a data entry, H + 4 B a state, 2 D operations a state (D = 64)
    nbytes = 5 * 4 * 64000 + 2 * (64000 + 10000) * (256 + 4)
    ops = 2 * 64 * 2 * (64000 + 10000)
    least = max(nbytes / bw, ops / f32)
    device_s = (6.0 + 4.0 + 3.0 + 1.0 + 5.0 + 1.0) * 1e-3
    roof = _read("masked_bsc_roofline", ctx)
    assert roof == pytest.approx(100.0 * least / device_s)
    assert 0.0 < roof < 100.0


@pytest.mark.parametrize("name", READERS)
def test_the_masked_bsc_readers_find_nothing_without_the_spans(name):
    """A program without ``bsc.gram`` and ``bsc.masked_lpj`` (complete data,
    ES3C, or a tree from before the spans) leaves these metrics out; the
    epoch still reads."""
    ctx = _ctx([s for s in WINDOW if s.name not in MINE])
    assert _read(name, ctx) is None
    assert _read("masked_bsc.epoch_ms", ctx) == pytest.approx(350.0)
    if name == "masked_bsc_roofline":
        assert _read(name, _ctx(WINDOW, peaks=None)) is None


def test_masked_bsc_bounds_match_hand_counts():
    peaks = (10.0, 1.0, 2.0)  # f32/s, int/s, bytes/s
    counts = {"bsc.masked_lpj_rows": 3, "bsc.masked_lpj_states": 12,
              "bsc.masked_lpj_cells": 3 * 16, "bsc.masked_lpj_units": 12 * 24}
    # 5 B for each of the 48 entries, 24 + 4 B for each of the 12 states;
    # 2 x 16 operations a state
    assert masked_bsc_bounds.work(counts) == dict(f32=2 * 16 * 12.0, int=0,
                                                  bytes=5.0 * 48 + 12 * 24 + 4 * 12)
    assert masked_bsc_bounds.least_seconds(counts, peaks) == (5 * 48 + 12 * 28) / 2.0
    assert masked_bsc_bounds.least_seconds(counts, (1.0, 1.0, 1e9)) == 2 * 16 * 12.0
    assert masked_bsc_bounds.work({}) == dict(f32=0.0, int=0, bytes=0.0)
    assert masked_bsc_bounds.SPANS == ("bsc.gram", "bsc.masked_lpj")


def test_epoch_work_counts_the_suffstat_kernel_and_the_dense_products():
    nb, B, S_, D = 1, 5, 4, 16
    n = torch.full((nb, B, S_), 2.0, dtype=torch.float64)
    u = torch.full((nb, B), 3.0, dtype=torch.float64)
    ea = dict(EA, H=H)
    calls, dense = ref.epoch_work(n, u, ea, D, True, True)
    assert calls == [bounds.bsc_suffstat(n[0], B, S_, H)]  # no bsc_lpj: the lpj is plain
    K = S_ + 4
    want = (2 * B * D * H * H + 2 * B * D * H + 3 * B * D + B * K * (2 * H * H + 4 * H)
            + 2 * B * S_ * D * H + 5 * B * S_ * D + 2 * B * H * D) + 2 * H**3 + 2 * H * H * D
    assert dense == want
    c0, d0 = bsc_ref.epoch_work(n, u, ea, D, False, False)
    assert ref.epoch_work(n, u, ea, D, False, False) == (c0, d0)


# ------------------------------------------------------------ the cell and the harness


def test_the_cell_runs_the_masked_ebsc_reference_and_reads_its_metrics():
    sp = spec.load("ebsc_p8h256.inpaint")
    conf = sp["config"]
    assert (conf["model"], conf["model_class"], conf["app_algo"]) == ("bsc_masked", "BSC", "ebsc")
    assert (conf["patch"], conf["H"], conf["S"]) == (8, 256, 64)
    assert sp["workload"]["chips"] == 1
    # the traffic of es3c_p8h256.inpaint exactly, so both models see the same data
    assert sp["cell"]["traffic"] == spec.load("es3c_p8h256.inpaint")["cell"]["traffic"]
    assert [m["name"] for m in sp["per_layer"]] == ["masked_bsc.epoch_ms", *READERS]
    assert {m["name"] for m in sp["end_to_end"]} == {"peak_mem_gib", "setup_s"}
    assert set(sp["cell"]["limits"]) == {"lpj", "F", "W", "pi", "sigma", "pies", "merge", "dups",
                                         "theta0", "states0", "image", "psnr"}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with a tiny cell of the configuration:
    ``CONFIG`` on ``TRAFFIC``, limits between what the tiny run's sound
    readings and the control give at these sizes."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(Path(REPO) / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((Path(REPO) / "BENCHMARK.json").read_text())
    (root / "portbench/configs/tiny_ebsc_inpaint.json").write_text(json.dumps(CONFIG))
    bench["configs"].append(dict(name="tiny_ebsc_inpaint", source="test", reduced=[],
                                 file="portbench/configs/tiny_ebsc_inpaint.json"))
    limits = dict(lpj=1e-5, F=1e-6, W=1e-5, pi=1e-5, sigma=1e-5, pies=1e-5, merge=1e-6, dups=0,
                  theta0=1e-6, states0=0, image=1e-3, psnr=1e-4)
    cell = dict(generator="image", profile_epochs=3, traffic=TRAFFIC, limits=limits)
    (root / "portbench/cells/tiny_ebsc.inpaint.json").write_text(json.dumps(cell))
    bench["workloads"].append(dict(name="tiny_ebsc.inpaint", config="tiny_ebsc_inpaint",
                                   traffic="inpaint", chips=1, why="test"))
    for m in bench["per_layer"]:
        if m["name"].startswith("masked_bsc"):
            m["workloads"] = ["tiny_ebsc.inpaint"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _tiny_run(root, trace=False, seconds=0.2):
    run = Run("tiny_ebsc.inpaint", 987654321987, seconds, trace, torch.device("cpu"),
              time.time(), root=root)
    run.run()
    return run


def test_the_harness_judges_a_tiny_masked_ebsc_cell(tiny_root):
    """The whole harness (set-up through the image apps, the window, the
    traced stretch, the checked epoch against ``bsc_masked``): correct; the
    control, the planted half batch and an unchanged state are not; the
    readers read the traced window (no device times on the CPU)."""
    run = _tiny_run(tiny_root, trace=True)
    ok, table = runmod.judge(run.checks, run.cell["limits"])
    assert ok, table
    assert run.per_layer["masked_bsc.epoch_ms"]["value"] > 0
    assert run.per_layer["masked_bsc.host_ms"]["value"] > 0
    for name in ("masked_bsc.gram_device_ms", "masked_bsc.lpj_device_ms", "masked_bsc_roofline"):
        assert name not in run.per_layer  # no card: no device time, no peaks
    readings = run.control_readings()
    for what in ("control", "half"):
        assert not runmod.judge(readings[what], run.cell["limits"])[0], readings[what]
    assert max(readings["unchanged"][k] for k in ("W", "sigma")) > run.cell["limits"]["W"]
