"""ES3C's wide path on incomplete data (H above the masked kernels'
``MASKED_MAX_H``, each state solved under its own datapoint's Gram
G_n = W^T diag(m_n) W) against the benchmark's plain float64 reference,
``portbench/reference/sssc.py``, on the CPU at H = 72 and H = 136, D = 64,
40 datapoints, S = 8 and half of the entries missing: each state's lpj and
bad flag, the six statistics, and one whole inpainting epoch's F,
Theta_{t+1} (W, pies, sigma2; mus and Psi are not learned on incomplete
data) and reconstruction.  Then the span ``wide.gram`` and its counters,
the readers of cell ``es3c_p8h256.inpaint`` and their yardstick
(``portbench/metrics/masked_wide*.py``, ``wide.gram_device_ms.py``,
``portbench/reference/masked_wide_bounds.py``) on synthetic records, and
the cell's reference, ``portbench/reference/sssc_masked.py``, on flat
patches.

Tolerances (relative; the program computes in float32, TF32 off; the
readings are this file's problem on the CPU at H = 72 / 136, the
control's the reference in float32 with TF32 products):

- lpj, each state's |port - reference| over the magnitude of the terms it
  adds (the harness's measure): 2e-5.  The port reads 2.2e-7 / 1.6e-7
  (f32 Grams G_n and LU pivots of systems of 1-12 units), the control
  2.8e-4 / 2.2e-4.
- the six statistics, ||port - reference|| / ||reference||: 1e-5.  The
  port reads 3.8e-8 to 2.6e-7 (sums over 320 states in f32), the control
  5.1e-4 to 2.5e-3.
- Theta_{t+1} (all five leaves), the same measure: 1e-5.  The port reads
  2.6e-8 (mus, Theta_t's) to 8.2e-7 (W: the M-step's f32 inverse of
  sum <sz sz^T>), the control 2.9e-6 (sigma2) to 1.3e-3 (W) on the
  learned leaves.
- F, |port - reference| / |reference|: 3e-7.  The port reads 8.7e-8 /
  7.2e-9 (a sum of 40 logsumexps in f32), the control 3.9e-6 / 4.5e-7.
- the reconstruction [N, D], the same measure: 1e-5.  The port reads
  1.2e-7 / 1.6e-7 (<sz> W^T on the missing entries in f32), the control
  1.7e-4 / 1.3e-4.

``test_tf32_products_fail_a_tolerance`` holds the control to the same
tolerances: it fails at least one of each comparison, so each is tight
enough to see a precision below the program's.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from evo_tpu_torch import SSSC, init_states, make_data
from evo_tpu_torch.models.base import block_gram
from evo_tpu_torch.models.sssc import SSSCParams, sssc_lpj_wide, sssc_suffstat_wide
from evo_tpu_torch.ops import sssc_lpj as sssc_lpj_ops
from evo_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench import spec  # noqa: E402
from portbench.reference import bounds, masked_wide_bounds  # noqa: E402
from portbench.reference import sssc as ref  # noqa: E402
from portbench.reference import sssc_masked  # noqa: E402
from portbench.reference.precision import Prec  # noqa: E402

WIDTHS = (72, 136)
D, B, S = 64, 40, 8
MISSING = 0.5
TOL = dict(lpj=2e-5, stats=1e-5, F=3e-7, theta=1e-5, y_rec=1e-5)
STATS = ("xpt_sz", "xpt_s", "xpt_ss", "xpt_szsz", "s_sz", "sz_sz")
LEARNED = ("W", "pies", "sigma2")  # the image apps' ES3C on incomplete data
CONTROL = Prec(torch.float32, tf32=True)


@pytest.fixture(autouse=True)
def _closed():
    tracing.close(archive=None)
    yield
    tracing.close(archive=None)


def _theta(H, seed=0):
    """Theta with a Psi near the identity, pies between 0.05 and 0.3."""
    rng = np.random.default_rng(seed)
    P0 = rng.standard_normal((H, H)) * 0.3
    return dict(W=rng.standard_normal((D, H)) / np.sqrt(D) * 2.0,
                pies=rng.uniform(0.05, 0.3, H), mus=rng.standard_normal(H),
                Psi=P0 @ P0.T / H + np.eye(H), sigma2=np.float64(0.5))


def _data(theta, H, seed=1):
    """40 rows from the model at sparse states, plus noise, with half of
    the entries missing at random (NaN)."""
    rng = np.random.default_rng(seed)
    s = rng.random((B, H)) < 3.0 / H
    z = theta["mus"] + rng.standard_normal((B, H)) @ np.linalg.cholesky(theta["Psi"]).T
    Y = (s * z) @ theta["W"].T + np.sqrt(theta["sigma2"]) * rng.standard_normal((B, D))
    Y[rng.random((B, D)) < MISSING] = np.nan
    return Y


def _states(H, seed=2):
    """[B, S, H] int8: about 3 units a state, the empty state first and a
    state of 12 units second in each datapoint's set."""
    rng = np.random.default_rng(seed)
    ss = (rng.random((B, S, H)) < 3.0 / H).astype(np.int8)
    ss[:, 0] = 0
    ss[:, 1] = 0
    for b in range(B):
        ss[b, 1, rng.permutation(H)[:12]] = 1
    return torch.from_numpy(ss)


def _observed(Y):
    """(y with 0 at the missing entries, the observed mask), float64 / bool."""
    m = ~np.isnan(Y)
    return torch.as_tensor(np.where(m, Y, 0.0)), torch.as_tensor(m)


def _port_inputs(theta, Y):
    y, m = _observed(Y)
    W = torch.tensor(theta["W"], dtype=torch.float32)
    G, Wty, y2 = block_gram(W, y.float(), m, True)
    f = lambda k: torch.tensor(theta[k], dtype=torch.float32)  # noqa: E731
    pil = torch.log(f("pies") / (1.0 - f("pies")))
    return dict(Wty=Wty, y2=y2, G=G, Psi=f("Psi"), mus=f("mus"), pil_bar=pil,
                s2inv=1.0 / f("sigma2"))


def _ref_theta(theta, prec=Prec()):
    return ref.checked({k: torch.as_tensor(v) for k, v in theta.items()}, prec)


def _rel(p, r):
    p, r = torch.as_tensor(p).double(), torch.as_tensor(r).double()
    return float((p - r).norm() / r.norm())


def _lpj_gap(lp, want, mag):
    return float(((lp.double() - want) / mag).abs().max())


def _ref_stats(Y, ss, th, prec, H):
    """The reference's six statistics of the states ss under th, with its
    own responsibilities (softmax of its lpj), and that lpj."""
    sums = ref.zero_sums(D, H, prec, "cpu")
    y, m = _observed(Y)
    lp, _, _ = ref.block(sums, y.to(prec.dtype), m, m, torch.ones(B, dtype=torch.bool), ss, th,
                         prec, True)
    return {k: sums[k] for k in STATS}, lp


def _problem(H):
    theta = _theta(H)
    Y = _data(theta, H)
    return theta, Y, _states(H), _port_inputs(theta, Y)


def _lpj_reading(H):
    theta, Y, ss, p = _problem(H)
    assert H > sssc_lpj_ops.MASKED_MAX_H and p["G"].dim() == 3  # the wide path under G_n
    lp, bad = sssc_lpj_wide(ss, p["Wty"], p["y2"], p["G"], p["Psi"], p["mus"], p["pil_bar"],
                            p["s2inv"])
    y, m = _observed(Y)
    want, mag = ref.lpj(y, m, ss, _ref_theta(theta), Prec())
    return lp, bad, want, mag


@pytest.mark.parametrize("H", WIDTHS)
def test_masked_wide_lpj_and_flags_match_the_reference(H):
    lp, bad, want, mag = _lpj_reading(H)
    assert torch.isfinite(want).all()
    assert not bad.any()  # a well-conditioned Psi: no state is flagged
    assert _lpj_gap(lp, want, mag) < TOL["lpj"]


@pytest.mark.parametrize("H", WIDTHS)
def test_masked_wide_statistics_match_the_reference(H):
    theta, Y, ss, p = _problem(H)
    want, lp = _ref_stats(Y, ss, _ref_theta(theta), Prec(), H)
    rs = torch.softmax(lp, -1).float()
    xpt_sz, xpt_s, xpt_ss, xpt_szsz, s_sz, sz_sz = sssc_suffstat_wide(
        ss, rs, p["Wty"], p["G"], p["Psi"], p["mus"], p["s2inv"])
    got = dict(xpt_sz=xpt_sz.sum(0), xpt_s=xpt_s.sum(0), xpt_ss=xpt_ss, xpt_szsz=xpt_szsz,
               s_sz=s_sz, sz_sz=sz_sz)
    for k in STATS:
        assert _rel(got[k], want[k]) < TOL["stats"], k


def _epoch(theta, Y, H):
    """One inpainting epoch of the port on two blocks: (Theta_{t+1}, F,
    the merged states [2, B/2, S, H], the reconstruction [B, D])."""
    model = SSSC(D=D, H=H, to_learn=LEARNED, device="cpu")
    data = make_data(Y.astype(np.float32), n_blocks=2, device="cpu")
    cfg, estate = init_states(N=B, S=S, H=H, no_parents=4, no_children=1, no_generations=1,
                              n_blocks=2, seed=3, device="cpu")
    params = SSSCParams(**{k: torch.tensor(v, dtype=torch.float32) for k, v in theta.items()})
    assert data.incomplete and model.wide(data)
    new, est, stats, y_rec = model.em_step(params, estate, data, torch.Generator().manual_seed(4),
                                           cfg, do_reconstruction=True)
    return ({k: getattr(new, k) for k in ref.PARAMS}, float(stats.F), est.ss,
            y_rec.reshape(B, D))


def _ref_epoch(theta, Y, ss, prec, H):
    """The reference's (Theta_{t+1}, F, reconstruction) on the port's
    merged states."""
    th = _ref_theta(theta, prec)
    sums = ref.zero_sums(D, H, prec, "cpu")
    y, m = _observed(Y)
    half = B // 2
    recs = []
    for b in range(2):
        rows = slice(b * half, (b + 1) * half)
        recs.append(ref.block(sums, y[rows].to(prec.dtype), m[rows], m[rows],
                              torch.ones(half, dtype=torch.bool), ss[b], th, prec, True)[2])
    new, F = ref.finish(sums, th, prec, D, H, incomplete=True, to_learn=LEARNED)
    return new, float(F), torch.cat(recs)


@pytest.mark.parametrize("H", WIDTHS)
def test_a_masked_wide_inpainting_epoch_matches_the_reference(H):
    theta, Y, _, _ = _problem(H)
    new, F, ss, y_rec = _epoch(theta, Y, H)
    want, want_F, want_rec = _ref_epoch(theta, Y, ss, Prec(), H)
    assert abs(F - want_F) / abs(want_F) < TOL["F"]
    for k in ref.PARAMS:  # mus and Psi are Theta_t's, as the reference clamps it
        assert _rel(new[k], want[k]) < TOL["theta"], k
    assert _rel(y_rec, want_rec) < TOL["y_rec"]
    y, m = _observed(Y)
    assert torch.equal(y_rec[m], y[m].float())  # the observed entries are kept


@pytest.mark.parametrize("H", WIDTHS)
def test_tf32_products_fail_a_tolerance(H):
    """The reference in float32 with TF32 products, put in the program's
    place, breaks at least one tolerance of each comparison above."""
    theta, Y, ss, _ = _problem(H)
    y, m = _observed(Y)
    th64, th32 = _ref_theta(theta), _ref_theta(theta, CONTROL)
    want, mag = ref.lpj(y, m, ss, th64, Prec())
    lp, _ = ref.lpj(y.float(), m, ss, th32, CONTROL)
    assert _lpj_gap(lp, want, mag) > TOL["lpj"]
    want_s, _ = _ref_stats(Y, ss, th64, Prec(), H)
    got_s, _ = _ref_stats(Y, ss, th32, CONTROL, H)
    assert max(_rel(got_s[k], want_s[k]) / TOL["stats"] for k in STATS) > 1.0
    _, _, ss_out, _ = _epoch(theta, Y, H)
    want_t, want_F, want_rec = _ref_epoch(theta, Y, ss_out, Prec(), H)
    got_t, got_F, got_rec = _ref_epoch(theta, Y, ss_out, CONTROL, H)
    over = [abs(got_F - want_F) / abs(want_F) / TOL["F"]]
    over += [_rel(got_t[k], want_t[k]) / TOL["theta"] for k in LEARNED]
    assert max(over) > 1.0
    assert _rel(got_rec, want_rec) > TOL["y_rec"]


# ------------------------------------------------------------ span, counters


def _epoch_spans(tmp_path, monkeypatch, incomplete, wide):
    """The spans of two traced epochs of a tiny ES3C run (H = 6, D = 9, 48
    datapoints in 2 blocks of 24) through the model's em_step, on
    incomplete data (a third of the entries missing) or complete data, on
    the wide path when ``wide`` (the limit patched below H) and on the
    kernels' path otherwise (their plain versions on the CPU)."""
    if wide:
        monkeypatch.setattr(sssc_lpj_ops, "MASKED_MAX_H" if incomplete else "MAX_H", 4)
    rng = np.random.default_rng(6)
    Y = rng.standard_normal((48, 9)).astype(np.float32)
    if incomplete:
        Y[rng.random(Y.shape) < 1.0 / 3.0] = np.nan
    model = SSSC(D=9, H=6, to_learn=LEARNED if incomplete else ref.PARAMS, device="cpu")
    data = make_data(Y, n_blocks=2, device="cpu")
    cfg, estate = init_states(N=48, S=5, H=6, no_parents=3, no_children=1, no_generations=1,
                              n_blocks=2, seed=7, device="cpu")
    params = model.standard_init(data, seed=8, y_host=Y)
    assert data.incomplete == incomplete and model.wide(data) == wide
    tracing.set_tracefile(str(tmp_path / "t.txt"))
    gen = torch.Generator().manual_seed(9)
    for _ in range(2):
        params, estate, _, _ = model.em_step(params, estate, data, gen, cfg,
                                             do_reconstruction=incomplete)
    tracing.close(archive=None)
    return tracing.records().spans


def test_wide_gram_span_counts_a_hand_count(tmp_path, monkeypatch):
    """An incomplete wide epoch builds each block's G_n once, in the
    ``em_step.lpj`` span of K^(n)'s lpj, before its ``wide.lpj``: 24 rows
    and 24 x 9 = 216 entries a block."""
    spans = _epoch_spans(tmp_path, monkeypatch, incomplete=True, wide=True)
    grams = [s for s in spans if s.name == "wide.gram"]
    assert len(grams) == 2 * 2  # two epochs of two blocks
    for g in grams:
        assert g.counts == {"wide.gram_rows": 24, "wide.gram_cells": 216}
        parent = spans[g.parent]
        assert parent.name == "em_step.lpj" and parent.parent is None
        children = [s.name for s in spans if s.parent == parent.id]
        assert children == ["wide.gram", "wide.lpj"]
    assert not [s for s in spans if s.name != "wide.gram" and s.counts
                and any(k.startswith("wide.gram") for k in s.counts)]


@pytest.mark.parametrize("incomplete,wide", [(False, True), (True, False)])
def test_no_wide_gram_span_off_the_masked_wide_path(tmp_path, monkeypatch, incomplete, wide):
    """No ``wide.gram`` on a complete wide epoch (the shared Gram) nor on
    an incomplete epoch at the masked kernels' widths (H <= 64)."""
    spans = _epoch_spans(tmp_path, monkeypatch, incomplete, wide)
    names = {s.name for s in spans}
    assert "em_step.lpj" in names and "wide.gram" not in names
    assert ("wide.lpj" in names) == wide


# ------------------------------------------------------------ the readers


def _span(name, t, host_ms, device_ms, counts=None):
    return SimpleNamespace(name=name, begin_ns=t, end_ns=t + 5, host_self_ns=int(1e6 * host_ms),
                           device_ms=device_ms, device_self_ms=device_ms, counts=counts)


def _ctx(spans, epochs=2, peaks=bounds.PEAKS["NVIDIA H100 80GB HBM3"]):
    """A ctx whose window (markers at 5 and 1000) holds ``spans``, with a
    wide.gram span outside it (t = 2000)."""
    outside = _span("wide.gram", 2000, 50.0, 50.0, {"wide.gram_cells": 10**12})
    recs = SimpleNamespace(spans=spans + [outside],
                           markers=[(5, "portbench.window:begin"), (1000, "portbench.window:end")])
    return SimpleNamespace(records=recs, epochs=epochs, window_s=0.7, peaks=peaks)


COUNTS_G = {"wide.gram_rows": 1000, "wide.gram_cells": 64000}
COUNTS_L = {"wide.groups": 3, "wide.chunks": 3, "wide.states": 1000, "wide.n1": 1500,
            "wide.n2": 2700, "wide.n3": 5700}
COUNTS_S = {"wide.groups": 2, "wide.chunks": 2, "wide.states": 800, "wide.n1": 1000,
            "wide.n2": 1600, "wide.n3": 2800}
WINDOW = [_span("em_step.lpj", 10, 1.0, 20.0), _span("wide.gram", 11, 0.5, 6.0, COUNTS_G),
          _span("wide.lpj", 12, 2.0, 3.0, COUNTS_L), _span("wide.gram", 20, 1.5, 4.0, COUNTS_G),
          _span("wide.lpj", 21, 4.0, 5.0, COUNTS_L),
          _span("em_step.suffstat", 30, 0.5, 1.0), _span("wide.suffstat", 31, 6.0, 7.0, COUNTS_S)]


def _read(name, ctx):
    return spec.reader(name)(ctx)


def test_the_masked_wide_readers_read_the_window():
    ctx = _ctx(WINDOW)
    assert _read("masked_wide.epoch_ms", ctx) == pytest.approx(350.0)
    assert _read("wide.gram_device_ms", ctx) == pytest.approx((6.0 + 4.0) / 2)
    assert _read("masked_wide.host_ms", ctx) == pytest.approx((0.5 + 1.5 + 2.0 + 4.0 + 6.0) / 2)
    f32, _, bw = ctx.peaks
    gram_s = 5 * 2 * 64000 / bw  # 4 B a value and 1 B of mask an entry read, no operations
    lpj_s = max((8 * 1500 + 12 * 1000) * 2 / bw,
                (10 / 3 * 5700 + 6 * 2700 + 13 * 1500 + 8 * 1000) * 2 / f32)
    suf_s = max((12 * 1000 + 4 * 800) / bw, (16 / 3 * 2800 + 8 * 1600 + 3 * 1000) / f32)
    device_s = (6.0 + 4.0 + 3.0 + 5.0 + 7.0) * 1e-3
    roof = _read("masked_wide_roofline", ctx)
    assert roof == pytest.approx(100.0 * (gram_s + lpj_s + suf_s) / device_s)
    assert 0.0 < roof < 100.0


@pytest.mark.parametrize("name", ["wide.gram_device_ms", "masked_wide.host_ms",
                                  "masked_wide_roofline"])
def test_the_masked_wide_readers_find_nothing_without_a_wide_gram_span(name):
    """A program without ``wide.gram`` (the wide path on complete data, or
    a tree from before the span) leaves these metrics out; the epoch still
    reads."""
    ctx = _ctx([s for s in WINDOW if s.name != "wide.gram"])
    assert _read(name, ctx) is None
    assert _read("masked_wide.epoch_ms", ctx) == pytest.approx(350.0)
    if name == "masked_wide_roofline":
        assert _read(name, _ctx(WINDOW, peaks=None)) is None


def test_masked_wide_bounds_match_hand_counts():
    peaks = (10.0, 1.0, 2.0)  # f32/s, int/s, bytes/s
    assert masked_wide_bounds.gram(64000) == dict(f32=0.0, int=0, bytes=320000.0)
    assert masked_wide_bounds.least_seconds("wide.gram", COUNTS_G, peaks) == 320000.0 / 2.0
    # the solves as wide_bounds counts them: lpj's bytes 8 n1 + 12 states
    # over 2 B/s, its operations over 10/s
    assert masked_wide_bounds.least_seconds("wide.lpj", COUNTS_L, peaks) == pytest.approx(
        max((8 * 1500 + 12 * 1000) / 2.0,
            (10 / 3 * 5700 + 6 * 2700 + 13 * 1500 + 8 * 1000) / 10.0))
    assert masked_wide_bounds.SPANS == ("wide.gram", "wide.lpj", "wide.suffstat")


# ------------------------------------------------------------ the cell's reference


def test_flat_patches_read_zero_in_the_cells_reference():
    """A datapoint whose observed entries are all 0 (a flat patch after DC
    centring) has lpj 0 for the empty state, and magnitude 0 in
    ``sssc.py``: ``sssc_masked`` keeps the magnitude above 0, so equal lpjs
    read 0 and unequal ones far above every limit; all else is sssc.py's."""
    H = WIDTHS[0]
    theta, Y, ss, _ = _problem(H)
    Y = Y.copy()
    Y[0] = np.where(np.isnan(Y[0]), np.nan, 0.0)
    ss = ss.clone()
    ss[0, 0] = 0  # the empty state on the flat patch
    y, m = _observed(Y)
    th = _ref_theta(theta)
    want, mag = ref.lpj(y, m, ss, th, Prec())
    lp, floored = sssc_masked.lpj(y, m, ss, th, Prec())
    assert want[0, 0] == 0.0 and mag[0, 0] == 0.0 and floored[0, 0] > 0.0
    assert torch.equal(lp, want) and torch.equal(floored[mag > 0], mag[mag > 0])
    assert _lpj_gap(want, want, floored) == 0.0
    assert _lpj_gap(want + 1e-30, want, floored) > 1.0
    sums = {k: ref.zero_sums(D, H, Prec(), "cpu") for k in ("plain", "masked")}
    valid = torch.ones(B, dtype=torch.bool)
    a = ref.block(sums["plain"], y, m, m, valid, ss, th, Prec(), True)
    b = sssc_masked.block(sums["masked"], y, m, m, valid, ss, th, Prec(), True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2]) and (b[1] > 0).all()
    assert all(torch.equal(sums["plain"][k], sums["masked"][k]) for k in sums["plain"])


def test_the_cell_runs_the_masked_reference_and_reads_its_metrics():
    sp = spec.load("es3c_p8h256.inpaint")
    assert sp["config"]["model"] == "sssc_masked" and sp["config"]["H"] == 256
    assert sp["cell"]["traffic"] == {"task": "inpainting", "missing": 0.5, "merge_every": 10,
                                     "image": {"kind": "gray", "size": 256}}
    assert [m["name"] for m in sp["per_layer"]] == [
        "masked_wide.epoch_ms", "wide.gram_device_ms", "masked_wide.host_ms",
        "masked_wide_roofline"]
    assert {m["name"] for m in sp["end_to_end"]} == {"peak_mem_gib", "setup_s"}
