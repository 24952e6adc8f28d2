"""ES3C's wide path (H above the kernels' ``MAX_H``) against the benchmark's
plain float64 reference, ``portbench/reference/sssc.py``, on the CPU at
H = 136, D = 64, 40 datapoints and S = 8: each state's lpj and bad flag,
the six statistics, and one whole EA epoch's F and Theta_{t+1}.  Then the
wide path's spans and counters, and the benchmark's readers of them
(``portbench/metrics/wide*.py``) with the yardstick of its solves
(``portbench/reference/wide_bounds.py``).

Tolerances (relative; the program computes in float32, TF32 off; the
readings are this file's problem on the CPU, the control's the reference
in float32 with TF32 products):

- lpj, each state's |port - reference| over the magnitude of the terms it
  adds (the harness's measure): 2e-5.  The port reads 1.6e-7 (f32 Gram
  products and LU pivots of systems of 1-12 units), the control 2.0e-4.
- the six statistics, ||port - reference|| / ||reference||: 1e-5.  The
  port reads 3e-8 to 3.1e-7 (sums over 320 states in f32), the control
  1.6e-3 to 2.9e-3.
- Theta_{t+1}, the same measure: 1e-4.  The port reads 1.0e-7 (sigma2) to
  1.8e-5 (W: the M-step's f32 inverse of sum <sz sz^T>, ill-conditioned
  where 40 datapoints leave units barely active), the control 8.3e-5 to
  3.3e-3.
- F, |port - reference| / |reference|: 3e-7.  The port reads 3.0e-8 (a
  sum of 40 logsumexps in f32), the control 1.0e-6.

``test_tf32_products_fail_a_tolerance`` holds the control to the same
tolerances: it fails at least one of each comparison, so each is tight
enough to see a precision below the program's.
"""

import math
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from evo_tpu_torch import SSSC, init_states, make_data
from evo_tpu_torch.models import sssc as sssc_mod
from evo_tpu_torch.models.base import block_gram
from evo_tpu_torch.models.sssc import SSSCParams, sssc_lpj_wide, sssc_suffstat_wide
from evo_tpu_torch.ops import sssc_lpj as sssc_lpj_ops
from evo_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench import spec  # noqa: E402
from portbench.reference import bounds, wide_bounds  # noqa: E402
from portbench.reference import sssc as ref  # noqa: E402
from portbench.reference.precision import Prec  # noqa: E402

H, D, B, S = 136, 64, 40, 8
TOL = dict(lpj=2e-5, stats=1e-5, F=3e-7, theta=1e-4)
STATS = ("xpt_sz", "xpt_s", "xpt_ss", "xpt_szsz", "s_sz", "sz_sz")
CONTROL = Prec(torch.float32, tf32=True)


@pytest.fixture(autouse=True)
def _closed():
    tracing.close(archive=None)
    yield
    tracing.close(archive=None)


def _theta(seed=0):
    """Theta with a Psi near the identity, pies between 0.05 and 0.3."""
    rng = np.random.default_rng(seed)
    P0 = rng.standard_normal((H, H)) * 0.3
    return dict(W=rng.standard_normal((D, H)) / np.sqrt(D) * 2.0,
                pies=rng.uniform(0.05, 0.3, H), mus=rng.standard_normal(H),
                Psi=P0 @ P0.T / H + np.eye(H), sigma2=np.float64(0.5))


def _data(theta, seed=1):
    """40 rows from the model at sparse states, plus noise."""
    rng = np.random.default_rng(seed)
    s = rng.random((B, H)) < 3.0 / H
    z = theta["mus"] + rng.standard_normal((B, H)) @ np.linalg.cholesky(theta["Psi"]).T
    return (s * z) @ theta["W"].T + np.sqrt(theta["sigma2"]) * rng.standard_normal((B, D))


def _states(seed=2):
    """[B, S, H] int8: about 3 units a state, the empty state first and a
    state of 12 units second in each datapoint's set."""
    rng = np.random.default_rng(seed)
    ss = (rng.random((B, S, H)) < 3.0 / H).astype(np.int8)
    ss[:, 0] = 0
    ss[:, 1] = 0
    for b in range(B):
        ss[b, 1, rng.permutation(H)[:12]] = 1
    return torch.from_numpy(ss)


def _port_inputs(theta, Y):
    W = torch.tensor(theta["W"], dtype=torch.float32)
    G, Wty, y2 = block_gram(W, torch.tensor(Y, dtype=torch.float32), None, False)
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


def _ref_stats(Y, ss, th, prec):
    """The reference's six statistics of the states ss under th, with its
    own responsibilities (softmax of its lpj), and that lpj."""
    sums = ref.zero_sums(D, H, prec, "cpu")
    y = torch.as_tensor(Y)
    ones = torch.ones(B, D, dtype=torch.bool)
    lp, _, _ = ref.block(sums, y, ones, ~ones, torch.ones(B, dtype=torch.bool), ss, th, prec,
                         False)
    return {k: sums[k] for k in STATS}, lp


def _problem():
    theta = _theta()
    Y = _data(theta)
    return theta, Y, _states(), _port_inputs(theta, Y)


def test_wide_lpj_and_flags_match_the_reference():
    theta, Y, ss, p = _problem()
    assert H > sssc_lpj_ops.MAX_H  # the wide path, not the kernels'
    lp, bad = sssc_lpj_wide(ss, p["Wty"], p["y2"], p["G"], p["Psi"], p["mus"], p["pil_bar"],
                            p["s2inv"])
    ones = torch.ones(B, D, dtype=torch.bool)
    want, mag = ref.lpj(torch.as_tensor(Y), ones, ss, _ref_theta(theta), Prec())
    assert torch.isfinite(want).all()
    assert not bad.any()  # a well-conditioned Psi: no state is flagged
    assert _lpj_gap(lp, want, mag) < TOL["lpj"]


def test_wide_statistics_match_the_reference():
    theta, Y, ss, p = _problem()
    want, lp = _ref_stats(Y, ss, _ref_theta(theta), Prec())
    rs = torch.softmax(lp, -1).float()
    xpt_sz, xpt_s, xpt_ss, xpt_szsz, s_sz, sz_sz = sssc_suffstat_wide(
        ss, rs, p["Wty"], p["G"], p["Psi"], p["mus"], p["s2inv"])
    got = dict(xpt_sz=xpt_sz.sum(0), xpt_s=xpt_s.sum(0), xpt_ss=xpt_ss, xpt_szsz=xpt_szsz,
               s_sz=s_sz, sz_sz=sz_sz)
    for k in STATS:
        assert _rel(got[k], want[k]) < TOL["stats"], k


def _epoch(theta, Y):
    """One EA epoch of the port on two blocks at H = 136: (Theta_{t+1},
    F, the merged states [2, B/2, S, H])."""
    model = SSSC(D=D, H=H, device="cpu")
    data = make_data(Y.astype(np.float32), n_blocks=2, device="cpu")
    cfg, estate = init_states(N=B, S=S, H=H, no_parents=4, no_children=1, no_generations=1,
                              n_blocks=2, seed=3, device="cpu")
    params = SSSCParams(**{k: torch.tensor(v, dtype=torch.float32) for k, v in theta.items()})
    assert model.wide(data)
    new, est, stats, _ = model.em_step(params, estate, data, torch.Generator().manual_seed(4), cfg)
    return {k: getattr(new, k) for k in ref.PARAMS}, float(stats.F), est.ss


def _ref_epoch(theta, Y, ss, prec):
    """The reference's (Theta_{t+1}, F) on the port's merged states."""
    th = _ref_theta(theta, prec)
    sums = ref.zero_sums(D, H, prec, "cpu")
    half = B // 2
    ones = torch.ones(half, D, dtype=torch.bool)
    for b in range(2):
        ref.block(sums, torch.as_tensor(Y[b * half:(b + 1) * half]), ones, ~ones,
                  torch.ones(half, dtype=torch.bool), ss[b], th, prec, False)
    new, F = ref.finish(sums, th, prec, D, H, incomplete=False)
    return new, float(F)


def test_a_wide_epoch_matches_the_reference():
    theta, Y, _, _ = _problem()
    new, F, ss = _epoch(theta, Y)
    want, want_F = _ref_epoch(theta, Y, ss, Prec())
    assert abs(F - want_F) / abs(want_F) < TOL["F"]
    for k in ref.PARAMS:
        assert _rel(new[k], want[k]) < TOL["theta"], k


def test_tf32_products_fail_a_tolerance():
    """The reference in float32 with TF32 products, put in the program's
    place, breaks at least one tolerance of each comparison above."""
    theta, Y, ss, _ = _problem()
    ones = torch.ones(B, D, dtype=torch.bool)
    th64, th32 = _ref_theta(theta), _ref_theta(theta, CONTROL)
    want, mag = ref.lpj(torch.as_tensor(Y), ones, ss, th64, Prec())
    lp, _ = ref.lpj(torch.as_tensor(Y).float(), ones, ss, th32, CONTROL)
    assert _lpj_gap(lp, want, mag) > TOL["lpj"]
    want_s, _ = _ref_stats(Y, ss, th64, Prec())
    got_s, _ = _ref_stats(Y.astype(np.float32), ss, th32, CONTROL)
    assert max(_rel(got_s[k], want_s[k]) / TOL["stats"] for k in STATS) > 1.0
    _, _, ss_out = _epoch(theta, Y)
    want_t, want_F = _ref_epoch(theta, Y, ss_out, Prec())
    got_t, got_F = _ref_epoch(theta, Y.astype(np.float32), ss_out, CONTROL)
    over = [abs(got_F - want_F) / abs(want_F) / TOL["F"]]
    over += [_rel(got_t[k], want_t[k]) / TOL["theta"] for k in ref.PARAMS]
    assert max(over) > 1.0


# ------------------------------------------------------------ spans, counters


def _fixed_states():
    """B = 2, K = 3, H = 10 with |s| = 0, 1, 2 / 2, 3, 5."""
    ss = torch.zeros(2, 3, 10, dtype=torch.int8)
    for (b, k), units in {(0, 1): [4], (0, 2): [0, 9], (1, 0): [2, 3], (1, 1): [1, 5, 7],
                          (1, 2): [0, 2, 4, 6, 8]}.items():
        ss[b, k, units] = 1
    return ss


# groups {1, 2, 3, 5}; states 5; n: 13; n^2: 1 + 4 + 4 + 9 + 25; n^3: 1 + 8 + 8 + 27 + 125
HAND = {"wide.groups": 4, "wide.states": 5, "wide.n1": 13, "wide.n2": 43, "wide.n3": 169}


@pytest.mark.parametrize("chunk_bytes,chunks", [(256 << 20, 4), (256, 5)])
def test_counters_match_a_hand_count(tmp_path, monkeypatch, chunk_bytes, chunks):
    """At 256 bytes a chunk, the |s| = 2 group's two states take a chunk
    each (256 // (64 * 4) = 1 state), the others one chunk a group."""
    monkeypatch.setattr(sssc_mod, "WIDE_CHUNK_BYTES", chunk_bytes)
    ss = _fixed_states()
    rng = np.random.default_rng(5)
    Hs = ss.shape[-1]
    f = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=torch.float32)  # noqa: E731
    G = f(Hs, Hs)
    G = G @ G.T + Hs * torch.eye(Hs)
    Psi, mus, Wty = torch.eye(Hs), f(Hs), f(2, Hs)
    tracing.set_tracefile(str(tmp_path / "t.txt"))
    with tracing.span("em_step.lpj"):
        sssc_lpj_wide(ss, Wty, f(2).abs() + 1.0, G, Psi, mus, f(Hs), 0.5)
    with tracing.span("em_step.suffstat"):
        sssc_suffstat_wide(ss, torch.full((2, 3), 1.0 / 3.0), Wty, G, Psi, mus, 0.5)
    tracing.close(archive=None)
    spans = tracing.records().spans
    assert [s.name for s in spans] == ["em_step.lpj", "wide.lpj", "em_step.suffstat",
                                       "wide.suffstat"]
    assert spans[1].parent == 0 and spans[3].parent == 2
    for s in spans:
        want = dict(HAND, **{"wide.chunks": chunks}) if s.name.startswith("wide.") else None
        assert s.counts == want, s.name


def _trainer_spans(tmp_path, monkeypatch, wide):
    """The spans of two traced epochs of a tiny ES3C run (H = 6) through
    the model's em_step, on the wide path when ``wide`` (MAX_H patched
    below H) and on the kernels' path otherwise (their plain versions on
    the CPU)."""
    if wide:
        monkeypatch.setattr(sssc_lpj_ops, "MAX_H", 4)
    rng = np.random.default_rng(6)
    Y = rng.standard_normal((48, 9)).astype(np.float32)
    model = SSSC(D=9, H=6, device="cpu")
    data = make_data(Y, n_blocks=2, device="cpu")
    cfg, estate = init_states(N=48, S=5, H=6, no_parents=3, no_children=1, no_generations=1,
                              n_blocks=2, seed=7, device="cpu")
    params = model.standard_init(data, seed=8, y_host=Y)
    assert model.wide(data) == wide
    tracing.set_tracefile(str(tmp_path / "t.txt"))
    gen = torch.Generator().manual_seed(9)
    for _ in range(2):
        params, estate, _, _ = model.em_step(params, estate, data, gen, cfg)
    tracing.close(archive=None)
    return tracing.records().spans


def test_wide_spans_nest_in_the_phases_of_a_wide_epoch(tmp_path, monkeypatch):
    spans = _trainer_spans(tmp_path, monkeypatch, wide=True)
    names = [s.name for s in spans]
    # a block: K's lpj, the children's lpj (in the EA), the suffstat
    assert names.count("wide.lpj") == 2 * 2 * 2 and names.count("wide.suffstat") == 2 * 2
    for s in spans:
        if s.name.startswith("wide."):
            assert spans[s.parent].name == {"wide.lpj": "em_step.lpj",
                                            "wide.suffstat": "em_step.suffstat"}[s.name]
            assert s.counts["wide.states"] > 0 and set(s.counts) == set(HAND) | {"wide.chunks"}
        else:
            assert not s.counts or not any(k.startswith("wide.") for k in s.counts)


def test_no_wide_span_on_the_kernels_path(tmp_path, monkeypatch):
    spans = _trainer_spans(tmp_path, monkeypatch, wide=False)
    assert "em_step.lpj" in {s.name for s in spans}
    assert not [s for s in spans if s.name.startswith("wide.")]


# ------------------------------------------------------------ the readers


def _span(name, t, host_ms, device_ms, counts=None):
    return SimpleNamespace(name=name, begin_ns=t, end_ns=t + 5, host_self_ns=int(1e6 * host_ms),
                           device_ms=device_ms, device_self_ms=device_ms, counts=counts)


def _ctx(spans, epochs=2, peaks=bounds.PEAKS["NVIDIA H100 80GB HBM3"]):
    """A ctx whose window (markers at 5 and 1000) holds ``spans`` and an
    em_step.lpj span outside it (t = 2000)."""
    outside = _span("wide.lpj", 2000, 50.0, 50.0, {"wide.states": 10**9})
    recs = SimpleNamespace(spans=spans + [outside],
                           markers=[(5, "portbench.window:begin"), (1000, "portbench.window:end")])
    return SimpleNamespace(records=recs, epochs=epochs, window_s=0.4, peaks=peaks)


COUNTS_L = {"wide.groups": 3, "wide.chunks": 3, "wide.states": 1000, "wide.n1": 1500,
            "wide.n2": 2700, "wide.n3": 5700}
COUNTS_S = {"wide.groups": 2, "wide.chunks": 2, "wide.states": 800, "wide.n1": 1000,
            "wide.n2": 1600, "wide.n3": 2800}
WINDOW = [_span("em_step.lpj", 10, 1.0, 9.0), _span("wide.lpj", 11, 2.0, 3.0, COUNTS_L),
          _span("wide.lpj", 20, 4.0, 5.0, COUNTS_L),
          _span("em_step.suffstat", 30, 0.5, 1.0), _span("wide.suffstat", 31, 6.0, 7.0, COUNTS_S)]


def test_the_wide_readers_read_the_window():
    ctx = _ctx(WINDOW)
    read = lambda name, c=ctx: spec.reader(name)(c)  # noqa: E731
    assert read("wide.epoch_ms") == pytest.approx(200.0)
    assert read("wide.lpj_device_ms") == pytest.approx((3.0 + 5.0) / 2)
    assert read("wide.suffstat_device_ms") == pytest.approx(7.0 / 2)
    assert read("wide.host_ms") == pytest.approx((2.0 + 4.0 + 6.0) / 2)
    f32, _, bw = ctx.peaks
    lpj_s = max((8 * 1500 + 12 * 1000) * 2 / bw,
                (10 / 3 * 5700 + 6 * 2700 + 13 * 1500 + 8 * 1000) * 2 / f32)
    suf_s = max((12 * 1000 + 4 * 800) / bw, (16 / 3 * 2800 + 8 * 1600 + 3 * 1000) / f32)
    assert read("wide_roofline") == pytest.approx(100.0 * (lpj_s + suf_s) / 15e-3)
    assert 0.0 < read("wide_roofline") < 100.0


def test_the_wide_readers_find_nothing_on_the_kernels_path():
    """A program without the wide spans (the kernels' path, or a tree
    before them) gives None and does not raise; so do the CPU's missing
    device times and peaks."""
    ctx = _ctx([_span("em_step.lpj", 10, 1.0, 9.0), _span("em_step.suffstat", 30, 0.5, 1.0)])
    for name in ("wide.lpj_device_ms", "wide.suffstat_device_ms", "wide.host_ms",
                 "wide_roofline"):
        assert spec.reader(name)(ctx) is None, name
    assert spec.reader("wide_roofline")(_ctx(WINDOW, peaks=None)) is None
    cpu = [_span(s.name, s.begin_ns, 1.0, None, s.counts) for s in WINDOW]
    assert spec.reader("wide.lpj_device_ms")(_ctx(cpu)) is None
    assert spec.reader("wide_roofline")(_ctx(cpu)) is None


# ------------------------------------------------------------ the yardstick


def _hand_lpj(n):
    """The lpj's operations of one solve with n units, step by step."""
    lu = 2 * n**3 / 3
    steps = dict(u=2 * n * n + n, psi_lu=lu, psi_inv=2 * n**3, M=2 * n * n, M_lu=lu,
                 M_solve=2 * n * n, logdets=4 * n, resid=5 * n + 3, quad=2 * n, pil=n, lpj=5)
    return sum(steps.values())


def _hand_suffstat(n):
    lu = 2 * n**3 / 3
    steps = dict(u=2 * n * n + n, psi_lu=lu, psi_inv=2 * n**3, M=2 * n * n, M_lu=lu,
                 M_solve=2 * n * n, lam=2 * n**3, kappa=2 * n, shares=2 * n * n)
    return sum(steps.values())


@pytest.mark.parametrize("ns", [[1], [2], [1, 2, 2], [3, 7, 12, 1]])
def test_wide_bounds_match_a_hand_count(ns):
    counts = dict(states=len(ns), n1=sum(ns), n2=sum(n**2 for n in ns),
                  n3=sum(n**3 for n in ns))
    lpj = wide_bounds.lpj(**counts)
    suf = wide_bounds.suffstat(**counts)
    assert lpj["f32"] == pytest.approx(sum(_hand_lpj(n) for n in ns))
    assert suf["f32"] == pytest.approx(sum(_hand_suffstat(n) for n in ns))
    # bytes: n int32 indices and Wty_A in, y2 in and lpj, bad out / r in, kappa_A out
    assert lpj["bytes"] == sum(4 * n + 4 * n + 4 + 8 for n in ns)
    assert suf["bytes"] == sum(4 * n + 4 * n + 4 + 4 * n for n in ns)
    assert lpj["int"] == suf["int"] == 0
    peaks = bounds.PEAKS["NVIDIA H100 80GB HBM3"]
    c = {f"wide.{k}": v for k, v in counts.items()}
    assert wide_bounds.least_seconds("wide.lpj", c, peaks) == pytest.approx(
        max(lpj["f32"] / peaks[0], lpj["bytes"] / peaks[2]))
    assert math.isfinite(wide_bounds.least_seconds("wide.suffstat", c, peaks))
