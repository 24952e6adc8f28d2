"""The port's spans, counters and markers (evo_tpu_torch/utils/tracing.py)
on the CPU: off, nesting, counters, the trace file as the benchmark
harness reads it, the profiler's clock, the models' phase spans in tiny
EMTrainer runs (bit for bit the runs without tracing), and the benchmark's
readers of the spans."""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from evo_tpu_torch import BSC, SSSC, init_states, make_data
from evo_tpu_torch.apps import training
from evo_tpu_torch.apps.training import EMTrainer
from evo_tpu_torch.ops.bsc_suffstat import row_counts
from evo_tpu_torch.utils import tracing
from evo_tpu_torch.utils.datalog import DataHandler, DataLog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench import spec  # noqa: E402
from portbench.harness import Run  # noqa: E402

PHASES = ("em_step.lpj", "em_step.ea", "em_step.merge", "em_step.suffstat", "em_step.mstep")
WINDOW = ("portbench.window:begin", "portbench.window:end")


@pytest.fixture(autouse=True)
def _closed():
    tracing.close(archive=None)
    yield
    tracing.close(archive=None)


def _lines(path):
    with open(path) as f:
        header, *rest = f.read().splitlines()
    return header, [(float(t), name) for t, name in (ln.split(" ", 1) for ln in rest)]


def test_off_records_nothing_and_opens_no_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = tracing.records()
    n_before = len(before.spans) if before is not None else 0

    def no_profiler_annotation(name):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", no_profiler_annotation)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("a", torch.device("cpu")) as a:
            tracing.count("n", 3)
            with tracing.span("b") as b:
                tracing.tracepoint("inside")
    tracing.resolve()
    assert a is b  # the one shared no-op object
    assert tracing.records() is before
    assert (len(before.spans) if before is not None else 0) == n_before
    assert os.listdir(tmp_path) == []


def test_nesting_parents_self_times_and_counters(tmp_path):
    tracing.set_tracefile(str(tmp_path / "t.txt"))
    tracing.set_epoch(7)
    tracing.count("outside", 1)  # no open span: dropped
    with tracing.span("a"):
        with tracing.span("b"):
            tracing.count("n", 2)
            with tracing.span("c"):
                tracing.count("n", 5)
        tracing.count("n", 3)
        with tracing.span("d"):
            pass
    recs = tracing.records()
    a, b, c, d = recs.spans
    assert [s.id for s in recs.spans] == [0, 1, 2, 3]
    assert (a.parent, b.parent, c.parent, d.parent) == (None, 0, 1, 0)
    assert {s.epoch for s in recs.spans} == {7}
    dur = {s.name: s.end_ns - s.begin_ns for s in recs.spans}
    assert a.host_self_ns == dur["a"] - dur["b"] - dur["d"]
    assert b.host_self_ns == dur["b"] - dur["c"]
    assert c.host_self_ns == dur["c"] and d.host_self_ns == dur["d"]
    assert (a.counts, b.counts, c.counts, d.counts) == ({"n": 3}, {"n": 2}, {"n": 5}, None)
    assert all(s.device_ms is None and s.device_self_ms is None for s in recs.spans)
    tracing.close(archive=None)
    tracing.close(archive=None)  # idempotent
    assert tracing.records() is recs and len(recs.spans) == 4


def test_device_times_resolve_without_waiting(tmp_path, monkeypatch):
    """CUDA spans with stand-in events (recorded at a clock in steps of 1000
    ns, which the card has passed up to ``Event.passed``): resolve() takes
    what is done, in order, gives device self times less the children's,
    lets a span begin at the end event of the sibling that closed just
    before it, and returns each event for reuse once no edge reads it."""
    clock = iter(range(0, 10**9, 1000))
    recorded = []

    class Event:
        passed = -1

        def __init__(self, enable_timing=False):
            pass

        def record(self, stream):
            self.t = next(clock)
            recorded.append(self.t)

        def query(self):
            return self.t <= Event.passed

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e-6

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(tracing, "_free_events", {})
    monkeypatch.setattr(tracing, "_streams", {(0, 0): "the stream"})
    monkeypatch.setattr(tracing, "_stream_key", lambda device: (0, 0))
    cuda = torch.device("cuda")
    tracing.set_tracefile(str(tmp_path / "t.txt"))
    with tracing.span("a", cuda):  # events at 0 and 3000
        with tracing.span("b", cuda):  # 1000, 2000
            pass
        with tracing.span("c"):  # host only
            pass
    with tracing.span("d", cuda):  # begins at a's end, 3000; ends at 4000
        pass

    def device_ms():
        return {s.name: (s.device_ms, s.device_self_ms) for s in tracing.records().spans}

    tracing.resolve()
    assert set(device_ms().values()) == {(None, None)}
    Event.passed = 3000
    tracing.resolve()
    assert device_ms() == dict(a=(3e-3, 2e-3), b=(1e-3, 1e-3), c=(None, None), d=(None, None))
    assert recorded == [0, 1000, 2000, 3000, 4000]
    assert len(tracing._free_events[0]) == 3  # a's end is still d's begin
    Event.passed = 10**9
    tracing.resolve()
    assert device_ms()["d"] == (1e-3, 1e-3)
    assert len(tracing._free_events[0]) == 5 and not tracing.records()._uses
    # d's end went back for reuse, so e records a begin of its own; f begins
    # at e's end; g records its own, as a host span opened after f closed
    for name in ("e", "f", "host", "g"):
        with tracing.span(name, None if name == "host" else cuda):
            pass
    assert recorded[5:] == [5000, 6000, 7000, 8000, 9000]
    tracing.resolve()
    assert [device_ms()[n] for n in "efg"] == [(1e-3, 1e-3)] * 3
    assert all(not ids for ids, _, _ in tracing.records()._pending.values())
    tracing.close(archive=None)


def test_the_file_reads_back_through_the_harness(tmp_path, monkeypatch):
    monkeypatch.setattr(tracing, "FLUSH_LINES", 4)
    path = str(tmp_path / "trace.txt")
    tracing.set_tracefile(path)
    tracing.tracepoint("before")
    tracing.tracepoint(WINDOW[0])
    for _ in range(3):
        with tracing.span("log"):
            with tracing.span("em_step.lpj"):
                pass
    assert len(_lines(path)[1]) >= 4  # written in chunks before close
    tracing.tracepoint(WINDOW[1])
    tracing.close(archive=None)
    header, lines = _lines(path)
    recs = tracing.records()
    assert f"t0_unix_ns={recs.t0_ns}" in header.split()
    assert [t for t, _ in lines] == sorted(t for t, _ in lines)
    assert [n for _, n in lines][:3] == ["before", WINDOW[0], "log:begin"]
    assert len(lines) == 3 + 4 * 3
    assert [m for _, m in recs.markers] == ["before", *WINDOW]
    for t_ns, mark in recs.markers:
        (t,) = [t for t, n in lines if n == mark]
        assert abs(recs.t0_ns + 1e9 * t - t_ns) <= 1e3
    spans = Run.spans(SimpleNamespace(tracefile=path))
    assert set(spans) == {"log", "em_step.lpj", "portbench.window"}
    del spans["portbench.window"]
    for name, got in spans.items():
        want = [1e-9 * (s.end_ns - s.begin_ns) for s in recs.spans if s.name == name]
        np.testing.assert_allclose(got, want, atol=2e-6)


def test_archive_after_close(tmp_path, monkeypatch):
    import tarfile

    monkeypatch.chdir(tmp_path)
    tracing.set_tracefile("trace-%04d.txt")
    with tracing.span("work"):
        tracing.tracepoint("inside")
    tracing.close("traces.tgz")
    with tarfile.open("traces.tgz") as tar:
        content = tar.extractfile("trace-0000.txt").read().decode()
    names = [ln.split(" ", 1)[1] for ln in content.splitlines()[1:]]
    assert names == ["work:begin", "inside", "work:end"]
    assert not os.path.exists("trace-0000.txt")


def test_spans_are_profiler_annotations_on_its_clock(tmp_path):
    tracing.set_tracefile(str(tmp_path / "t.txt"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for name in ("em_step.lpj", "em_step.ea", "em_step.lpj"):
            with tracing.span(name):
                (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    with tracing.span("after"):  # no profiler: no annotation
        pass
    chrome = str(tmp_path / "prof.json")
    prof.export_chrome_trace(chrome)
    with open(chrome) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    ann = [e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"]
    ann.sort(key=lambda e: e["ts"])
    spans = tracing.records().spans
    assert [e["name"] for e in ann] == [s.name for s in spans[:3]]
    for e, s in zip(ann, spans):
        assert abs(base + 1e3 * e["ts"] - s.begin_ns) < 1e6
        assert abs(base + 1e3 * (e["ts"] + e["dur"]) - s.end_ns) < 1e6


class _Memory(DataHandler):
    def __init__(self, store):
        self.store = store

    def append(self, tblname, value):
        self.store.setdefault(tblname, []).append(value)

    def append_all(self, valdict):
        for k, v in valdict.items():
            self.append(k, v)

    def assign(self, tblname, value):
        pass


def _trainer(tmp_path, model_name, trace, epochs=4, window=(1, 3)):
    """A tiny EMTrainer run on the CPU (two blocks) with the window markers
    written from the epoch callback after epochs ``window``; returns (the
    trainer, the logged tables, the trace file or None)."""
    rng = np.random.default_rng(3)
    H, N, D = 6, 96, 9
    Y = rng.normal(size=(N, D)).astype(np.float32)
    if model_name == "bsc":
        model = BSC(D=D, H=H, device="cpu")
        rec = None
    else:
        Y[rng.random(Y.shape) < 0.1] = np.nan
        model = SSSC(D=D, H=H, to_learn=("W", "pies", "sigma2"), device="cpu")
        rec = lambda e: True  # noqa: E731
    data = make_data(Y, n_blocks=2, device="cpu")
    cfg, estate = init_states(N=N, S=6, H=H, no_parents=3, no_children=2, no_generations=2,
                              n_blocks=2, seed=5, device="cpu")
    params = model.standard_init(data, seed=1, y_host=Y)
    store = {}
    dlog = DataLog()
    dlog.set_handler(["F", "S_nunique"], _Memory, store)
    tracefile = os.path.join(str(tmp_path), f"{model_name}-trace.txt") if trace else None
    tr = EMTrainer(model, cfg, params, estate, data, dlog, str(tmp_path), seed=11,
                   theta_append=False, tracefile=tracefile)

    def callback(epoch, **_):
        if epoch == window[0]:
            tracing.tracepoint(WINDOW[0])
        if epoch == window[1]:
            tracing.tracepoint(WINDOW[1])

    tr.run(epochs, reconstruct_at=rec, epoch_callback=callback)
    return tr, store, tracefile


@pytest.mark.parametrize("model_name", ["bsc", "sssc"])
def test_a_trainer_run_spans_every_phase_of_every_epoch(tmp_path, model_name):
    tr, store, tracefile = _trainer(tmp_path, model_name, trace=True)
    recs = tracing.records()
    spans = recs.spans
    by_id = {s.id: s for s in spans}
    cfg = tr.cfg
    assert cfg.n_new == 3 * 2 * 2
    for e in range(4):
        mine = [s for s in spans if s.epoch == e]
        assert {s.name for s in mine} >= set(PHASES) | {"em_step", "stats_wait", "log",
                                                        "epoch_callback"}
        for name in PHASES:
            assert all(by_id[s.parent].name != name for s in mine
                       if s.name == name and s.parent is not None)
        nested = [s for s in mine if s.name == "em_step.lpj" and s.parent is not None
                  and by_id[s.parent].name == "em_step.ea"]
        assert len(nested) == 2 * cfg.n_generations  # two blocks
        (step,) = [s for s in mine if s.name == "em_step"]
        assert all(by_id[s.parent].name in ("em_step", "em_step.ea")
                   for s in mine if s.name in PHASES)
        assert step.counts["ea.children"] == 96 * cfg.n_new
        assert step.counts["ea.unique"] == round(float(store["S_nunique"][e]) * 96)
        (wait,) = [s for s in mine if s.name == "stats_wait"]
        assert wait.parent == step.id
    # the trainer opened the file, so it closed and archived it
    assert os.path.exists(os.path.join(str(tmp_path), "traces.tgz"))
    assert not os.path.exists(tracefile)


@pytest.mark.parametrize("model_name", ["bsc", "sssc"])
def test_tracing_changes_no_bit_of_the_run(tmp_path, model_name):
    (tmp_path / "off").mkdir()
    (tmp_path / "on").mkdir()
    off, store_off, _ = _trainer(tmp_path / "off", model_name, trace=False)
    on, store_on, _ = _trainer(tmp_path / "on", model_name, trace=True)
    assert store_on["F"] == store_off["F"]
    for name in vars(off.params):
        assert torch.equal(getattr(off.params, name), getattr(on.params, name)), name
    assert torch.equal(off.estate.ss, on.estate.ss)
    assert torch.equal(off.estate.lpj, on.estate.lpj)


@pytest.mark.parametrize("trace", [True, False], ids=["traced", "untraced"])
def test_the_suffstat_row_counters_are_read_only_while_spans_are_recorded(tmp_path, monkeypatch,
                                                                          trace):
    """The trainer reads the kernel's row counters (a transfer from the
    card) after each stats transfer of a traced run, onto its em_step
    span, and never in an untraced run; on the CPU there is nothing to
    read."""
    assert row_counts("cpu") is None
    calls = []

    def counts(device):
        calls.append(device)
        return 7 * len(calls), len(calls) % 2

    monkeypatch.setattr(training, "row_counts", counts)
    tr, _, _ = _trainer(tmp_path, "bsc", trace=trace)
    if not trace:
        assert calls == []
        return
    assert calls == [tr.data.y.device] * 4
    steps = [s for s in tracing.records().spans if s.name == "em_step"]
    assert [(s.counts["suffstat.sparse_rows"], s.counts["suffstat.dense_rows"])
            for s in steps] == [(7, 1), (14, 0), (21, 1), (28, 0)]


READERS = [f"em_step.{p}_{side}_ms" for side in ("host", "device")
           for p in ("lpj", "ea", "merge", "suffstat", "mstep")] + [
    "trainer.stats_wait_ms", "ea.unique_share"]


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """A tiny traced EBSC run with its window (epochs 2-4), its trace file
    as the trainer archived it, and a copy of its records in which every
    phase span has a device time."""
    import tarfile

    tracing.close(archive=None)
    tmp = str(tmp_path_factory.mktemp("readers"))
    tr, store, _ = _trainer(tmp, "bsc", trace=True, epochs=6, window=(2, 5))
    recs = tracing.records()
    path = os.path.join(tmp, "bsc-trace.txt")
    with tarfile.open(os.path.join(tmp, "traces.tgz")) as tar, open(path, "wb") as f:
        f.write(tar.extractfile(tar.getmembers()[0]).read())
    fields = ("name", "id", "parent", "epoch", "begin_ns", "end_ns", "host_self_ns", "counts")
    spans = [SimpleNamespace(**{k: getattr(s, k) for k in fields},
                             device_self_ms=0.5 + 0.01 * s.id if s.name in PHASES else None)
             for s in recs.spans]
    fake = SimpleNamespace(spans=spans, markers=list(recs.markers), t0_ns=recs.t0_ns)
    return dict(recs=recs, fake=fake, store=store, cfg=tr.cfg, file=path)


def _expected(name, run):
    spans = [s for s in run["fake"].spans if s.epoch in (2, 3, 4)]
    if name == "ea.unique_share":
        s_nunique = [float(v) for v in run["store"]["S_nunique"][2:5]]
        return 100.0 * np.mean(s_nunique) / run["cfg"].n_new
    if name == "trainer.stats_wait_ms":
        return 1e-6 * sum(s.end_ns - s.begin_ns for s in spans if s.name == "stats_wait") / 3
    phase = "em_step." + name.split(".")[1].rsplit("_", 2)[0]
    if name.endswith("_host_ms"):
        return 1e-6 * sum(s.host_self_ns for s in spans if s.name == phase) / 3
    return sum(s.device_self_ms for s in spans if s.name == phase) / 3


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_the_window(traced_run, name):
    read = spec.reader(name)
    spans = Run.spans(SimpleNamespace(tracefile=traced_run["file"]))
    ctx = SimpleNamespace(records=traced_run["fake"], epochs=3, spans=spans)
    # the file's lines are whole microseconds: 2 us a span at most, per epoch
    tol = 2e-3 if name == "trainer.stats_wait_ms" else 1e-5
    want = _expected(name, traced_run)
    assert read(ctx) == pytest.approx(want, rel=1e-5, abs=tol)
    if name == "ea.unique_share":
        assert 0 < read(ctx) <= 100
    # the real records: host times and counters read, device times are None on the CPU
    real = read(SimpleNamespace(records=traced_run["recs"], epochs=3, spans=spans))
    if "_device_" in name:
        assert real is None
    else:
        assert real == pytest.approx(want, rel=1e-5, abs=tol)
    # a program without the records, or a window without spans, reads None
    bare = SimpleNamespace(spans=[], markers=[(0, WINDOW[0]), (1, WINDOW[1])], t0_ns=0)
    assert read(SimpleNamespace(records=bare, epochs=3, spans={})) is None


def test_the_host_phases_cover_the_step(traced_run):
    """The five host self times add up to most of the model's em_step (the
    host part of the trainer's em_step span less stats_wait), epoch by
    epoch."""
    spans = traced_run["recs"].spans
    for e in range(2, 5):
        mine = [s for s in spans if s.epoch == e]
        (step,) = [s for s in mine if s.name == "em_step"]
        (wait,) = [s for s in mine if s.name == "stats_wait"]
        phases = sum(s.host_self_ns for s in mine if s.name in PHASES)
        model = step.end_ns - step.begin_ns - (wait.end_ns - wait.begin_ns)
        assert 0.5 * model < phases <= model
