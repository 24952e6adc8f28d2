"""The CUDA graphs of a block's phases (evo_tpu_torch/models/
block_graphs.py) and EBSC's epoch through the phases of the shared block
runner (models/epoch.py), on the CPU: when the graphs engage (the
mechanism's rule and each model's), the block body against the loop it
replaced (kept below as the reference), the graphed path's static buffers,
accumulators and generator against the eager path bit for bit (the
capture stood in for by the phase functions themselves: the card's
``chip_smoke.py epoch_graph`` checks the real graphs), the launch counters
of replays, the counters on the open span, and the benchmark's readers of
``em_step.graph_share``, ``suffstat.sparse_share`` and
``merge.kernel_share``."""

import dataclasses
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from evo_tpu_torch import BSC, SSSC, init_states, make_data
from evo_tpu_torch.models import block_graphs
from evo_tpu_torch.models.base import StepStats, block_gram, epoch_generator, sum_over_ranks
from evo_tpu_torch.models.bsc import lpj_gram
from evo_tpu_torch.ops import bsc_lpj as bsc_lpj_ops
from evo_tpu_torch.ops.bitpack import unpack_bits_lane
from evo_tpu_torch.ops.bsc_lpj import bsc_lpj
from evo_tpu_torch.ops.bsc_suffstat import bsc_suffstat
from evo_tpu_torch.ops.numerics import eps_lpj, posterior_weights, reset_lpj, shifted_logsumexp
from evo_tpu_torch.parallel import distributed
from evo_tpu_torch.utils import tracing
from evo_tpu_torch.variational.evolve import evolve_states_block
from evo_tpu_torch.variational.varykn import merge_states

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench import spec  # noqa: E402

H, D, NB, B = 8, 16, 3, 31  # N = 91 rows padded to 93: the last block holds two padding rows


@pytest.fixture(autouse=True)
def _closed():
    tracing.close(archive=None)
    yield
    tracing.close(archive=None)


@pytest.mark.parametrize("model,device,incomplete,Hx,exact,rec,want", [
    (BSC, "cuda", False, 256, False, False, True),  # the north-star cell
    (BSC, "cuda:0", False, 1024, False, False, True),  # the kernel's widest
    (BSC, "cpu", False, 256, False, False, False),
    (BSC, "cuda", True, 256, False, True, False),  # incomplete data
    (BSC, "cuda", False, 1025, False, False, False),  # the wide path
    (BSC, "cuda", False, 10, True, False, False),  # exact mode
    (BSC, "cuda", False, 256, False, True, False),  # an epoch with reconstruction
    (SSSC, "cuda", False, 32, False, False, False),  # ES3C's blocks are not graphed
])
def test_engages_only_where_the_graphs_run(model, device, incomplete, Hx, exact, rec, want):
    dev = torch.device(device)
    # the mechanism's own conditions know no model and no width
    assert block_graphs.engages(dev, incomplete, exact, rec) is (
        dev.type == "cuda" and not (incomplete or exact or rec))
    m = model(D=4, H=Hx, device="cpu")
    data, cfg = SimpleNamespace(incomplete=incomplete), SimpleNamespace(exact=exact)
    assert m._graphs_engage(dev, data, cfg, rec) is want


def _problem(seed=0, missing=0.0, **opts):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(D, H)) * 2.0
    s = rng.random((NB * B - 2, H)) < 0.3
    Y = (s @ W.T + rng.normal(size=(s.shape[0], D))).astype(np.float32)
    if missing:
        Y[rng.random(Y.shape) < missing] = np.nan
    data = make_data(Y, n_blocks=NB, device="cpu")
    ea = dict(no_parents=4, no_children=2, no_generations=2)
    ea.update(opts)
    cfg, estate = init_states(N=NB * B, S=8, H=H, n_blocks=NB, seed=seed + 1, device="cpu", **ea)
    model = BSC(D=D, H=H, device="cpu")
    return model, data, cfg, estate, model.standard_init(data, seed=seed + 2, y_host=Y)


CASES = {
    "randflip": {},
    "packed": dict(packed_states=True),
    "allzero": dict(allzero=True),
    "whole_set": dict(no_parents=2, no_children=2, no_generations=2, unification=False),
    "cross_sparseflip_background": dict(mutation_algorithm="cross_sparseflip", bitflip_prob=0.1,
                                        no_parents=3, no_generations=1, background=True),
}


def _epochs(model, data, cfg, estate, params, n=3, rec=False, seed=9):
    """n epochs; the states, lpj, F and Theta after each, the stats and the
    state the epoch generator was left in."""
    out = []
    for e in range(n):
        gen = epoch_generator(seed, e, "cpu")
        params, estate, stats, y_rec = model.em_step(params, estate, data, gen, cfg,
                                                     do_reconstruction=rec)
        out.append(dict(params=params, estate=estate, stats=stats, y_rec=y_rec,
                        gen=gen.get_state()))
    return out


def _assert_same(a, b):
    for x, y in zip(a, b):
        for f in ("ss", "lpj"):
            assert torch.equal(getattr(x["estate"], f), getattr(y["estate"], f)), f
        for f in dataclasses.fields(x["params"]):
            assert torch.equal(getattr(x["params"], f.name), getattr(y["params"], f.name)), f.name
        for f in dataclasses.fields(StepStats):
            assert torch.equal(getattr(x["stats"], f.name), getattr(y["stats"], f.name)), f.name
        assert (x["y_rec"] is None) == (y["y_rec"] is None)
        if x["y_rec"] is not None:
            assert torch.equal(x["y_rec"], y["y_rec"])
        assert torch.equal(x["gen"], y["gen"])


# ---------------------------------------------------------------- the block body


def _em_step_before(model, params, estate, data, generator, cfg, do_reconstruction=False):
    """``BSC.em_step`` as it was before its blocks were split into phases
    (without its spans): the reference for the phase-split body."""
    params = model.check_params(params)
    pre = model._precompute(params, data)
    rows = distributed.block_rows(data.y.shape[1])
    dt = params.W.dtype
    W, Hm = params.W, model.H
    Wp = torch.zeros((Hm, model.D), dtype=dt)
    Wq = torch.zeros((Hm, Hm), dtype=dt)
    pies = torch.zeros((Hm,), dtype=dt)
    sig, Fsum = torch.zeros((), dtype=dt), torch.zeros((), dtype=dt)
    nuni, nsub = torch.zeros((), dtype=torch.int64), torch.zeros((), dtype=torch.int64)
    resets = torch.zeros((3,), dtype=torch.int64)
    ss_all, lpj_all = torch.empty_like(estate.ss), torch.empty_like(estate.lpj)
    y_rec_all = torch.empty_like(data.y) if do_reconstruction else None
    floor, S_perm = 0.5 * eps_lpj(dt), cfg.S_perm
    for i in range(data.n_blocks):
        y_b, valid_b = data.y[i], data.row_valid[i]
        G_b, Wty_b, y2_b = block_gram(W, y_b, data.x_infr[i], data.incomplete)
        args = (Wty_b, y2_b, G_b, pre["pre1"], pre["pil_bar"])
        gram_form = G_b.dim() == 3 or model.wide()

        def lpj_block(states):
            if gram_form:
                if cfg.packed_states:
                    states = unpack_bits_lane(states, Hm).to(torch.int8)
                lpj, keys = lpj_gram(states, *args), None
            elif cfg.exact or cfg.packed_states:
                lpj, keys = bsc_lpj(states, *args), None
            else:
                lpj, keys = bsc_lpj(states, *args, emit_keys=True)
            lpj, counts = reset_lpj(lpj, valid=valid_b)
            return lpj, keys, torch.stack(counts)

        ss_b = estate.ss[i]
        lpj_K, ss_keys, counts = lpj_block(ss_b)
        if cfg.exact:
            zeros = torch.zeros(ss_b.shape[0], dtype=torch.int64)
            ss2, lpj2, n_uni, n_sub = ss_b, lpj_K, zeros, zeros
        else:
            children, child_lpj, new_unique, child_lpj_raw, aux = evolve_states_block(
                ss_b, lpj_K, lpj_block, cfg, pre["piH"], generator, ss_dkeys=ss_keys, rows=rows)
            counts = counts + sum(aux)
            ss2, lpj2, n_uni, n_sub, _ = merge_states(cfg, ss_b, lpj_K, children, child_lpj,
                                                      new_unique, child_lpj_raw)
        lpj_full = torch.cat([pre["pre1"] * y2_b[:, None], lpj2], 1) if S_perm else lpj2
        vf = valid_b.to(dt)
        Fsum += (shifted_logsumexp(lpj_full) * vf).sum()
        r = posterior_weights(lpj_full) * vf[:, None]
        rs = r[:, S_perm:].contiguous()
        rho, s_abs, Wq_b = bsc_suffstat(ss2, rs, H=Hm)
        Wq += Wq_b
        pies += rho.sum(dim=0)
        if do_reconstruction:
            sf = unpack_bits_lane(ss2, Hm) if cfg.packed_states else ss2
            means = sf.to(dt) @ W.T
            y_rec_all[i] = torch.where(data.x[i], y_b, (rs[:, None, :] @ means)[:, 0])
        if data.incomplete:
            y_rec, m = y_rec_all[i], data.x_infr[i]
            dy = (y_rec[:, None, :] - means) * m[:, None, :]
            sig += (rs * (dy * dy).sum(dim=-1)).sum()
            if S_perm:
                sig += (r[:, 0] * (y_rec * y_rec * m).sum(dim=-1)).sum()
            Wp += rho.T @ y_rec
        else:
            resid2 = torch.clamp((lpj2 - pre["pil_bar"] * s_abs) / pre["pre1"], min=0.0)
            sig += torch.where(lpj2 > floor, rs * resid2, 0.0).sum()
            if S_perm:
                sig += (r[:, 0] * y2_b).sum()
            Wp += rho.T @ y_b
        nuni += (n_uni * valid_b).sum()
        nsub += (n_sub * valid_b).sum()
        resets += counts
        ss_all[i], lpj_all[i] = ss2, lpj_full
    acc = dict(Wp=Wp, Wq=Wq, pies=pies, sig=sig)
    pre, acc, tot = sum_over_ranks(model, params, data, pre, acc,
                                   dict(Fsum=Fsum, nuni=nuni, nsub=nsub, resets=resets))
    new_params, guards = model._m_step_finalize(params, acc, pre, data.incomplete, cfg)
    guard = guards["n_guard_sigma_floor"]  # the flag, sigma being learned
    N, resets = pre["N"], tot["resets"]
    z = torch.zeros_like(guard)
    stats = StepStats(
        F=pre["ljc"] + tot["Fsum"] / N, S_nunique=tot["nuni"] / N, S_sub=tot["nsub"] / N,
        n_reset_nan=resets[0], n_reset_small=resets[1], n_reset_inf=resets[2],
        n_guard_sigma_floor=guard, n_guard_mus_freeze=z, n_guard_psi_freeze=z,
        guard_psi_renorm=torch.zeros((), dtype=torch.float32))
    return new_params, type(estate)(ss=ss_all, lpj=lpj_all), stats, y_rec_all


class _Before:
    """A model whose em_step is ``_em_step_before``."""

    def __init__(self, model):
        self.model = model

    def em_step(self, *a, **k):
        return _em_step_before(self.model, *a, **k)


@pytest.mark.parametrize("case", list(CASES) + ["incomplete", "exact", "wide"])
def test_the_phase_split_body_equals_the_loop_it_replaced(case, monkeypatch):
    opts = CASES.get(case, {})
    rec = case == "incomplete"
    if case == "exact":
        opts = dict(no_parents=1, no_children=1, no_generations=1)
    model, data, cfg, estate, params = _problem(missing=0.2 if rec else 0.0, **opts)
    if case == "exact":
        cfg, estate = init_states(N=NB * B, S=2**H, H=H, n_blocks=NB, device="cpu")
        assert cfg.exact
    if case == "wide":
        monkeypatch.setattr(bsc_lpj_ops, "MAX_H", H - 1)
        assert model.wide()
    args = (data, cfg, estate, params)
    _assert_same(_epochs(model, *args, rec=rec), _epochs(_Before(model), *args, rec=rec))


# ---------------------------------------------------------------- the graphed path


@pytest.fixture
def graphs_on_cpu(monkeypatch):
    """The graphed path on the CPU: it engages, the warm-up runs in place
    and a phase's "graph" replays the phase function itself."""
    monkeypatch.setattr(block_graphs, "engages", lambda *a: True)
    monkeypatch.setattr(block_graphs.PhaseGraphs, "warm_up", lambda self, fn: fn())
    monkeypatch.setattr(block_graphs.PhaseGraphs, "_capture_one",
                        lambda self, fn: SimpleNamespace(replay=fn))


def _traced_epochs(tmp_path, model, *args):
    """``_epochs`` with each em_step in an open span; (results, the spans'
    counters)."""
    tracing.set_tracefile(str(tmp_path / "trace.txt"))
    step = model.em_step

    def em_step(*a, **k):
        with tracing.span("em_step"):
            return step(*a, **k)

    out = _epochs(SimpleNamespace(em_step=em_step), *args)
    counts = [s.counts for s in tracing.records().spans if s.name == "em_step"]
    tracing.close(archive=None)
    return out, counts


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_epochs_equal_eager_epochs(case, graphs_on_cpu, tmp_path, monkeypatch):
    model, data, cfg, estate, params = _problem(**CASES[case])
    graphed, counts = _traced_epochs(tmp_path, model, data, cfg, estate, params)
    monkeypatch.setattr(block_graphs, "engages", lambda *a: False)
    eager = _epochs(BSC(D=D, H=H, device="cpu"), data, cfg, estate, params)
    _assert_same(graphed, eager)
    # one capture, in the first epoch, whose first block ran eagerly
    # the merges ran as the plain twin on the CPU: no merge kernel's block
    assert counts == [{"em_step.blocks": NB, "em_step.graph_blocks": NB - 1,
                       "em_step.graph_captures": 1, "merge.kernel_blocks": 0}] + [
        {"em_step.blocks": NB, "em_step.graph_blocks": NB, "merge.kernel_blocks": 0}] * 2
    # the stats hold copies: the static accumulators are zeroed next epoch
    static = {t.untyped_storage().data_ptr() for t in vars(model._graphs.acc).values()}
    stats = graphed[-1]["stats"]
    assert not static & {getattr(stats, f.name).untyped_storage().data_ptr()
                         for f in dataclasses.fields(StepStats)}


def test_graphs_are_kept_until_a_shape_or_the_config_changes(graphs_on_cpu):
    model, data, cfg, estate, params = _problem()
    gen = torch.Generator().manual_seed(0)
    params, estate = model.em_step(params, estate, data, gen, cfg)[:2]
    first = model._graphs
    assert first.captured
    params, estate = model.em_step(params, estate, data, gen, cfg)[:2]
    assert model._graphs is first
    swap = dataclasses.replace(cfg, swap_merge=True)
    model.em_step(params, estate, data, gen, swap)
    assert model._graphs is not first and model._graphs.key[-2] == swap
    model2, data2, cfg2, estate2, params2 = _problem(packed_states=True)
    model.em_step(params2, estate2, data2, gen, cfg2)
    assert model._graphs.key[1:3] == (tuple(estate2.ss.shape[1:]), torch.uint8)


def test_replays_count_the_launches_their_capture_made(monkeypatch):
    # a capture runs the Python of the phase once; a replay runs none of it
    monkeypatch.setattr(block_graphs.PhaseGraphs, "_capture_one",
                        lambda self, fn: (fn(), SimpleNamespace(replay=lambda: None))[1])
    kernel = SimpleNamespace(launches=5)

    def phase():
        kernel.launches += 2

    g = block_graphs.PhaseGraphs("key", "cpu", SimpleNamespace(), SimpleNamespace(),
                                 [(kernel, "launches")])
    g.capture([phase])
    assert kernel.launches == 5  # the capture launched nothing
    g.replay(0)
    g.replay(0)
    assert kernel.launches == 9


def test_counters_land_on_the_open_span_and_nowhere_without_a_session(tmp_path):
    model, data, cfg, estate, params = _problem()
    gen = torch.Generator().manual_seed(0)
    tracing.set_tracefile(str(tmp_path / "t.txt"))
    with tracing.span("em_step"):
        model.em_step(params, estate, data, gen, cfg)
    tracing.close(archive=None)
    recs = tracing.records()
    (step,) = [s for s in recs.spans if s.name == "em_step"]
    # eager on the CPU: nothing replayed, the merges the plain twin's
    assert step.counts == {"em_step.blocks": NB, "merge.kernel_blocks": 0}
    n = len(recs.spans)
    model.em_step(params, estate, data, gen, cfg)
    assert tracing.records() is recs and len(recs.spans) == n
    assert [s.counts for s in recs.spans if s.counts] == [
        {"em_step.blocks": NB, "merge.kernel_blocks": 0}]


# ---------------------------------------------------------------- the reader


def _records(window_counts, outside_counts):
    spans, t = [], 10
    for counts in outside_counts[:1] + window_counts + outside_counts[1:]:
        spans.append(SimpleNamespace(name="em_step", begin_ns=t, end_ns=t + 5, counts=counts))
        t += 10
    lo, hi = 10 + 10 * len(outside_counts[:1]) - 1, 10 + 10 * (1 + len(window_counts))
    return SimpleNamespace(spans=spans, markers=[(lo, "portbench.window:begin"),
                                                 (hi, "portbench.window:end")])


@pytest.mark.parametrize("window,want", [
    ([{"em_step.blocks": 25, "em_step.graph_blocks": 25}] * 3, 100.0),
    ([{"em_step.blocks": 25, "em_step.graph_blocks": 24, "em_step.graph_captures": 1},
      {"em_step.blocks": 25, "em_step.graph_blocks": 25}], 98.0),
    ([{"em_step.blocks": 25}] * 2, 0.0),  # eager epochs
    ([{"ea.children": 10}] * 2, None),  # a program without the counters
])
def test_graph_share_reads_the_window(window, want):
    read = spec.reader("em_step.graph_share")
    outside = [{"em_step.blocks": 25}, {"em_step.blocks": 25}]
    assert read(SimpleNamespace(records=_records(window, outside), epochs=len(window))) == want


@pytest.mark.parametrize("window,want", [
    ([{"suffstat.sparse_rows": 262144, "suffstat.dense_rows": 0}] * 3, 100.0),
    ([{"suffstat.sparse_rows": 300, "suffstat.dense_rows": 100},
      {"suffstat.sparse_rows": 500, "suffstat.dense_rows": 100}], 80.0),
    ([{"suffstat.sparse_rows": 0, "suffstat.dense_rows": 0}] * 2, None),  # nothing summed
    ([{"ea.children": 10}] * 2, None),  # a program without the counters, or ES3C
])
def test_sparse_share_reads_the_window(window, want):
    read = spec.reader("suffstat.sparse_share")
    outside = [{"suffstat.sparse_rows": 0, "suffstat.dense_rows": 9}] * 2
    assert read(SimpleNamespace(records=_records(window, outside), epochs=len(window))) == want


@pytest.mark.parametrize("window,want", [
    ([{"sssc_suffstat.sparse_rows": 3024008, "sssc_suffstat.dense_rows": 172}] * 2,
     100.0 * 172 / 3024180),
    ([{"sssc_suffstat.sparse_rows": 300, "sssc_suffstat.dense_rows": 100},
      {"sssc_suffstat.sparse_rows": 500, "sssc_suffstat.dense_rows": 100}], 20.0),
    ([{"sssc_suffstat.sparse_rows": 0, "sssc_suffstat.dense_rows": 0}] * 2, None),  # none solved
    ([{"suffstat.sparse_rows": 10, "suffstat.dense_rows": 0}] * 2, None),  # EBSC, or the parent
])
def test_sssc_dense_share_reads_the_window(window, want):
    read = spec.reader("sssc_suffstat.dense_share")
    outside = [{"sssc_suffstat.sparse_rows": 0, "sssc_suffstat.dense_rows": 9}] * 2
    assert read(SimpleNamespace(records=_records(window, outside), epochs=len(window))) == want


@pytest.mark.parametrize("window,want", [
    ([{"em_step.blocks": 25, "merge.kernel_blocks": 25}] * 3, 100.0),
    ([{"em_step.blocks": 25, "em_step.graph_blocks": 24, "merge.kernel_blocks": 25},
      {"em_step.blocks": 25, "merge.kernel_blocks": 15}], 80.0),
    ([{"em_step.blocks": 1, "merge.kernel_blocks": 0}] * 2, 0.0),  # the plain twin's merges
    ([{"em_step.blocks": 25}] * 2, None),  # a program without the counter
    ([{"ea.children": 10}] * 2, None),
])
def test_merge_kernel_share_reads_the_window(window, want):
    read = spec.reader("merge.kernel_share")
    outside = [{"em_step.blocks": 25, "merge.kernel_blocks": 0}] * 2
    assert read(SimpleNamespace(records=_records(window, outside), epochs=len(window))) == want
