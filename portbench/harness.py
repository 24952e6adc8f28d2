"""One run of one cell: set-up, the measured window through EMTrainer, the
traced stretch, the checked epoch and the reference, the result.

The window drives the users' path: ``evo_tpu_torch.apps.training.EMTrainer``
steps epoch after epoch (``em_step`` with ``epoch_generator(seed, e)``,
one stats transfer, the DataLog line in the Theta-overwrite mode, the
image apps' epoch callback), and the harness's own callback, which runs
after the app's, keeps the clock.  Set-up (loading the prebuilt kernels,
the inputs, Theta^0 and K^0, two warm-up epochs) ends at the end of the
second epoch.  On one card the window then runs until ``seconds`` have
passed and, for a cell that merges, until the next epoch is a merge epoch;
under several ranks its epoch count is fixed from three calibration epochs
at the end of set-up (rank 0's, broadcast), since every rank must stop at
the same epoch.  A traced run then profiles a stretch of the cell's
``profile_epochs``.  The epoch after that is the checked epoch: its inputs
(Theta_t and a sample of K^(n)) are kept before it, its outputs after it,
and the reference judges them once the trainer's run has ended.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import os
import shutil
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import devtrace, spec
from portbench.reference import bounds, images as ref_images
from portbench.reference.initial import first_states
from portbench.reference.precision import Prec

WARM_EPOCHS = 2
CALIBRATION_EPOCHS = 3
SAMPLE_ROWS = 512  # datapoints whose merge is checked
FIRST_ROWS = 4096  # rows of K^0 checked against the reference's draw
REF_CHUNK = 8192  # datapoints the reference takes at a time


class _Done(Exception):
    """Raised by the harness's callback after the checked epoch."""


class Capture:
    """A DataLog sink keeping the latest value of every table in memory
    (the Theta tables, assigned in the overwrite mode, and the merged
    images), for the check; created through ``DataLog.set_handler``."""

    def __init__(self, store: dict):
        self.store = store

    def register(self, tblname):
        pass

    def append(self, tblname, value):
        self.store[tblname] = value

    def append_all(self, valdict):
        self.store.update(valdict)

    def assign(self, tblname, value):
        self.store[tblname] = value

    def remove(self, tblname):
        pass

    def close(self):
        pass


def _capture_class():
    from evo_tpu_torch.utils.datalog import DataHandler

    return type("CaptureHandler", (Capture, DataHandler), {})


def _rank_world():
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def _allreduce(t: torch.Tensor, op="sum") -> torch.Tensor:
    if _rank_world()[1] > 1:
        torch.distributed.all_reduce(
            t, op=torch.distributed.ReduceOp.SUM if op == "sum" else torch.distributed.ReduceOp.MAX)
    return t


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def state_counts(ss: torch.Tensor):
    """(n [nb, B, S], u [nb, B]) float64: active units per state and per
    datapoint's union, of int8 states [nb, B, S, H]."""
    n = (ss != 0).sum(-1, dtype=torch.int64).double()
    u = (ss != 0).any(2).sum(-1, dtype=torch.int64).double()
    return n, u


class Run:
    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, device,
                 t_start: float, root=None):
        self.sp = spec.load(workload, root)
        self.cell, self.config = self.sp["cell"], self.sp["config"]
        self.seed = int(seed) % (1 << 62)
        self.seconds, self.trace, self.device = float(seconds), bool(trace), device
        self.t_start = t_start  # wall clock (time.time) at process start
        self.rank, self.world = _rank_world()
        self.ref_model = importlib.import_module(f"portbench.reference.{self.config['model']}")
        self.phase = "warm"
        self.durations, self.bad_F = [], 0
        self.enqueue, self.allreduce = [], []
        self.store = {}

    # ------------------------------------------------------------ set-up

    def setup(self, outdir: str):
        from evo_tpu_torch.apps.training import EMTrainer
        from evo_tpu_torch.ops import _build
        from evo_tpu_torch.utils.datalog import DataLog, StoreToTxt

        if self.device.type == "cuda":
            _build.build()  # the kernels, built once per checkout
        self.setup_phases = {"start_to_kernels_s": time.time() - self.t_start}
        t = time.time()
        gen = importlib.import_module(f"portbench.generators.{self.cell['generator']}")
        self.job = gen.make(self.cell["traffic"], self.config, self.seed, self.device, self.world)
        self.setup_phases["inputs_and_init_s"] = time.time() - t
        self.t_warm = time.time()
        job = self.job
        self.dlog = DataLog()
        self.dlog.set_handler(["F", "S_nunique", "S_sub", "psnr_mean", "psnr_median"], StoreToTxt,
                              os.path.join(outdir, "metrics.txt"))
        self.dlog.set_handler(["*"], _capture_class(), self.store)
        self.trainer = EMTrainer(job["model"], job["cfg"], job["params"], job["estate"],
                                 job["data"], self.dlog, outdir, seed=self.seed + 1,
                                 theta_append=False)
        self.app_callback = job["make_callback"](self.dlog) if job["make_callback"] else None
        self.to_learn = tuple(job["model"].to_learn)
        job["incomplete"], job["D"] = bool(job["data"].incomplete), job["data"].D
        self.peaks = (bounds.PEAKS.get(torch.cuda.get_device_name(self.device))
                      if self.device.type == "cuda" else None)
        p0 = job["params"]
        self.theta0 = {f.name: getattr(p0, f.name).detach().cpu().double().numpy()
                       for f in dataclasses.fields(p0)}
        ss = job["estate"].ss
        self.states0 = (ss[0, :min(FIRST_ROWS, ss.shape[1])].cpu().numpy() if self.rank == 0
                        else None)
        if self.trace:
            self._instrument()

    def _instrument(self):
        """Spans for the traced run: the host time of each em_step call (and
        a profiler annotation), of each allreduce_sums (synchronised before
        and after, so that the wait for the slowest rank counts), and an
        annotation around the trainer's log."""
        from evo_tpu_torch.parallel import distributed
        from evo_tpu_torch.utils import tracing

        model, trainer = self.job["model"], self.trainer
        em_step, log_epoch = model.em_step, trainer._log_epoch
        allreduce = distributed.allreduce_sums
        dev = self.device

        def timed_em_step(*a, **k):
            t0 = time.perf_counter()
            with torch.profiler.record_function("em_step"):
                out = em_step(*a, **k)
            if self.phase == "window":
                self.enqueue.append(time.perf_counter() - t0)
            return out

        def traced_log(*a, **k):
            with torch.profiler.record_function("log"):
                return log_epoch(*a, **k)

        def timed_allreduce(*a, **k):
            if self.phase != "window":
                return allreduce(*a, **k)
            _sync(dev)
            t0 = time.perf_counter()
            out = allreduce(*a, **k)
            _sync(dev)
            self.allreduce.append(time.perf_counter() - t0)
            return out

        object.__setattr__(model, "em_step", timed_em_step)
        trainer._log_epoch = traced_log
        distributed.allreduce_sums = timed_allreduce
        self.tracefile = os.path.join(self.outdir, "trace.txt")
        tracing.set_tracefile(self.tracefile)

    # ------------------------------------------------------------ window

    def callback(self, epoch, F, params, stats, y_rec=None, **_):
        if self.trace:
            with torch.profiler.record_function("epoch_callback"):
                self._callback(epoch, F, params, stats, y_rec)
        else:
            self._callback(epoch, F, params, stats, y_rec)

    def _callback(self, epoch, F, params, stats, y_rec):
        if self.app_callback is not None:
            self.app_callback(epoch=epoch, F=F, params=params, stats=stats, y_rec=y_rec)
        now = time.perf_counter()
        if self.phase == "warm":
            if epoch == WARM_EPOCHS:
                if self.world == 1:
                    self._open_window(now)
                else:
                    self.phase, self.cal_start, self.cal_epochs = "calibrate", now, 0
        elif self.phase == "calibrate":
            self.cal_epochs += 1
            if self.cal_epochs == CALIBRATION_EPOCHS:
                per = torch.tensor([(now - self.cal_start) / CALIBRATION_EPOCHS],
                                   dtype=torch.float64, device=self.device)
                torch.distributed.broadcast(per, src=0)
                self.target = max(1, math.ceil(self.seconds / float(per)))
                self._open_window(time.perf_counter())
        elif self.phase == "window":
            self.durations.append(now - self.t_last)
            self.t_last = now
            self.bad_F += 0 if math.isfinite(F) else 1
            if self._closes(epoch, now):
                self._close_window(now, epoch)
        elif self.phase == "profile":
            self.prof_epochs += 1
            if self.prof_epochs == self.cell["profile_epochs"]:
                self._end_profile()
                self._keep_inputs(params)
        elif self.phase == "check":
            self._keep_outputs(params, F)
            raise _Done

    def _open_window(self, now):
        from evo_tpu_torch.utils import tracing

        self.phase, self.t_open, self.t_last = "window", now, now
        self.setup_s = time.time() - self.t_start
        self.setup_phases["warm_up_s"] = time.time() - self.t_warm
        tracing.tracepoint("portbench.window:begin")

    def _closes(self, epoch, now) -> bool:
        if self.world > 1:
            return len(self.durations) >= self.target
        if now - self.t_open < self.seconds:
            return False
        me = self.job["merge_every"]
        return me is None or (epoch + 1) % me == 0

    def _close_window(self, now, epoch):
        from evo_tpu_torch.utils import tracing

        tracing.tracepoint("portbench.window:end")
        self.window_s = now - self.t_open
        self.peak = (torch.cuda.max_memory_allocated(self.device)
                     if self.device.type == "cuda" else 0)
        if self.trace:
            self._start_profile(epoch)
        else:
            self._keep_inputs(self.trainer.params)

    def _start_profile(self, epoch):
        self.phase, self.prof_epochs, self.stretch_first = "profile", 0, epoch
        self.counts_start = state_counts(self.trainer.estate.ss)
        _sync(self.device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.stretch = torch.profiler.record_function(devtrace.STRETCH)
        self.stretch.__enter__()

    def _end_profile(self):
        _sync(self.device)
        self.stretch.__exit__(None, None, None)
        self.prof.stop()
        self.counts_end = state_counts(self.trainer.estate.ss)
        self.chrome = os.path.join(self.outdir, "stretch.json")
        self.prof.export_chrome_trace(self.chrome)
        del self.prof

    def _keep_inputs(self, params):
        """Theta_t and the sample's K^(n) before the checked epoch."""
        self.phase = "check"
        self.theta_in = {f.name: getattr(params, f.name).detach().clone()
                         for f in dataclasses.fields(params)}
        ss = self.trainer.estate.ss
        nb, B = ss.shape[:2]
        valid = self.job["data"].row_valid.reshape(-1).cpu().numpy()
        rng = np.random.default_rng(self.seed + 7 + self.rank)
        cand = np.flatnonzero(valid)
        self.sample = np.sort(rng.choice(cand, size=min(SAMPLE_ROWS, cand.size), replace=False))
        self.sample_old = ss.reshape(nb * B, *ss.shape[2:])[
            torch.as_tensor(self.sample, device=ss.device)].clone()
        self.store.clear()

    def _keep_outputs(self, params, F):
        self.theta_out = {f.name: getattr(params, f.name).detach()
                          for f in dataclasses.fields(params)}
        self.estate_out = self.trainer.estate
        self.F_out = float(F)
        self.merged = {k: self.store[k] for k in ("reco_img_mean", "reco_img_median",
                                                  "psnr_mean", "psnr_median") if k in self.store}

    def run(self):
        """Set-up, window, stretch and checked epoch, then the reference."""
        from evo_tpu_torch.utils import tracing

        self.outdir = tempfile.mkdtemp(prefix="portbench-")
        try:
            with open(os.path.join(self.outdir, "terminal.txt"), "w") as term, \
                    contextlib.redirect_stdout(term):
                if self.device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(self.device)
                self.setup(self.outdir)
                try:
                    self.trainer.run(10**9, reconstruct_at=self.job["reconstruct_at"],
                                     epoch_callback=self.callback)
                except _Done:
                    pass
                else:
                    raise RuntimeError("the trainer ended before the checked epoch")
                tracing.close(archive=None)
                self.dlog.close()
            self._release()
            self.checks = self.check()
            if self.trace:
                self.per_layer = self.read_metrics()
        finally:
            shutil.rmtree(self.outdir, ignore_errors=True)

    def _release(self):
        """Free the program's state that the reference does not judge."""
        self.trainer = None
        for k in ("data", "estate", "params", "model"):
            self.job.pop(k, None)
        self.app_callback = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ reference

    def ref_rows(self):
        """The reference's rows, from the raw inputs: (y [N, D] with 0 at
        missing entries, observed m, kept x, dc or None), host float64."""
        im = self.job["ref"]["image"]
        if im:
            Y, dc = ref_images.patches(im["corrupted"], im["patch"])
        else:
            Y, dc = np.asarray(self.job["ref"]["Y"], dtype=np.float64), None
        m = ~np.isnan(Y)
        y = np.where(m, Y, 0.0)
        # denoising reconstructs every entry; otherwise the observed ones are kept
        keep = np.zeros_like(m) if im and im["task"] == "denoising" else m
        return y, m, keep, dc

    def reference(self, prec: Prec, half: bool = False, local: bool = False):
        """The reference's epoch on the program's K^(n) after the checked
        epoch, from Theta_t: {lpj [nb, B, S], mag, theta, F, y_rec [N, D]}
        (y_rec on one rank only) and, at this rank's sample, the lpj of
        the states before and after.  ``half`` plants a fault in the
        reference: every second datapoint left out and the means taken over
        the rest; ``local`` another, the exchange between ranks left out
        (each rank's M-step from its own rows)."""
        from portbench.generators.common import blocked_rows

        rm = self.ref_model
        y, m, keep, _ = self.ref_rows()
        N, D = y.shape
        ss = self.estate_out.ss
        nb, B, S, H = ss.shape
        rows = blocked_rows(N, nb, self.rank, self.world)
        th = rm.checked({k: v.to(self.device) for k, v in self.theta_in.items()}, prec)
        sums = rm.zero_sums(D, H, prec, self.device)
        incomplete = not m.all()
        lpj = torch.empty(nb, B, S, dtype=prec.dtype, device=self.device)
        mag = torch.empty_like(lpj)
        y_rec = np.zeros((N, D)) if self.world == 1 else None
        for b in range(nb):
            for lo in range(0, B, REF_CHUNK):
                idx = rows[b, lo:lo + REF_CHUNK]
                ok = idx < N
                take = np.where(ok, idx, 0)
                yb, mb, xb = (torch.as_tensor(np.where(ok[:, None], a[take], a.dtype.type(0)),
                                              device=self.device) for a in (y, m, keep))
                vb = torch.as_tensor(ok & ((idx % 2 == 0) | (not half)), device=self.device)
                sb = ss[b, lo:lo + REF_CHUNK]
                if self.config["model"] == "bsc":
                    lp, mg = rm.block(sums, yb, vb, sb, th, prec)
                else:
                    lp, mg, yr = rm.block(sums, yb, mb, xb, vb, sb, th, prec, incomplete)
                    if y_rec is not None:
                        y_rec[idx[ok]] = yr[torch.as_tensor(ok, device=self.device)].double(
                        ).cpu().numpy()
                lpj[b, lo:lo + REF_CHUNK], mag[b, lo:lo + REF_CHUNK] = lp, mg
        if not local:
            for v in sums.values():
                _allreduce(v)
        kw = {} if self.config["model"] == "bsc" else dict(
            incomplete=incomplete, to_learn=self.to_learn)
        theta, F = rm.finish(sums, th, prec, D, H, **kw)
        # the sample: its rows' states before and after the epoch
        flat = rows.reshape(-1)[self.sample]
        ys = torch.as_tensor(y[flat], device=self.device)
        ms = torch.as_tensor(m[flat], device=self.device)
        new = ss.reshape(nb * B, S, H)[torch.as_tensor(self.sample, device=self.device)]
        if self.config["model"] == "bsc":
            old_l, old_m = rm.lpj(ys, self.sample_old, th, prec)[:2]
            new_l, new_m = rm.lpj(ys, new, th, prec)[:2]
        else:
            old_l, old_m = rm.lpj(ys, ms, self.sample_old, th, prec)
            new_l, new_m = rm.lpj(ys, ms, new, th, prec)
        valid = torch.as_tensor(rows < N, device=self.device)
        return dict(lpj=lpj, mag=mag, valid=valid, theta=theta, F=float(F), y_rec=y_rec,
                    sample=(self.sample_old, old_l, old_m, new, new_l, new_m))

    def check(self) -> dict:
        """{number: value}: the program's checked epoch against the
        reference."""
        return self.compare(self.program_outputs(), self.reference(Prec()))

    def control_readings(self) -> dict:
        """{what: {number: value}} of the control (the reference in float32
        with TF32 products, put in the program's place), of the fault of a
        half batch planted in the reference, and of an unchanged state
        (Theta_t in place of Theta_{t+1}), each against the reference."""
        ref = self.reference(Prec())
        out = {}
        faults = [("control", dict(prec=Prec(torch.float32, tf32=True))),
                  ("half", dict(prec=Prec(), half=True))]
        if self.world > 1:
            faults.append(("no_exchange", dict(prec=Prec(), local=True)))
        for what, kw in faults:
            r = self.reference(**kw)
            merged = {}
            if r["y_rec"] is not None and self.merged:
                im = self.job["ref"]["image"]
                dc = self.ref_rows()[3]
                mean, median = ref_images.merge(r["y_rec"], dc, im["clean"].shape, im["patch"])
                merged = dict(reco_img_mean=mean, reco_img_median=median,
                              psnr_mean=ref_images.psnr(im["clean"], mean),
                              psnr_median=ref_images.psnr(im["clean"], median))
            out[what] = self.compare(dict(lpj=r["lpj"], theta=r["theta"], F=r["F"],
                                          merged=merged), ref)
        out["unchanged"] = {k: float((self.theta_in[k].double() - v).norm() / v.norm())
                            for k, v in ref["theta"].items()}
        # planted in the reference: a merge that drops each sampled
        # datapoint's best state for its worst, and Theta^0 of another seed
        _, old_l, old_m, _, _, new_m = ref["sample"]
        spread = (old_l.max(1).values - old_l.min(1).values) / torch.cat([old_m, new_m], 1).mean(1)
        y, m, _, _ = self.ref_rows()
        kw = {} if self.config["model"] == "bsc" else dict(to_learn=self.to_learn)
        other = self.ref_model.theta0(np.where(m, y, np.nan), self.job["init_seed"] + 1,
                                      self.config["H"], **kw)
        out["planted"] = dict(
            merge=float(_allreduce(spread.max().reshape(1), "max")),
            theta0=max(float(np.linalg.norm(self.theta0[k] - np.asarray(v))
                             / max(np.linalg.norm(v), 1e-300)) for k, v in other.items()))
        return out

    def program_outputs(self) -> dict:
        est = self.estate_out
        return dict(lpj=est.lpj[..., -est.ss.shape[2]:], theta=self.theta_out, F=self.F_out,
                    merged=self.merged)

    def compare(self, prog: dict, ref: dict) -> dict:
        out = {}
        gap = torch.nan_to_num((prog["lpj"].double() - ref["lpj"]).abs() / ref["mag"],
                               nan=float("inf"))
        gap = torch.where(ref["valid"][..., None], gap, 0.0)
        out["lpj"] = float(_allreduce(gap.max().reshape(1), "max"))
        out["F"] = abs(prog["F"] - ref["F"]) / abs(ref["F"])
        for k, v in ref["theta"].items():
            p = prog["theta"][k].double().to(v.device)
            out[k] = float((p - v).norm() / v.norm().clamp(min=1e-300))
        old, old_l, old_m, new, new_l, new_m = ref["sample"]
        # a state dropped from K^(n) may not beat one that was kept
        same = (old[:, :, None, :] == new[:, None, :, :]).all(-1)  # [n, S_old, S_new]
        dropped = ~same.any(2)
        worst_dropped = torch.where(dropped, old_l, -torch.inf).max(1).values
        least_kept = new_l.min(1).values
        scale = torch.cat([old_m, new_m], 1).mean(1)
        viol = ((worst_dropped - least_kept) / scale).clamp(min=0.0)
        out["merge"] = float(_allreduce(viol.max().reshape(1), "max"))
        dup = (new[:, :, None, :] == new[:, None, :, :]).all(-1).sum() - new.shape[0] * new.shape[1]
        out["dups"] = float(_allreduce(dup.double().reshape(1)))
        out.update(self.check_start())
        if prog["merged"] and ref["y_rec"] is not None:
            im = self.job["ref"]["image"]
            _, _, _, dc = self.ref_rows()
            mean, median = ref_images.merge(ref["y_rec"], dc, im["clean"].shape, im["patch"])
            out["image"] = max(float(np.abs(prog["merged"]["reco_img_mean"] - mean).max()),
                               float(np.abs(prog["merged"]["reco_img_median"] - median).max()))
            out["psnr"] = max(abs(prog["merged"]["psnr_mean"] - ref_images.psnr(im["clean"], mean)),
                              abs(prog["merged"]["psnr_median"]
                                  - ref_images.psnr(im["clean"], median)))
        return out

    def check_start(self) -> dict:
        """Theta^0 against the reference's, and the first rows of K^0
        against the reference's draw (rank 0)."""
        y, m, _, _ = self.ref_rows()
        Y = np.where(m, y, np.nan)
        kw = {} if self.config["model"] == "bsc" else dict(to_learn=self.to_learn)
        th0 = self.ref_model.theta0(Y, self.job["init_seed"], self.config["H"], **kw)
        gap = max(float(np.linalg.norm(np.asarray(self.theta0[k]) - np.asarray(v))
                        / max(np.linalg.norm(v), 1e-300)) for k, v in th0.items())
        out = {"theta0": gap}
        if self.rank == 0:
            rows = self.states0.shape[0]
            want = first_states(self.job["init_seed"], rows, self.config["S"], self.config["H"],
                                y.shape[0])
            out["states0"] = float((self.states0 != want).any(-1).sum())
        return out

    # ------------------------------------------------------------ per layer

    def spans(self) -> dict:
        """{name: [seconds]} of the trainer's begin/end tracepoint pairs
        inside the window."""
        with open(self.tracefile) as f:
            lines = f.read().splitlines()[1:]
        pts = [(float(t), name) for t, name in (ln.split(" ", 1) for ln in lines)]
        lo = next(t for t, n in pts if n == "portbench.window:begin")
        hi = next(t for t, n in pts if n == "portbench.window:end")
        opened, out = {}, {}
        for t, name in pts:
            if not lo <= t <= hi or ":" not in name:
                continue
            base, edge = name.rsplit(":", 1)
            if edge == "begin":
                opened[base] = t
            elif edge == "end" and base in opened:
                out.setdefault(base, []).append(t - opened.pop(base))
        return out

    def work(self):
        """(least kernel seconds, f32 operations) of one epoch of the
        profiled stretch, from the state sets at its two ends."""
        n = 0.5 * (self.counts_start[0] + self.counts_end[0])
        u = 0.5 * (self.counts_start[1] + self.counts_end[1])
        P = self.cell["profile_epochs"]
        rec_at = self.job["reconstruct_at"]
        n_rec = sum(bool(rec_at(e)) for e in range(self.stretch_first, self.stretch_first + P)) \
            if rec_at else 0
        ea = dict(self.config["ea"], H=self.config["H"])
        incomplete = self.job["incomplete"]
        D = self.job["D"]
        calls, dense0 = self.ref_model.epoch_work(n, u, ea, D, incomplete, False)
        dense = dense0
        if n_rec:
            dense1 = self.ref_model.epoch_work(n, u, ea, D, incomplete, True)[1]
            dense = ((P - n_rec) * dense0 + n_rec * dense1) / P
        f32 = sum(c["f32"] for c in calls) + dense
        if self.peaks is None:
            return None, f32
        return sum(bounds.seconds(c, self.peaks) for c in calls), f32

    def read_metrics(self) -> dict:
        """{metric: {value, unit}} of this cell's per-layer metrics; a reader
        that finds nothing to read returns None and is left out."""
        prof = devtrace.summarize(self.chrome)
        self.profile = prof
        bound_s, f32 = self.work()
        ctx = SimpleNamespace(
            spans=self.spans(), epochs=len(self.durations), window_s=self.window_s,
            durations=self.durations,
            enqueue=self.enqueue, allreduce=self.allreduce, profile=prof,
            profile_epochs=self.cell["profile_epochs"], kernel_bound_s=bound_s,
            f32_per_epoch=f32, peaks=self.peaks, world=self.world)
        out = {}
        for m in self.sp["per_layer"]:
            v = spec.reader(m["name"], self.sp["root"])(ctx)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out
