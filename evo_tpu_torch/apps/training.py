"""The apps' epoch loop (counterpart: evo_tpu/apps/training.py), with
checkpoint and resume.

Epoch e draws from ``epoch_generator(seed, e)``, so a run stepped epoch by
epoch, the same run in chunks (``chunk_epochs``, through
``models.base.em_steps``) and a run resumed from a checkpoint follow one
trajectory bit for bit.

Observability:
  - theta_append=False overwrites the parameter tables (DataLog.assign),
    so training.h5 keeps a constant size; chunked epochs need it.
  - tracefile records host spans (``utils.tracing``) around every phase
    of an epoch (em_step or em_steps, stats_wait inside it, log,
    epoch_callback, checkpoint) and the models' em_step.* phases, each
    epoch's EA counters (ea.children, ea.unique) and, where bsc_suffstat
    ran, its row counters (suffstat.sparse_rows, suffstat.dense_rows), and
    where the ES3C suffstat kernels ran, theirs (sssc_suffstat.sparse_rows,
    sssc_suffstat.dense_rows) on em_step, and resolves the phases' device
    times after each stats transfer.
  - device_trace_every=N records one epoch in every N with torch.profiler
    into <outdir>/device_trace (a Chrome trace).
Each epoch's (or chunk's) statistics reach the host in one transfer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from evo_tpu_torch.apps.common import merge_dict, params_to_dict, to_host
from evo_tpu_torch.models.base import StepStats, em_steps, epoch_generator
from evo_tpu_torch.models.sssc import SSSC
from evo_tpu_torch.ops import sssc_suffstat
from evo_tpu_torch.ops.bsc_suffstat import row_counts
from evo_tpu_torch.ops.sssc_lpj import overflow_cap
from evo_tpu_torch.parallel import distributed
from evo_tpu_torch.utils import tracing
from evo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


def stats_to_host(stats: StepStats) -> StepStats:
    """Every field (0-dim, or [n] from em_steps) to NumPy in one transfer:
    the fields go through one f64 tensor, which holds f32 values and the
    counters exactly."""
    names = [f.name for f in dataclasses.fields(StepStats)]
    vals = [getattr(stats, n) for n in names]
    host = to_host({"all": torch.stack([v.to(torch.float64) for v in vals])})["all"]
    return StepStats(**{n: host[i].astype(torch.empty(0, dtype=v.dtype).numpy().dtype)
                        for i, (n, v) in enumerate(zip(names, vals))})


class EMTrainer:
    def __init__(self, model, cfg, params, estate, data, dlog, outdir: str,
                 seed: int = 0, checkpoint_every: int = 0,
                 resume: Optional[str] = None, theta_append: bool = True,
                 tracefile: Optional[str] = None, device_trace_every: int = 0,
                 chunk_epochs: int = 1):
        self.model, self.cfg, self.data = model, cfg, data
        self.params, self.estate = params, estate
        self._overflow_nan_streak, self._overflow_warned = 0, False
        self.dlog, self.outdir = dlog, outdir
        self.checkpoint_every = checkpoint_every
        self.theta_append = theta_append
        self.device_trace_every = device_trace_every
        # chunk_epochs > 1: runs of epochs the host need not see go through
        # em_steps.  Their F/S_*/guard metrics are still logged per epoch;
        # Theta and epoch_callback only at a chunk's end, whence the
        # overwrite mode.  Device-trace epochs run solo, and checkpoint
        # boundaries end chunks.
        self.chunk_epochs = max(1, int(chunk_epochs))
        if self.chunk_epochs > 1 and theta_append:
            raise ValueError(
                "chunk_epochs > 1 cannot log Theta per epoch "
                "(intermediate params stay on device); use "
                "theta_append=False (the Theta-overwrite logging mode)")
        self.start_epoch = 0
        self.seed = seed
        self._tracing = bool(tracefile)
        if tracefile:
            if not os.path.isabs(tracefile) and os.path.sep not in tracefile:
                tracefile = os.path.join(outdir, tracefile)
            tracing.set_tracefile(tracefile)
        if resume:
            self.params, self.estate, self.start_epoch, self.seed = load_checkpoint(
                resume, params_like=self.params, cfg=self.cfg, model=self.model, data=self.data)
            print(f"Resumed from {resume} at epoch {self.start_epoch}")

    def _await_stats(self, stats: StepStats) -> StepStats:
        """``stats_to_host``, the step's completion barrier (span
        ``stats_wait``); then the device times of the step's spans, and
        the EA's counters on the open span: ``ea.children``, this rank's
        rows times the children a datapoint's EA evaluates, and
        ``ea.unique``, S_nunique (new unique children per datapoint, from
        the stats) times those rows; while spans are recorded, also
        ``suffstat.sparse_rows`` and ``suffstat.dense_rows``, the rows
        that ``bsc_suffstat`` summed sparsely and densely since the last
        such read (none where it has not run: ES3C), and
        ``sssc_suffstat.sparse_rows`` and ``sssc_suffstat.dense_rows``, the
        rows that the ES3C suffstat kernels solved by a lane and by a warp
        (none where they have not run: EBSC, the wide path), each a
        transfer after the stats' own."""
        with tracing.span("stats_wait"):
            stats = stats_to_host(stats)
        tracing.resolve()
        if tracing.active():
            summed = row_counts(self.data.y.device)
            if summed is not None:
                tracing.count("suffstat.sparse_rows", summed[0])
                tracing.count("suffstat.dense_rows", summed[1])
            solved = sssc_suffstat.row_counts(self.data.y.device)
            if solved is not None:
                tracing.count("sssc_suffstat.sparse_rows", solved[0])
                tracing.count("sssc_suffstat.dense_rows", solved[1])
        if self.cfg.n_new:
            rows = self.data.row_valid.numel()
            s_nunique = np.atleast_1d(stats.S_nunique)
            tracing.count("ea.children", rows * self.cfg.n_new * s_nunique.size)
            tracing.count("ea.unique", int(np.rint(s_nunique.astype(np.float64) * rows).sum()))
        return stats

    def _log_epoch(self, stats, log_theta: bool = True):
        metrics = {"F": float(stats.F), "S_nunique": float(stats.S_nunique),
                   "S_sub": float(stats.S_sub)}
        if not log_theta:
            self.dlog.append_all(metrics)
            return
        theta = params_to_dict(self.params)
        if self.theta_append:
            self.dlog.append_all(merge_dict(metrics, theta))
        else:
            # overwrite mode: training.h5 holds only the latest Theta
            self.dlog.append_all(metrics)
            for name, value in theta.items():
                self.dlog.assign(name, value)

    def _print_guards(self, stats):
        for name in ("n_reset_nan", "n_reset_small", "n_reset_inf",
                     "n_guard_sigma_floor", "n_guard_mus_freeze", "n_guard_psi_freeze"):
            v = int(getattr(stats, name))
            if v > 0:
                print(f"\t{name} = {v}")
        self._warn_bucket_overflow(int(stats.n_reset_nan))
        renorm = float(stats.guard_psi_renorm)
        if renorm > 0.1:  # only non-trivial gauge corrections
            print(f"\tguard_psi_renorm = {renorm:.3f}")

    def _warn_bucket_overflow(self, n_reset_nan: int):
        """At 64 < H <= 128 on complete data the SSSC kernels flag states
        with more than ``overflow_cap(H)`` (16) active units as bad instead
        of evaluating them, and their lpj is reset: exact under sparse
        priors, lossy if pies drift dense.  Nonzero nan-reset counters for 3
        epochs in a row are the symptom; warn once.  The wide path (see
        models/sssc.py) has no cap."""
        if n_reset_nan == 0:
            self._overflow_nan_streak = 0
            return
        if (self._overflow_warned or not isinstance(self.model, SSSC) or self.model.H <= 64
                or self.model.wide(self.data)):
            return
        self._overflow_nan_streak += 1
        if self._overflow_nan_streak >= 3:
            self._overflow_warned = True
            warnings.warn(
                f"n_reset_nan nonzero for {self._overflow_nan_streak} "
                f"consecutive epochs at H={self.model.H}: the SSSC kernels "
                f"flag states with more than {overflow_cap(self.model.H)} "
                "active units as bad and reset their lpj instead of "
                "evaluating them. If pies have drifted dense, the "
                "posterior over such states is lost.", RuntimeWarning)

    def _maybe_checkpoint(self, epoch: int):
        """Write the checkpoint if ``epoch`` is a boundary (shared by the
        per-epoch and chunked paths, so that their files are alike)."""
        if not (self.checkpoint_every and epoch % self.checkpoint_every == 0):
            return
        path = os.path.join(self.outdir, "checkpoint.npz")
        with tracing.span("checkpoint"):
            save_checkpoint(path, self.params, self.estate, epoch, self.seed,
                            cfg=self.cfg, model=self.model, data=self.data)
        print(f"\tcheckpoint -> {path}")

    def _chunk_len(self, e: int, no_epochs: int, reconstruct_at) -> int:
        """Largest n <= chunk_epochs such that epochs [e, e+n) need no host
        step inside: no reconstruction or device-trace epoch, and any
        checkpoint boundary falls at the chunk's end."""
        n = 0
        for b in range(e, min(e + self.chunk_epochs, no_epochs)):
            if reconstruct_at is not None and bool(reconstruct_at(b)):
                break  # solo: the host consumes y_rec
            if self.device_trace_every and (b + 1) % self.device_trace_every == 0:
                break  # solo: the profiler brackets a single em_step
            n += 1
            if self.checkpoint_every and (b + 1) % self.checkpoint_every == 0:
                break  # the checkpoint needs the state here
        return max(1, n)

    def _run_chunk(self, e: int, n: int, no_epochs: int, epoch_callback):
        """Epochs [e, e+n) through em_steps.  Per-epoch metrics are logged
        from the stacked stats; Theta (overwrite mode) and epoch_callback
        once at the chunk's end.  Returns (next epoch, host stats of the
        last epoch)."""
        self.dlog.progress(f"Epochs {e + 1}-{e + n} of {no_epochs} (one chunk)")
        t0 = time.time()
        tracing.set_epoch(e)
        with tracing.span("em_steps"):
            self.params, self.estate, stats_all = em_steps(
                self.model, self.params, self.estate, self.data, self.seed, self.cfg, n, e0=e)
            stats_all = self._await_stats(stats_all)

        with tracing.span("log"):
            stats = None
            for i in range(n):
                stats = StepStats(**{k: v[i] for k, v in vars(stats_all).items()})
                self._log_epoch(stats, log_theta=(i == n - 1))
                self._print_guards(stats)
        if epoch_callback is not None:
            with tracing.span("epoch_callback"):
                epoch_callback(epoch=e + n, F=float(stats.F), params=self.params, stats=stats,
                               y_rec=None)
        self._maybe_checkpoint(e + n)
        print("\tTotal chunk runtime : %.2f s (%d epochs)" % (time.time() - t0, n))
        return e + n, stats

    def run(self, no_epochs: int, reconstruct_at: Optional[Callable[[int], bool]] = None,
            epoch_callback: Optional[Callable] = None):
        """Train up to epoch ``no_epochs`` (from the resumed epoch, if any).

        ``epoch_callback(epoch=, F=, params=, stats=, y_rec=)`` is called
        after each logged epoch; with chunk_epochs > 1 only at a chunk's
        end (``epoch`` then jumps by the chunk's length and ``y_rec`` is
        None).  The per-epoch metrics of every epoch are logged either way.
        Returns (params, estate, host stats of the last epoch)."""
        stats = None
        if self.start_epoch >= no_epochs:
            # resumed at (or past) the final epoch: no step to run, but the
            # callers read stats.F, taken here from the checkpointed state
            print(f"Training already complete at epoch {self.start_epoch} "
                  f">= {no_epochs}; nothing to run")
            F = self.model.free_energy(self.params, self.estate, self.data)
            z = np.zeros((), np.int64)
            stats = StepStats(F=to_host({"F": F})["F"], S_nunique=z, S_sub=z, n_reset_nan=z,
                              n_reset_small=z, n_reset_inf=z, n_guard_sigma_floor=z,
                              n_guard_mus_freeze=z, n_guard_psi_freeze=z,
                              guard_psi_renorm=np.zeros((), np.float32))
        dev = self.data.y.device
        e = self.start_epoch
        while e < no_epochs:
            n_chunk = (self._chunk_len(e, no_epochs, reconstruct_at)
                       if self.chunk_epochs > 1 else 1)
            if n_chunk > 1:
                e, stats = self._run_chunk(e, n_chunk, no_epochs, epoch_callback)
                continue
            rec = bool(reconstruct_at(e)) if reconstruct_at else False
            self.dlog.progress(f"Epoch {e + 1} of {no_epochs}")
            t0 = time.time()
            capture = self.device_trace_every and (e + 1) % self.device_trace_every == 0
            profile_dir = os.path.join(self.outdir, "device_trace")
            tracing.set_epoch(e)
            with tracing.span("em_step"):
                with tracing.device_trace(profile_dir) if capture else contextlib.nullcontext():
                    self.params, self.estate, stats, y_rec = self.model.em_step(
                        self.params, self.estate, self.data, epoch_generator(self.seed, e, dev),
                        self.cfg, do_reconstruction=rec)
                    stats = self._await_stats(stats)
                F = float(stats.F)
            if capture:
                print(f"\tdevice trace -> {profile_dir}")

            with tracing.span("log"):
                self._log_epoch(stats)
            self._print_guards(stats)
            if epoch_callback is not None:
                with tracing.span("epoch_callback"):
                    epoch_callback(epoch=e + 1, F=F, params=self.params, stats=stats, y_rec=y_rec)
            self._maybe_checkpoint(e + 1)
            print("\tTotal epoch runtime : %.2f s" % (time.time() - t0))
            e += 1
        if self._tracing:
            tracing.close(os.path.join(self.outdir, "traces.tgz"))
        return self.params, self.estate, stats


def gather_reconstruction(y_rec: torch.Tensor, N: int) -> np.ndarray:
    """Blocked reconstruction [nb, B, D] -> host [N, D] without the padding
    rows (evo_tpu/apps/training.py:277-308).

    Under a process group of several ranks every rank gets the whole
    reconstruction, de-interleaved (``deinterleave_processes``) into the
    concatenation of the ranks' own block-major row orders, [rank 0 rows |
    rank 1 rows | ...]; N is then the global row count, and the ranks' data
    must hold no padding rows (it would sit at the end of every rank's
    segment), as in evo_tpu."""
    arr = distributed.gather_global(y_rec)
    world = distributed.rank_world()[1]
    if world > 1:
        arr = deinterleave_processes(arr, world)
        total = int(np.prod(arr.shape[:-1]))
        if total != N:
            raise ValueError(f"gather_reconstruction: global rows {total} != N={N}; "
                             "padding rows per process are not supported")
    return arr.reshape((-1, arr.shape[-1]))[:N]


def deinterleave_processes(arr: np.ndarray, P: int) -> np.ndarray:
    """[nb, B_global, ...] with each block's B axis [p0 rows | p1 rows |
    ...] -> [P, nb, B_local, ...], so that a flat reshape gives the
    concatenation of the processes' own block-major row orders."""
    nb, B_global = arr.shape[:2]
    if B_global % P:
        raise ValueError(f"B_global={B_global} is not a multiple of {P} processes")
    arr = arr.reshape((nb, P, B_global // P) + arr.shape[2:])
    return np.moveaxis(arr, 1, 0)
