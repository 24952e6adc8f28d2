"""The EM epoch of EBSC and ES3C, written once: ``EMModel``, the base of
``BSC`` and ``SSSC``.

This module owns the epoch's shape: the block loop, the phases and their
spans, the EA (``evolve_states_block``) and the merge (``merge_states``),
the CUDA graphs, the counters, the sum over the ranks and ``StepStats``.
A model supplies its math: ``check_params``, ``_precompute`` and
``DATA_SUMS``; ``_theta(params, pre)``, the Theta its phases read (the
static buffers when graphed); ``_lpj(io, cfg, states)`` -> (lpj, dedup
keys or None, reset counts [3]); ``_states_in`` / ``_states_out``, a
block's stored states as the phases work on them and back;
``_sum_shapes()`` and ``_suffstat_phase(io, acc, cfg)``, its M-step sums
(plus F into ``acc.Fsum`` and the stored lpj ``io.lpj_full``);
``_m_step_finalize`` -> (params, the guard fields of ``StepStats`` it
sets); ``_graphable(data)`` and ``LAUNCH_COUNTERS`` for the graphs (its
kernels' counters after the runner's own, the merge kernel's).

A block's phases read and write the namespace ``io`` (its inputs, Theta
and what each phase leaves for the next) under the spans ``em_step.lpj``
(``block_gram`` and K^(n)'s lpj; the children's lpj is an ``em_step.lpj``
nested in the EA's when eager), ``em_step.ea``, ``em_step.merge`` and
``em_step.suffstat``; then ``em_step.mstep``.  Exact mode has no EA and
no merge.  Where the mechanism engages (``block_graphs.engages``: a CUDA
device, complete data, an EA epoch without reconstruction) and the model
allows it, each phase is captured once as a CUDA graph and replayed in
every later block (``block_graphs.PhaseGraphs``): the same ops in the same
order, with the same draws.  The M-step stays eager: its inverse checks
its result on the host.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import torch

from evo_tpu_torch.models import block_graphs
from evo_tpu_torch.models.base import (
    Data,
    StepStats,
    block_gram,
    check_em_step,
    sum_over_ranks,
    total_free_energy,
)
from evo_tpu_torch.ops.numerics import shifted_logsumexp
from evo_tpu_torch.ops.varykn_merge import varykn_merge
from evo_tpu_torch.parallel import distributed
from evo_tpu_torch.utils import tracing
from evo_tpu_torch.variational.config import EAConfig
from evo_tpu_torch.variational.evolve import evolve_states_block
from evo_tpu_torch.variational.state_init import EState, full_state_matrix
from evo_tpu_torch.variational.varykn import merge_states

# the accumulators of every epoch beside the model's M-step sums
COUNTERS = ("Fsum", "nuni", "nsub", "resets")


class EMModel:
    """``em_step``, ``free_energy`` and ``exact_free_energy`` from the
    model's members listed in the module docstring."""

    # the launch counters of the runner's kernels, which a replayed block
    # advances as an eager one does; a model adds its own after them
    LAUNCH_COUNTERS = ((varykn_merge, "launches"),)

    def _states_in(self, ss, cfg: EAConfig):
        return ss

    def _states_out(self, ss, cfg: EAConfig):
        return ss

    # ---------------------------------------------------------------- phases

    def _lpj_phase(self, io, cfg: EAConfig):
        """``block_gram``, the block's states as the phases work on them
        (``io.K``) and their lpj; in exact mode also the E-step's results
        (K^(n) kept, nothing new)."""
        io.G, io.Wty, io.y2 = block_gram(io.W, io.y, io.x_infr, io.incomplete)
        io.K = self._states_in(io.ss, cfg)
        io.lpj_K, io.keys_K, io.counts = self._lpj(io, cfg, io.K)
        if cfg.exact:
            zeros = torch.zeros(io.K.shape[0], dtype=torch.int64, device=io.K.device)
            io.ss2, io.lpj2, io.n_uni, io.n_sub = io.K, io.lpj_K, zeros, zeros

    def _ea_phase(self, io, cfg: EAConfig, generator, rows):
        """Children by ``evolve_states_block``, their lpj (eagerly an
        ``em_step.lpj`` span nested in the EA's).  ``rows``
        (``distributed.block_rows``) makes the EA draw the global block's
        random numbers and keep this rank's rows."""
        def lpj_block(states):
            with tracing.span("em_step.lpj", io.dev):
                return self._lpj(io, cfg, states)

        io.children, io.child_lpj, io.new_unique, io.child_lpj_raw, aux = evolve_states_block(
            io.K, io.lpj_K, lpj_block, cfg, io.piH, generator, ss_dkeys=io.keys_K, rows=rows)
        io.counts = io.counts + sum(aux)

    def _merge_phase(self, io, cfg: EAConfig):
        """The merge ``cfg`` asks for: the new K^(n) and its lpj, and the
        counters n_uni [B], n_sub [B].  What only the merge reads is let go
        before the statistics, whose temporaries set the wide path's peak."""
        io.ss2, io.lpj2, io.n_uni, io.n_sub, _ = merge_states(
            cfg, io.K, io.lpj_K, io.children, io.child_lpj, io.new_unique, io.child_lpj_raw)
        del io.lpj_K, io.keys_K, io.children, io.child_lpj, io.new_unique, io.child_lpj_raw

    def _end_phase(self, io, acc, cfg: EAConfig):
        """The model's statistics, the counters, and the block's states as
        they are stored (``io.ss_out``)."""
        self._suffstat_phase(io, acc, cfg)
        acc.nuni += (io.n_uni * io.valid).sum()
        acc.nsub += (io.n_sub * io.valid).sum()
        acc.resets += io.counts
        io.ss_out = self._states_out(io.ss2, cfg)

    def _phases(self, io, acc, cfg: EAConfig, generator, rows):
        """[(span name, phase of no argument)] of a block."""
        phases = [("em_step.lpj", lambda: self._lpj_phase(io, cfg))]
        if not cfg.exact:
            phases += [("em_step.ea", lambda: self._ea_phase(io, cfg, generator, rows)),
                       ("em_step.merge", lambda: self._merge_phase(io, cfg))]
        phases.append(("em_step.suffstat", lambda: self._end_phase(io, acc, cfg)))
        return phases

    def _accumulators(self, dt, dev) -> SimpleNamespace:
        """The epoch's zeroed M-step sums and ``COUNTERS``."""
        def zeros(shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        i64 = torch.int64
        return SimpleNamespace(**{k: zeros(s) for k, s in self._sum_shapes().items()},
                               Fsum=zeros(()), nuni=zeros((), i64), nsub=zeros((), i64),
                               resets=zeros((3,), i64))

    # ---------------------------------------------------------------- blocks

    def _graphs_engage(self, device, data: Data, cfg: EAConfig, do_reconstruction: bool):
        """Whether the blocks replay graphs: the mechanism's rule and the model's."""
        return (block_graphs.engages(device, data.incomplete, cfg.exact, do_reconstruction)
                and self._graphable(data))

    def _block_graphs(self, estate: EState, data: Data, cfg: EAConfig, rows, theta: dict,
                      dt, dev):
        """The model's ``PhaseGraphs`` for this device, these block shapes
        and dtypes, ``cfg`` and ``rows``: the ones kept on the model, or new
        ones (not yet captured) in their place."""
        key = (dev, tuple(estate.ss.shape[1:]), estate.ss.dtype, tuple(data.y.shape[1:]),
               data.y.dtype, dt, cfg, rows)
        graphs = self.__dict__.get("_graphs")
        if graphs is not None and graphs.key == key:
            return graphs
        object.__setattr__(self, "_graphs", None)  # free the old graphs and buffers first
        B, D = data.y.shape[1:]
        io = SimpleNamespace(
            dev=dev, incomplete=False, x=None, x_infr=None, y_rec=None,
            y=torch.empty((B, D), dtype=data.y.dtype, device=dev),
            valid=torch.empty((B,), dtype=torch.bool, device=dev),
            ss=torch.empty(estate.ss.shape[1:], dtype=estate.ss.dtype, device=dev),
            **{k: torch.empty(t.shape, dtype=t.dtype, device=dev) for k, t in theta.items()})
        graphs = block_graphs.PhaseGraphs(key, dev, io, self._accumulators(dt, dev),
                                          self.LAUNCH_COUNTERS)
        object.__setattr__(self, "_graphs", graphs)
        return graphs

    @staticmethod
    def _run_block(i, phases, io, data, estate, ss_all, lpj_all, y_rec_all, graphs):
        """Block ``i``'s phases under their spans, eagerly or (``graphs``
        captured) as replays; its inputs go into ``io`` as views or (with
        ``graphs``) copied into the static buffers, and its stored states
        and lpj into ``ss_all[i]`` and ``lpj_all[i]``."""
        replay = graphs is not None and graphs.captured
        for k, (name, phase) in enumerate(phases):
            with tracing.span(name, io.dev):
                if k == 0 and graphs is not None:
                    io.y.copy_(data.y[i])
                    io.valid.copy_(data.row_valid[i])
                    io.ss.copy_(estate.ss[i])
                elif k == 0:
                    io.y, io.valid, io.ss = data.y[i], data.row_valid[i], estate.ss[i]
                    io.x, io.x_infr = data.x[i], data.x_infr[i]
                    io.y_rec = None if y_rec_all is None else y_rec_all[i]
                if replay:
                    graphs.replay(k)
                else:
                    phase()
                if k == len(phases) - 1:
                    ss_all[i] = io.ss_out
                    lpj_all[i] = io.lpj_full

    # ----------------------------------------------------------------- epoch

    def em_step(self, params, estate: EState, data: Data, generator: torch.Generator,
                cfg: EAConfig, do_reconstruction: bool = False):
        """One EM epoch: E-step, optional reconstruction and M-step over all
        blocks.

        Returns (new_params, new_estate, stats, y_rec [nb, B, D] or None).
        As in evo_tpu, F is the free energy of the updated K^(n) under the
        old parameters, and the M-step consumes the merged states and their
        lpj.  ``generator`` (on the data's device) drives every random draw
        of the EA; under a process group every rank passes the same one,
        and the statistics, counters and F are summed over the ranks in one
        all_reduce after the blocks.  Graphs are captured in the first
        graphed epoch and kept on the model for these shapes, dtypes,
        ``cfg`` and ranks.  The counters ``em_step.blocks``,
        ``em_step.graph_blocks`` (blocks replayed),
        ``em_step.graph_captures`` and, in an EA epoch, ``merge.kernel_blocks``
        (the merge kernel's launches, one a block that it merged) go to the
        innermost open tracing span."""
        check_em_step(data, do_reconstruction)
        params = self.check_params(params)
        pre = self._precompute(params, data)
        rows = distributed.block_rows(data.y.shape[1])
        dt, dev = params.W.dtype, params.W.device
        theta = self._theta(params, pre)
        graphs = None
        if self._graphs_engage(dev, data, cfg, do_reconstruction):
            graphs = self._block_graphs(estate, data, cfg, rows, theta, dt, dev)
            io = graphs.io
            for name, t in theta.items():
                getattr(io, name).copy_(t)
            acc, gen = graphs.acc, graphs.begin_epoch(generator)
        else:
            # contiguous, as the static buffers hold it: cuBLAS may sum
            # otherwise in the transposed layout that an M-step returns
            io = SimpleNamespace(dev=dev, incomplete=data.incomplete,
                                 **{k: t.contiguous() for k, t in theta.items()})
            acc, gen = self._accumulators(dt, dev), generator
        ss_all = torch.empty_like(estate.ss)
        lpj_all = torch.empty_like(estate.lpj)
        y_rec_all = torch.empty_like(data.y) if do_reconstruction else None
        phases = self._phases(io, acc, cfg, gen, rows)
        replayed = captures = 0
        merges = varykn_merge.launches
        for i in range(data.n_blocks):
            run = functools.partial(self._run_block, i, phases, io, data, estate, ss_all,
                                    lpj_all, y_rec_all, graphs)
            if graphs is not None and not graphs.captured:
                # block 0 of the first graphed epoch: the warm-up, then the capture
                graphs.warm_up(run)
                graphs.capture([phase for _, phase in phases])
                captures += 1
            else:
                replayed += graphs is not None
                run()
        if graphs is not None:
            acc = graphs.end_epoch()
        tracing.count("em_step.blocks", data.n_blocks)
        if replayed:
            tracing.count("em_step.graph_blocks", replayed)
        if captures:
            tracing.count("em_step.graph_captures", captures)
        if not cfg.exact:
            tracing.count("merge.kernel_blocks", varykn_merge.launches - merges)

        with tracing.span("em_step.mstep", dev):
            acc = vars(acc)
            pre, sums, tot = sum_over_ranks(
                self, params, data, pre, {k: t for k, t in acc.items() if k not in COUNTERS},
                {k: acc[k] for k in COUNTERS})
            new_params, guards = self._m_step_finalize(params, sums, pre, data.incomplete, cfg)
            N, resets = pre["N"], tot["resets"]
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            guards = {"n_guard_sigma_floor": zero, "n_guard_mus_freeze": zero,
                      "n_guard_psi_freeze": zero,
                      "guard_psi_renorm": torch.zeros((), dtype=torch.float32, device=dev),
                      **guards}
            stats = StepStats(
                F=pre["ljc"] + tot["Fsum"] / N, S_nunique=tot["nuni"] / N, S_sub=tot["nsub"] / N,
                n_reset_nan=resets[0], n_reset_small=resets[1], n_reset_inf=resets[2],
                **guards)
        return new_params, EState(ss=ss_all, lpj=lpj_all), stats, y_rec_all

    # ----------------------------------------------------------- free energy

    def exact_free_energy(self, params, data: Data) -> torch.Tensor:
        """Exact log-likelihood by enumerating all 2^H states (small H): the
        correctness oracle (reference _models.py:334-451), over every rank
        under a process group."""
        params = self.check_params(params)
        pre = self._precompute(params, data)
        io = SimpleNamespace(incomplete=data.incomplete, valid=None, **self._theta(params, pre))
        cfg = EAConfig(S=2**self.H, H=self.H, n_parents=0, n_children=0, n_generations=0,
                       exact=True)
        sm = torch.from_numpy(full_state_matrix(self.H).view(np.int8)).to(params.W.device)
        Fsum = torch.zeros((), dtype=params.W.dtype, device=params.W.device)
        for i in range(data.n_blocks):
            io.G, io.Wty, io.y2 = block_gram(io.W, data.y[i], data.x_infr[i], data.incomplete)
            lpj = self._lpj(io, cfg, sm.expand(data.y.shape[1], -1, -1).contiguous())[0]
            Fsum += (shifted_logsumexp(lpj) * data.row_valid[i].to(lpj.dtype)).sum()
        return total_free_energy(self, params, data, pre, Fsum)

    def free_energy(self, params, estate: EState, data: Data) -> torch.Tensor:
        """Truncated free energy from the stored lpj (over every rank under
        a process group)."""
        params = self.check_params(params)
        pre = self._precompute(params, data)
        lpj = estate.lpj.reshape(-1, estate.lpj.shape[-1])
        Fsum = (shifted_logsumexp(lpj) * data.row_valid.reshape(-1).to(lpj.dtype)).sum()
        return total_free_energy(self, params, data, pre, Fsum)
