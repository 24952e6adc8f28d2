"""Binary Sparse Coding trained with evolutionary E-steps (EBSC).

Counterpart: evo_tpu/models/bsc.py.  Generative model:

    s_h ~ Bernoulli(pi),  y = W s + N(0, sigma^2 I),  W in R^{D x H}

The lpj of a state is evaluated in Gram form, pre1 (y2 - 2 s.Wty + s^T G s)
+ pil_bar |s| with G = W^T W, Wty = W^T y, y2 = ||y||^2 precomputed once
per block, so that a state costs O(H^2) independent of D.

An epoch (``em_step``) is a Python loop over the data blocks.  In each
block the lpj of K^(n) and of each generation's children go through the
``bsc_lpj`` kernel (which also emits the dedup keys), the merged states'
sufficient statistics through the ``bsc_suffstat`` kernel, and the rest is
plain PyTorch on the same device.  Its phases are tracing spans
(``utils.tracing``; no-ops unless a trace file is open), as in ``SSSC``:
``em_step.lpj`` (``block_gram`` and K^(n)'s lpj; run eagerly, the
children's lpj too, nested in the EA's), ``em_step.ea``,
``em_step.merge``, ``em_step.suffstat`` (F, responsibilities, the suffstat
kernel, reconstruction and M-step sums) and, after the blocks,
``em_step.mstep``.

On a CUDA device, on complete data, at the lpj kernel's widths and in EA
epochs without reconstruction (``block_graphs.engages``), each phase of a
block is captured once as a CUDA graph and replayed in every later block
(``block_graphs.PhaseGraphs``): the host issues four replays a block in
place of the chain of launches, and the children's lpj runs inside the
EA's replay.  The ops, their order and the draws are those of the eager
path.  The M-step stays eager: its inverse checks its result on the host.

With ``EAConfig.packed_states`` the state sets stay lane-major bit-packed
through the whole epoch, at every H (evo_tpu needs H % 32 == 0 for this on
the TPU and otherwise unpacks each block; the results are the same): both
kernels read the packed states, the EA keys them from their bytes and
unpacks only the parents, the merge moves packed rows, and only the
reconstruction and ``lpj_gram`` (incomplete data, wide models) unpack what
they read.  The
permanent states (``allzero``, ``background``) and the merges other than
the sorted unification merge (``swap_merge``, ``unification=False``) run
as in evo_tpu.

Incomplete data (NaN entries in ``make_data``) need
``do_reconstruction=True``, as in evo_tpu.  Their lpj runs under the
per-datapoint Gram G_n = W^T diag(m_n) W and is plain PyTorch on every
device (``lpj_gram``): evo_tpu has no TPU kernel for it either
(``pallas_lpj_applicable`` is False for incomplete data), so nothing falls
back here.  ``bsc_suffstat`` does not read the mask and stays the kernel.

Widths: the ``bsc_lpj`` kernel covers H <= ``ops.bsc_lpj.MAX_H`` (1024).
Wider models take evo_tpu's XLA form of the lpj, ``BSC._lpj_one``
(evo_tpu/models/bsc.py:222-229), which is ``lpj_gram`` under the shared
G, on every device; the EA then keys the states itself, as on incomplete
data, and packed states are unpacked for this lpj only.  The path is chosen
from H alone (``BSC.wide``, the limit read when the model is called),
before anything is launched; ``bsc_suffstat`` (H <= 65,535) stays the
kernel.

The reconstruction y_rec = where(x, y, sum_s r W s) is returned blocked
[nb, B, D]; on incomplete data it feeds the W update and the sigma residual.

Under a process group (``evo_tpu_torch.parallel``) the data, states and
reconstruction hold this rank's rows; Theta^0 comes from global sums, and
an epoch sums its accumulators, counters and F over the ranks in one
all_reduce before the M-step.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Tuple

import numpy as np
import torch

from evo_tpu_torch._device import resolve_device
from evo_tpu_torch.models import block_graphs
from evo_tpu_torch.models.base import (
    Data,
    StepStats,
    block_gram,
    check_em_step,
    host_data,
    sum_over_ranks,
    total_free_energy,
)
from evo_tpu_torch.ops import bsc_lpj as bsc_lpj_ops
from evo_tpu_torch.ops.bitpack import unpack_bits_lane
from evo_tpu_torch.ops.bsc_lpj import bsc_lpj
from evo_tpu_torch.ops.bsc_suffstat import bsc_suffstat
from evo_tpu_torch.ops.linalg import equilibrated_pd_inverse
from evo_tpu_torch.ops.numerics import (
    eps_lpj,
    posterior_weights,
    reset_lpj,
    shifted_logsumexp,
)
from evo_tpu_torch.parallel import distributed
from evo_tpu_torch.utils import tracing
from evo_tpu_torch.variational.config import EAConfig
from evo_tpu_torch.variational.evolve import evolve_states_block
from evo_tpu_torch.variational.state_init import EState, full_state_matrix
from evo_tpu_torch.variational.varykn import merge_states

PARAM_TOL = 1e-5  # reference noise_policy bounds (_models.py:47-52)
# the kernels' launch counters, which a replayed block advances as an eager one does
LAUNCH_COUNTERS = ((bsc_lpj, "launches"), (bsc_lpj, "packed_launches"),
                   (bsc_suffstat, "launches"), (bsc_suffstat, "packed_launches"))


@dataclasses.dataclass
class BSCParams:
    W: torch.Tensor  # [D, H]
    pi: torch.Tensor  # scalar
    sigma: torch.Tensor  # scalar
    pies: torch.Tensor  # [H], per-unit pi_h, diagnostic only


def lpj_gram(ss, Wty, y2, G, pre1, pil_bar):
    """lpj [B, K] of states ss [B, K, H] under per-datapoint Grams G
    [B, H, H] (incomplete data) or the shared Gram G [H, H] (H above the
    kernel's limit): pre1 (y2 - 2 s.Wty + s^T G s) + pil_bar |s|, evo_tpu's
    ``BSC._lpj_one`` (evo_tpu/models/bsc.py:222-229).  Plain PyTorch on
    every device, as in evo_tpu, which runs both cases on XLA."""
    sf = ss.to(Wty.dtype)
    sGs = ((sf @ G) * sf).sum(dim=-1)
    sWty = (sf @ Wty[:, :, None])[..., 0]
    return pre1 * (y2[:, None] - 2.0 * sWty + sGs) + pil_bar * sf.sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class BSC:
    """Static model configuration.  ``device`` None means the CUDA card."""

    D: int
    H: int
    to_learn: Tuple[str, ...] = ("W", "pi", "sigma")
    device: torch.device = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def wide(self) -> bool:
        """Whether H is above the ``bsc_lpj`` kernel's limit, so that the
        lpj takes ``lpj_gram`` on complete data too."""
        return self.H > bsc_lpj_ops.MAX_H

    # ------------------------------------------------------------------ init

    def standard_init(self, data: Data, seed: int = 0, y_host=None) -> BSCParams:
        """Noisy-data-mean init with pi = 1/H (reference _models.py:206-283),
        drawn with NumPy from ``seed`` exactly as evo_tpu draws it.  Pass
        ``y_host`` (the flat [N, D] host data, NaN marking missing entries)
        to skip the device-to-host copy (this rank's rows under a process
        group).  On incomplete data the mean is normalized by N and sigma
        taken over the observed entries (evo_tpu bsc.py:125-135).  Under a
        group of several ranks the statistics are summed over the ranks
        (``global_init_stats``), so that every rank draws the same Theta^0."""
        if distributed.rank_world()[1] > 1:
            # Theta^0 from global sums, the same on every rank (evo_tpu
            # bsc.py:98-107): sigma = sqrt(ss_resid / m_sum)
            _, y_mean, ss_resid, m_sum = distributed.global_init_stats(data, y_host, self.D)
            sigma = np.sqrt(ss_resid / m_sum)
        else:
            y, m = host_data(data, self.D, y_host)
            N = y.shape[0]
            if data.incomplete:
                y_mean = (y * m).sum(0) / N
                sigma = np.sqrt((((y - y_mean) * m) ** 2).sum() / m.sum())
            else:
                y_mean = y.mean(0)
                sigma = np.sqrt(((y - y_mean) ** 2).mean(0).sum() / self.D)
        if not sigma > 0.0:
            raise ValueError("the data have zero variance")
        W = y_mean[:, None] + np.random.default_rng(seed).normal(
            scale=sigma / 4.0, size=(self.D, self.H))
        pi = 1.0 / self.H
        dt, dev = data.y.dtype, self.device
        return BSCParams(
            W=torch.as_tensor(np.asarray(W), dtype=dt, device=dev),
            pi=torch.as_tensor(pi, dtype=dt, device=dev),
            sigma=torch.as_tensor(sigma, dtype=dt, device=dev),
            pies=torch.full((self.H,), pi, dtype=dt, device=dev),
        )

    # ----------------------------------------------------------- check/clamp

    def check_params(self, p: BSCParams) -> BSCParams:
        """Clamp to the reference noise policy: pi in [tol, 1-tol],
        sigma >= tol, W unbounded."""
        return BSCParams(
            W=p.W,
            pi=torch.clamp(p.pi, PARAM_TOL, 1.0 - PARAM_TOL),
            sigma=torch.clamp(p.sigma, min=PARAM_TOL),
            pies=torch.clamp(p.pies, PARAM_TOL, 1.0 - PARAM_TOL),
        )

    # ------------------------------------------------------------ generation

    def generate_from_hidden(self, params: BSCParams, s: torch.Tensor,
                             generator: torch.Generator) -> dict:
        """y = W s + sigma * noise for given states s [N, H]."""
        dt = params.W.dtype
        y_mean = s.to(dt) @ params.W.T
        noise = torch.randn(y_mean.shape, generator=generator, device=params.W.device, dtype=dt)
        return {"y": y_mean + params.sigma * noise, "s": s, "y_mean": y_mean}

    def generate_data(self, params: BSCParams, N: int,
                      generator: torch.Generator) -> dict:
        """s_h ~ Bernoulli(pi) (as p <= pi), then generate_from_hidden."""
        p = torch.rand((N, self.H), generator=generator, device=params.W.device)
        return self.generate_from_hidden(params, p <= params.pi, generator)

    # ------------------------------------------------------------ precompute

    # the data sums of _precompute that an epoch sums over the ranks
    DATA_SUMS = ("N", "sum_d", "sum_d_y2")

    def _data_sums(self, data: Data, dt) -> dict:
        """This rank's valid rows N, entries sum_d and sum of squares
        sum_d_y2 (on incomplete data of the observed entries)."""
        N = data.row_valid.sum().to(dt)
        vmask = data.row_valid[..., None].to(dt)
        y2 = data.y * data.y * vmask
        if data.incomplete:
            m = data.x_infr.to(dt)
            return dict(N=N, sum_d=(m * vmask).sum(), sum_d_y2=(y2 * m).sum())
        return dict(N=N, sum_d=N * self.D, sum_d_y2=y2.sum())

    def _precompute(self, p: BSCParams, data: Data, sums: dict = None) -> dict:
        """State-independent terms (reference bsc.py:100-125); on incomplete
        data ljc, sum_d and sum_d_y2 count the observed entries (evo_tpu
        bsc.py:205-219).  ``sums`` (``DATA_SUMS`` over every rank) replaces
        this rank's."""
        c = sums or self._data_sums(data, p.W.dtype)
        log2pis = torch.log(2 * math.pi * p.sigma * p.sigma)
        if data.incomplete:
            ljc = self.H * torch.log(1.0 - p.pi) - log2pis * c["sum_d"] / c["N"] / 2
        else:
            ljc = self.H * torch.log(1.0 - p.pi) - self.D / 2 * log2pis
        return dict(pre1=-0.5 / (p.sigma * p.sigma), pil_bar=torch.log(p.pi / (1.0 - p.pi)),
                    piH=p.pi * self.H, ljc=ljc, **c)

    # ---------------------------------------------------------------- E-step
    #
    # A block's work is four phases, each a function of the namespace ``io``
    # (the block's inputs, Theta and the precomputed scalars it reads, the
    # outputs it writes for the next phase) and, in the last, of the epoch's
    # accumulators ``acc``.  They run eagerly, or as replays of their
    # captured CUDA graphs (``block_graphs``), under the same spans.

    def _lpj(self, io, cfg: EAConfig, states):
        """(lpj [B, K], dedup keys [B, K, W] or None, reset counts [3]) of
        states [B, K, ...] like the block's, under its Gram.  A
        per-datapoint Gram G [B, H, H] (incomplete data) and a wide model
        take ``lpj_gram``; the EA computes its own dedup keys then and on
        packed states (the kernel's keys are those of unpacked states)."""
        if io.G.dim() == 3 or self.wide():
            if cfg.packed_states:
                states = unpack_bits_lane(states, self.H).to(torch.int8)
            lpj, keys = lpj_gram(states, io.Wty, io.y2, io.G, io.pre1, io.pil_bar), None
        elif cfg.exact or cfg.packed_states:
            lpj, keys = bsc_lpj(states, io.Wty, io.y2, io.G, io.pre1, io.pil_bar), None
        else:
            lpj, keys = bsc_lpj(states, io.Wty, io.y2, io.G, io.pre1, io.pil_bar,
                                emit_keys=True)
        lpj, counts = reset_lpj(lpj, valid=io.valid)
        return lpj, keys, torch.stack(counts)

    def _lpj_phase(self, io, cfg: EAConfig):
        """``block_gram`` and the lpj of the current K^(n); in exact mode
        also the E-step's results (K^(n) kept, nothing new)."""
        io.G, io.Wty, io.y2 = block_gram(io.W, io.y, io.x_infr, io.incomplete)
        io.lpj_K, io.keys_K, io.counts = self._lpj(io, cfg, io.ss)
        if cfg.exact:
            zeros = torch.zeros(io.ss.shape[0], dtype=torch.int64, device=io.ss.device)
            io.ss2, io.lpj2, io.n_uni, io.n_sub = io.ss, io.lpj_K, zeros, zeros

    def _ea_phase(self, io, cfg: EAConfig, generator, rows):
        """Children by ``evolve_states_block``, their lpj (eagerly an
        ``em_step.lpj`` span nested in the EA's).  ``rows``
        (``distributed.block_rows``) makes the EA draw the global block's
        random numbers and keep this rank's rows."""
        def lpj_block(states):
            with tracing.span("em_step.lpj", io.dev):
                return self._lpj(io, cfg, states)

        io.children, io.child_lpj, io.new_unique, io.child_lpj_raw, aux = evolve_states_block(
            io.ss, io.lpj_K, lpj_block, cfg, io.piH, generator, ss_dkeys=io.keys_K, rows=rows)
        io.counts = io.counts + sum(aux)

    def _merge_phase(self, io, cfg: EAConfig):
        """The merge ``cfg`` asks for: the new K^(n) and its lpj, and the
        counters n_uni [B], n_sub [B]."""
        io.ss2, io.lpj2, io.n_uni, io.n_sub, _ = merge_states(
            cfg, io.ss, io.lpj_K, io.children, io.child_lpj, io.new_unique, io.child_lpj_raw)

    def _suffstat_phase(self, io, acc, cfg: EAConfig):
        """F, responsibilities, ``bsc_suffstat``, the reconstruction into
        ``io.y_rec`` (unless None) and the M-step sums into ``acc``; the
        stored lpj (the all-zero state's first with ``allzero``) is
        ``io.lpj_full``."""
        S_perm, W = cfg.S_perm, io.W
        dt = W.dtype
        y_b, valid_b, ss2, lpj2 = io.y, io.valid, io.ss2, io.lpj2
        lpj_full = torch.cat([io.pre1 * io.y2[:, None], lpj2], 1) if S_perm else lpj2
        vf = valid_b.to(dt)
        acc.Fsum += (shifted_logsumexp(lpj_full) * vf).sum()
        r = posterior_weights(lpj_full) * vf[:, None]
        rs = r[:, S_perm:].contiguous()
        rho, s_abs, Wq_b = bsc_suffstat(ss2, rs, H=self.H)
        acc.Wq += Wq_b
        acc.pies += rho.sum(dim=0)
        if io.y_rec is not None:
            # posterior-predictive mean (reference _models.py:614-665)
            sf = unpack_bits_lane(ss2, self.H) if cfg.packed_states else ss2
            means = sf.to(dt) @ W.T  # [B, S, D]
            io.y_rec.copy_(torch.where(io.x, y_b, (rs[:, None, :] @ means)[:, 0]))
        if io.incomplete:
            # sum_s r ||m (y_rec - W s)||^2 from the reconstruction
            y_rec, m = io.y_rec, io.x_infr
            dy = (y_rec[:, None, :] - means) * m[:, None, :]
            acc.sig += (rs * (dy * dy).sum(dim=-1)).sum()
            if S_perm:
                acc.sig += (r[:, 0] * (y_rec * y_rec * m).sum(dim=-1)).sum()
            acc.Wp += rho.T @ y_rec
        else:
            # sum_s r ||y - W s||^2 recovered from the lpj; reset-clamped
            # values would poison it, so they are masked out (their
            # responsibility is ~0 anyway)
            resid2 = torch.clamp((lpj2 - io.pil_bar * s_abs) / io.pre1, min=0.0)
            acc.sig += torch.where(lpj2 > 0.5 * eps_lpj(dt), rs * resid2, 0.0).sum()
            if S_perm:
                acc.sig += (r[:, 0] * io.y2).sum()
            acc.Wp += rho.T @ y_b
        acc.nuni += (io.n_uni * valid_b).sum()
        acc.nsub += (io.n_sub * valid_b).sum()
        acc.resets += io.counts
        io.lpj_full = lpj_full

    def _phases(self, io, acc, cfg: EAConfig, generator, rows):
        """[(span name, phase of no argument)] of a block; exact mode has no
        EA and no merge."""
        phases = [("em_step.lpj", lambda: self._lpj_phase(io, cfg))]
        if not cfg.exact:
            phases += [("em_step.ea", lambda: self._ea_phase(io, cfg, generator, rows)),
                       ("em_step.merge", lambda: self._merge_phase(io, cfg))]
        phases.append(("em_step.suffstat", lambda: self._suffstat_phase(io, acc, cfg)))
        return phases

    def _accumulators(self, dt, dev) -> SimpleNamespace:
        def zeros(shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return SimpleNamespace(
            Wp=zeros((self.H, self.D)), Wq=zeros((self.H, self.H)), pies=zeros((self.H,)),
            sig=zeros(()), Fsum=zeros(()), nuni=zeros((), torch.int64),
            nsub=zeros((), torch.int64), resets=zeros((3,), torch.int64))

    def _block_graphs(self, estate: EState, data: Data, cfg: EAConfig, rows, dt, dev):
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
            W=torch.empty((D, self.H), dtype=dt, device=dev),
            pre1=torch.empty((), dtype=dt, device=dev),
            pil_bar=torch.empty((), dtype=dt, device=dev),
            piH=torch.empty((), dtype=dt, device=dev))
        graphs = block_graphs.PhaseGraphs(key, dev, io, self._accumulators(dt, dev),
                                          LAUNCH_COUNTERS)
        object.__setattr__(self, "_graphs", graphs)
        return graphs

    @staticmethod
    def _load_block(io, i, data: Data, estate: EState, y_rec_all, static: bool):
        """Block ``i``'s inputs into ``io``: as views, or (``static``)
        copied into its static buffers."""
        if static:
            io.y.copy_(data.y[i])
            io.valid.copy_(data.row_valid[i])
            io.ss.copy_(estate.ss[i])
            return
        io.y, io.valid, io.ss = data.y[i], data.row_valid[i], estate.ss[i]
        io.x, io.x_infr = data.x[i], data.x_infr[i]
        io.y_rec = None if y_rec_all is None else y_rec_all[i]

    def _run_block(self, i, phases, io, data, estate, ss_all, lpj_all, y_rec_all, graphs):
        """Block ``i``'s phases under their spans, eagerly or (``graphs``
        captured) as replays; its states and their lpj go into
        ``ss_all[i]`` and ``lpj_all[i]``."""
        replay = graphs is not None and graphs.captured
        for k, (name, phase) in enumerate(phases):
            with tracing.span(name, io.dev):
                if k == 0:
                    self._load_block(io, i, data, estate, y_rec_all, graphs is not None)
                if replay:
                    graphs.replay(k)
                else:
                    phase()
                if k == len(phases) - 1:
                    ss_all[i] = io.ss2
                    lpj_all[i] = io.lpj_full

    # ---------------------------------------------------------------- epoch

    def em_step(self, params: BSCParams, estate: EState, data: Data,
                generator: torch.Generator, cfg: EAConfig,
                do_reconstruction: bool = False):
        """One EM epoch: E-step, optional reconstruction and M-step over all
        blocks.

        Returns (new_params, new_estate, stats, y_rec [nb, B, D] or None).
        As in evo_tpu, F is the free energy of the updated K^(n) under the
        old parameters, and the M-step consumes the merged states and lpjs.
        On incomplete data the W update reads the reconstruction and the
        sigma residual is taken from it over x_infr, exactly as the
        reference does (evo_tpu bsc.py:425-452), also where x != x_infr.
        With ``allzero`` the lpj of the permanent all-zero state, pre1 y2,
        comes first in the stored lpj and its responsibility adds its
        residual to the sigma sum (evo_tpu bsc.py:305-309, 437-452).
        ``generator`` (on the data's device) drives every random draw of
        the EA; under a process group every rank passes the same one.
        There the statistics, counters and F are summed over the ranks in
        one all_reduce after the blocks; without a group nothing is issued.

        Where ``block_graphs.engages`` (a CUDA device, complete data, the
        lpj kernel's widths, an EA epoch without reconstruction) the blocks
        replay CUDA graphs of their phases, captured in the first such
        epoch and kept on the model for these shapes, dtypes, ``cfg`` and
        ranks: the same ops in the same order, with the same draws.  The
        counters ``em_step.blocks``, ``em_step.graph_blocks`` (blocks
        replayed) and ``em_step.graph_captures`` go to the innermost open
        tracing span."""
        check_em_step(data, do_reconstruction)
        params = self.check_params(params)
        pre = self._precompute(params, data)
        rows = distributed.block_rows(data.y.shape[1])
        dt, dev = params.W.dtype, params.W.device
        graphs = None
        if block_graphs.engages(dev, data.incomplete, self.H, cfg.exact, do_reconstruction):
            graphs = self._block_graphs(estate, data, cfg, rows, dt, dev)
            io = graphs.io
            io.W.copy_(params.W)
            for name in ("pre1", "pil_bar", "piH"):
                getattr(io, name).copy_(pre[name])
            acc, gen = graphs.acc, graphs.begin_epoch(generator)
        else:
            # the graphs read W from a contiguous copy; cuBLAS may sum otherwise
            # in the transposed layout that the M-step returns
            io = SimpleNamespace(dev=dev, incomplete=data.incomplete, W=params.W.contiguous(),
                                 pre1=pre["pre1"], pil_bar=pre["pil_bar"], piH=pre["piH"])
            acc, gen = self._accumulators(dt, dev), generator
        ss_all = torch.empty_like(estate.ss)
        lpj_all = torch.empty_like(estate.lpj)
        y_rec_all = torch.empty_like(data.y) if do_reconstruction else None
        phases = self._phases(io, acc, cfg, gen, rows)
        replayed = captures = 0
        for i in range(data.n_blocks):
            args = (i, phases, io, data, estate, ss_all, lpj_all, y_rec_all, graphs)
            if graphs is None:
                self._run_block(*args)
            elif graphs.captured:
                self._run_block(*args)
                replayed += 1
            else:  # block 0 of the first graphed epoch: the warm-up, then the capture
                graphs.warm_up(lambda: self._run_block(*args))
                graphs.capture([phase for _, phase in phases])
                captures += 1
        if graphs is not None:
            acc = graphs.end_epoch()
        tracing.count("em_step.blocks", data.n_blocks)
        if replayed:
            tracing.count("em_step.graph_blocks", replayed)
        if captures:
            tracing.count("em_step.graph_captures", captures)

        with tracing.span("em_step.mstep", dev):
            sums = dict(Wp=acc.Wp, Wq=acc.Wq, pies=acc.pies, sigma=acc.sig)
            pre, sums, tot = sum_over_ranks(
                self, params, data, pre, sums,
                dict(Fsum=acc.Fsum, nuni=acc.nuni, nsub=acc.nsub, resets=acc.resets))
            new_params, guard = self._m_step_finalize(params, sums, pre, data.incomplete, cfg)
            N, resets = pre["N"], tot["resets"]
            stats = StepStats(
                F=pre["ljc"] + tot["Fsum"] / N, S_nunique=tot["nuni"] / N, S_sub=tot["nsub"] / N,
                n_reset_nan=resets[0], n_reset_small=resets[1], n_reset_inf=resets[2],
                n_guard_sigma_floor=guard, n_guard_mus_freeze=torch.zeros_like(guard),
                n_guard_psi_freeze=torch.zeros_like(guard),
                guard_psi_renorm=torch.zeros((), dtype=torch.float32, device=dev))
        return new_params, EState(ss=ss_all, lpj=lpj_all), stats, y_rec_all

    # ---------------------------------------------------------------- M-step

    def _m_step_finalize(self, params: BSCParams, acc: dict, pre: dict, incomplete: bool,
                         cfg: EAConfig):
        """Closed-form updates from the epoch's accumulators (reference
        bsc.py:225-277) with evo_tpu's guards: an equilibrated PD solve with
        a relative ridge in f32 for W, and a floor on sigma at 1e-3 of the
        data RMS.  On incomplete data the sigma update adds sum_d times the
        old sigma^2 (evo_tpu bsc.py:530-532).  With ``background`` the last
        unit's pi is 1 - 1.1e-5 (bsc.py:523-524).  Returns (params,
        sigma-floor flag)."""
        N, D, H = pre["N"], self.D, self.H
        new = dict(W=params.W, pi=params.pi, sigma=params.sigma, pies=params.pies)
        if "W" in self.to_learn:
            ridge = 0.0 if params.W.dtype == torch.float64 else 1e-6
            new["W"] = (equilibrated_pd_inverse(acc["Wq"], rel_ridge=ridge) @ acc["Wp"]).T
        if "pi" in self.to_learn:
            new["pies"] = acc["pies"] / N
            if cfg.background:
                new["pies"][-1] = 1.0 - 1.1e-5
            new["pi"] = new["pies"].sum() / H
        guard = torch.zeros((), dtype=torch.int64, device=params.W.device)
        if "sigma" in self.to_learn:
            corr = pre["sum_d"] * params.sigma**2 if incomplete else 0.0
            sigma_new = torch.sqrt((acc["sigma"] + corr) / N / D)
            floor = 1e-3 * torch.sqrt(pre["sum_d_y2"] / torch.clamp(pre["sum_d"], min=1.0))
            new["sigma"] = torch.maximum(sigma_new, floor)
            guard = (sigma_new < floor).to(torch.int64)
        return BSCParams(**new), guard

    # ----------------------------------------------------------- free energy

    def exact_free_energy(self, params: BSCParams, data: Data) -> torch.Tensor:
        """Exact log-likelihood by enumerating all 2^H states (small H): the
        correctness oracle (over every rank under a process group)."""
        params = self.check_params(params)
        pre = self._precompute(params, data)
        sm = torch.from_numpy(full_state_matrix(self.H).view(np.int8)).to(params.W.device)
        Fsum = torch.zeros((), dtype=params.W.dtype, device=params.W.device)
        for i in range(data.n_blocks):
            y_b = data.y[i]
            G_b, Wty_b, y2_b = block_gram(params.W, y_b, data.x_infr[i], data.incomplete)
            states = sm.expand(y_b.shape[0], -1, -1).contiguous()
            lpj_fn = lpj_gram if data.incomplete or self.wide() else bsc_lpj
            lpj, _ = reset_lpj(lpj_fn(states, Wty_b, y2_b, G_b, pre["pre1"], pre["pil_bar"]))
            Fsum += (shifted_logsumexp(lpj) * data.row_valid[i].to(lpj.dtype)).sum()
        return total_free_energy(self, params, data, pre, Fsum)

    def free_energy(self, params: BSCParams, estate: EState, data: Data) -> torch.Tensor:
        """Truncated free energy from the stored lpj (over every rank under
        a process group)."""
        params = self.check_params(params)
        pre = self._precompute(params, data)
        lpj = estate.lpj.reshape(-1, estate.lpj.shape[-1])
        Fsum = (shifted_logsumexp(lpj) * data.row_valid.reshape(-1).to(lpj.dtype)).sum()
        return total_free_energy(self, params, data, pre, Fsum)
