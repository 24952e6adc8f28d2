"""Binary Sparse Coding trained with evolutionary E-steps (EBSC).

Counterpart: evo_tpu/models/bsc.py.  Generative model:

    s_h ~ Bernoulli(pi),  y = W s + N(0, sigma^2 I),  W in R^{D x H}

The lpj of a state is evaluated in Gram form, pre1 (y2 - 2 s.Wty + s^T G s)
+ pil_bar |s| with G = W^T W, Wty = W^T y, y2 = ||y||^2 precomputed once
per block, so that a state costs O(H^2) independent of D.

An epoch (``em_step``) is the runner that ``BSC`` shares with ``SSSC``
(``models/epoch.py``: the block loop, the phases' spans, the CUDA graphs).
This model supplies the math: the lpj through the ``bsc_lpj`` kernel
(which also emits the dedup keys), the merged states' statistics through
the ``bsc_suffstat`` kernel (``_suffstat_phase``) and the M-step; the rest
is plain PyTorch on the same device.  With ``allzero`` the lpj of the
permanent all-zero state, pre1 y2, comes first in the stored lpj and its
responsibility adds its residual to the sigma sum (evo_tpu
bsc.py:305-309, 437-452).  At the lpj kernel's widths (``_graphable``)
the blocks may replay CUDA graphs, which read W, pre1, pil_bar and piH
from static copies (``_theta``).

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
There the build of G_n is the span ``bsc.gram`` (``_gram``) and each lpj
under it the span ``bsc.masked_lpj`` (``_masked_lpj``), with counters of
the rows, states and entries they read; neither opens on complete data.

Widths: the ``bsc_lpj`` kernel covers H <= ``ops.bsc_lpj.MAX_H`` (1024).
Wider models take evo_tpu's XLA form of the lpj, ``BSC._lpj_one``
(evo_tpu/models/bsc.py:222-229), which is ``lpj_gram`` under the shared
G, on every device; the EA then keys the states itself, as on incomplete
data, and packed states are unpacked for this lpj only.  The path is chosen
from H alone (``BSC.wide``, the limit read when the model is called),
before anything is launched; ``bsc_suffstat`` (H <= 65,535) stays the
kernel.

The reconstruction y_rec = where(x, y, sum_s r W s) is returned blocked
[nb, B, D]; on incomplete data it feeds the W update, and the sigma
residual is taken from it over x_infr, exactly as the reference does
(evo_tpu bsc.py:425-452), also where x != x_infr.

Under a process group (``evo_tpu_torch.parallel``) the data, states and
reconstruction hold this rank's rows; Theta^0 comes from global sums, and
an epoch sums its accumulators, counters and F over the ranks in one
all_reduce before the M-step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from evo_tpu_torch._device import resolve_device
from evo_tpu_torch.models.base import Data, host_data
from evo_tpu_torch.models.epoch import EMModel
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

PARAM_TOL = 1e-5  # reference noise_policy bounds (_models.py:47-52)


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
class BSC(EMModel):
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

    def _graphable(self, data: Data) -> bool:
        """Whether the blocks may replay CUDA graphs: at the lpj kernel's
        widths."""
        return not self.wide()

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
    # The math of the runner's phases (``models/epoch.py``).

    # the kernels' launch counters, which a replayed block advances as an eager one does
    LAUNCH_COUNTERS = EMModel.LAUNCH_COUNTERS + (
        (bsc_lpj, "launches"), (bsc_lpj, "packed_launches"),
        (bsc_suffstat, "launches"), (bsc_suffstat, "packed_launches"))

    @staticmethod
    def _theta(params: BSCParams, pre: dict) -> dict:
        return dict(W=params.W, pre1=pre["pre1"], pil_bar=pre["pil_bar"], piH=pre["piH"])

    def _gram(self, io):
        """``block_gram``; on incomplete data, where it builds each
        datapoint's G_n, it is the span ``bsc.gram``, nested in
        ``em_step.lpj``, with the counters ``bsc.gram_rows`` (the block's
        datapoints, B) and ``bsc.gram_cells`` (the data entries read, B D),
        from host shapes."""
        if not io.incomplete:
            return super()._gram(io)
        B, D = io.y.shape
        with tracing.span("bsc.gram", io.dev):
            tracing.count("bsc.gram_rows", B)
            tracing.count("bsc.gram_cells", B * D)
            return super()._gram(io)

    def _masked_lpj(self, io, cfg: EAConfig, states):
        """``lpj_gram`` of states [B, K, ...] under per-datapoint Grams: the
        span ``bsc.masked_lpj`` (in the ``em_step.lpj`` of K^(n) or of the
        children), with the counters ``bsc.masked_lpj_rows`` (B),
        ``.masked_lpj_states`` (B K), ``.masked_lpj_cells`` (the data
        entries the states are judged on, B D) and ``.masked_lpj_units``
        (the state entries read, B K H), from host shapes."""
        B, K = states.shape[:2]
        with tracing.span("bsc.masked_lpj", states.device):
            tracing.count("bsc.masked_lpj_rows", B)
            tracing.count("bsc.masked_lpj_states", B * K)
            tracing.count("bsc.masked_lpj_cells", B * self.D)
            tracing.count("bsc.masked_lpj_units", B * K * self.H)
            return self._gram_lpj(io, cfg, states)

    def _gram_lpj(self, io, cfg: EAConfig, states):
        """``lpj_gram`` of states [B, K, ...] under the block's Gram, packed
        states unpacked first."""
        if cfg.packed_states:
            states = unpack_bits_lane(states, self.H).to(torch.int8)
        return lpj_gram(states, io.Wty, io.y2, io.G, io.pre1, io.pil_bar)

    def _lpj(self, io, cfg: EAConfig, states):
        """(lpj [B, K], dedup keys [B, K, W] or None, reset counts [3]) of
        states [B, K, ...] like the block's, under its Gram.  A
        per-datapoint Gram G [B, H, H] (incomplete data, ``_masked_lpj``)
        and a wide model take ``lpj_gram``; the EA computes its own dedup
        keys then and on packed states (the kernel's keys are those of
        unpacked states)."""
        if io.G.dim() == 3:
            lpj, keys = self._masked_lpj(io, cfg, states), None
        elif self.wide():
            lpj, keys = self._gram_lpj(io, cfg, states), None
        elif cfg.exact or cfg.packed_states:
            lpj, keys = bsc_lpj(states, io.Wty, io.y2, io.G, io.pre1, io.pil_bar), None
        else:
            lpj, keys = bsc_lpj(states, io.Wty, io.y2, io.G, io.pre1, io.pil_bar,
                                emit_keys=True)
        lpj, counts = reset_lpj(lpj, valid=io.valid)
        return lpj, keys, torch.stack(counts)

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
        io.lpj_full = lpj_full

    def _sum_shapes(self) -> dict:
        return dict(Wp=(self.H, self.D), Wq=(self.H, self.H), pies=(self.H,), sig=())

    # ---------------------------------------------------------------- M-step

    def _m_step_finalize(self, params: BSCParams, acc: dict, pre: dict, incomplete: bool,
                         cfg: EAConfig):
        """Closed-form updates from the epoch's accumulators (reference
        bsc.py:225-277) with evo_tpu's guards: an equilibrated PD solve with
        a relative ridge in f32 for W, and a floor on sigma at 1e-3 of the
        data RMS.  On incomplete data the sigma update adds sum_d times the
        old sigma^2 (evo_tpu bsc.py:530-532).  With ``background`` the last
        unit's pi is 1 - 1.1e-5 (bsc.py:523-524).  Returns (params, the
        guard fields of StepStats it sets: the sigma-floor flag)."""
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
        guards = {}
        if "sigma" in self.to_learn:
            corr = pre["sum_d"] * params.sigma**2 if incomplete else 0.0
            sigma_new = torch.sqrt((acc["sig"] + corr) / N / D)
            floor = 1e-3 * torch.sqrt(pre["sum_d_y2"] / torch.clamp(pre["sum_d"], min=1.0))
            new["sigma"] = torch.maximum(sigma_new, floor)
            guards["n_guard_sigma_floor"] = (sigma_new < floor).to(torch.int64)
        return BSCParams(**new), guards
