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
plain PyTorch on the same device.

With ``EAConfig.packed_states`` the state sets stay lane-major bit-packed
through the whole epoch, at every H (evo_tpu needs H % 32 == 0 for this on
the TPU and otherwise unpacks each block; the results are the same): both
kernels read the packed states, the EA keys them from their bytes and
unpacks only the parents, the merge moves packed rows, and only the
reconstruction and the incomplete-data lpj unpack what they read.  The
permanent states (``allzero``, ``background``) and the merges other than
the sorted unification merge (``swap_merge``, ``unification=False``) run
as in evo_tpu.

Incomplete data (NaN entries in ``make_data``) need
``do_reconstruction=True``, as in evo_tpu.  Their lpj runs under the
per-datapoint Gram G_n = W^T diag(m_n) W and is plain PyTorch on every
device (``lpj_masked_gram``): evo_tpu has no TPU kernel for it either
(``pallas_lpj_applicable`` is False for incomplete data), so nothing falls
back here.  ``bsc_suffstat`` does not read the mask and stays the kernel.
The reconstruction y_rec = where(x, y, sum_s r W s) is returned blocked
[nb, B, D]; on incomplete data it feeds the W update and the sigma residual.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from evo_tpu_torch._device import resolve_device
from evo_tpu_torch.models.base import (
    Data,
    StepStats,
    block_gram,
    check_em_step,
    check_single_process,
    host_data,
)
from evo_tpu_torch.ops.bitpack import unpack_bits_lane
from evo_tpu_torch.ops.bsc_lpj import bsc_lpj
from evo_tpu_torch.ops.bsc_suffstat import bsc_suffstat
from evo_tpu_torch.ops.linalg import equilibrated_pd_inverse
from evo_tpu_torch.ops.numerics import (
    eps_lpj,
    free_energy_from_lpj,
    posterior_weights,
    reset_lpj,
    shifted_logsumexp,
)
from evo_tpu_torch.variational.config import EAConfig
from evo_tpu_torch.variational.evolve import evolve_states_block
from evo_tpu_torch.variational.state_init import EState, full_state_matrix
from evo_tpu_torch.variational.varykn import merge_states

PARAM_TOL = 1e-5  # reference noise_policy bounds (_models.py:47-52)


@dataclasses.dataclass
class BSCParams:
    W: torch.Tensor  # [D, H]
    pi: torch.Tensor  # scalar
    sigma: torch.Tensor  # scalar
    pies: torch.Tensor  # [H], per-unit pi_h, diagnostic only


def lpj_masked_gram(ss, Wty, y2, G, pre1, pil_bar):
    """lpj [B, K] of states ss [B, K, H] under per-datapoint Grams G
    [B, H, H] (incomplete data): pre1 (y2 - 2 s.Wty + s^T G_n s) + pil_bar
    |s|, the per-datapoint form of evo_tpu's ``BSC._lpj_one``
    (evo_tpu/models/bsc.py:222-229).  Plain PyTorch on every device, as in
    evo_tpu, which has no TPU kernel for incomplete data."""
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

    # ------------------------------------------------------------------ init

    def standard_init(self, data: Data, seed: int = 0, y_host=None) -> BSCParams:
        """Noisy-data-mean init with pi = 1/H (reference _models.py:206-283),
        drawn with NumPy from ``seed`` exactly as evo_tpu draws it.  Pass
        ``y_host`` (the flat [N, D] host data, NaN marking missing entries)
        to skip the device-to-host copy.  On incomplete data the mean is
        normalized by N and sigma taken over the observed entries (evo_tpu
        bsc.py:125-135)."""
        check_single_process()
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

    def generate_data(self, params: BSCParams, N: int,
                      generator: torch.Generator) -> dict:
        """s_h ~ Bernoulli(pi) (as p <= pi), y = W s + sigma * noise."""
        dev, dt = params.W.device, params.W.dtype
        s = torch.rand((N, self.H), generator=generator, device=dev) <= params.pi
        y_mean = s.to(dt) @ params.W.T
        noise = torch.randn(y_mean.shape, generator=generator, device=dev, dtype=dt)
        return {"y": y_mean + params.sigma * noise, "s": s, "y_mean": y_mean}

    # ------------------------------------------------------------ precompute

    def _precompute(self, p: BSCParams, data: Data) -> dict:
        """State-independent terms (reference bsc.py:100-125); on incomplete
        data ljc, sum_d and sum_d_y2 count the observed entries (evo_tpu
        bsc.py:205-219)."""
        dt = p.W.dtype
        N = data.row_valid.sum().to(dt)
        log2pis = torch.log(2 * math.pi * p.sigma * p.sigma)
        vmask = data.row_valid[..., None].to(dt)
        y2 = data.y * data.y * vmask
        if data.incomplete:
            m = data.x_infr.to(dt)
            sum_d = (m * vmask).sum()
            ljc = self.H * torch.log(1.0 - p.pi) - log2pis * sum_d / N / 2
            y2 = y2 * m
        else:
            sum_d = N * self.D
            ljc = self.H * torch.log(1.0 - p.pi) - self.D / 2 * log2pis
        return dict(pre1=-0.5 / (p.sigma * p.sigma), pil_bar=torch.log(p.pi / (1.0 - p.pi)),
                    piH=p.pi * self.H, ljc=ljc, N=N, sum_d=sum_d, sum_d_y2=y2.sum())

    # ---------------------------------------------------------------- E-step

    def _estep_block(self, generator, ss_b, G_b, Wty_b, y2_b, valid_b, pre,
                     cfg: EAConfig):
        """Evolutionary E-step of one block [B, ...]: lpj of the current
        K^(n), children by ``evolve_states_block``, the merge ``cfg`` asks
        for.  A per-datapoint Gram G_b [B, H, H] (incomplete data) takes
        ``lpj_masked_gram``; the EA computes its own dedup keys then and on
        packed states (the kernel's keys are those of unpacked states).
        Returns (ss2, lpj2, n_uni [B], n_sub [B], reset counts [3])."""
        args = (Wty_b, y2_b, G_b, pre["pre1"], pre["pil_bar"])
        packed = cfg.packed_states

        def lpj_block(states):
            if G_b.dim() == 3:
                if packed:
                    states = unpack_bits_lane(states, self.H).to(torch.int8)
                lpj, keys = lpj_masked_gram(states, *args), None
            elif cfg.exact or packed:
                lpj, keys = bsc_lpj(states, *args), None
            else:
                lpj, keys = bsc_lpj(states, *args, emit_keys=True)
            lpj, counts = reset_lpj(lpj, valid=valid_b)
            return lpj, keys, torch.stack(counts)

        lpj_K, ss_keys, counts = lpj_block(ss_b)
        if cfg.exact:
            zeros = torch.zeros(ss_b.shape[0], dtype=torch.int64, device=ss_b.device)
            return ss_b, lpj_K, zeros, zeros, counts
        children, child_lpj, new_unique, child_lpj_raw, aux = evolve_states_block(
            ss_b, lpj_K, lpj_block, cfg, pre["piH"], generator, ss_dkeys=ss_keys)
        ss2, lpj2, n_uni, n_sub, _ = merge_states(cfg, ss_b, lpj_K, children, child_lpj,
                                                  new_unique, child_lpj_raw)
        return ss2, lpj2, n_uni, n_sub, counts + sum(aux)

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
        the EA."""
        check_em_step(data, do_reconstruction)
        params = self.check_params(params)
        pre = self._precompute(params, data)
        dt, dev = params.W.dtype, params.W.device
        W = params.W
        Wp = torch.zeros((self.H, self.D), dtype=dt, device=dev)
        Wq = torch.zeros((self.H, self.H), dtype=dt, device=dev)
        pies = torch.zeros((self.H,), dtype=dt, device=dev)
        sig = torch.zeros((), dtype=dt, device=dev)
        Fsum = torch.zeros((), dtype=dt, device=dev)
        nuni = torch.zeros((), dtype=torch.int64, device=dev)
        nsub = torch.zeros((), dtype=torch.int64, device=dev)
        resets = torch.zeros((3,), dtype=torch.int64, device=dev)
        ss_all = torch.empty_like(estate.ss)
        lpj_all = torch.empty_like(estate.lpj)
        y_rec_all = torch.empty_like(data.y) if do_reconstruction else None
        floor = 0.5 * eps_lpj(dt)
        S_perm = cfg.S_perm

        for i in range(data.n_blocks):
            y_b, valid_b = data.y[i], data.row_valid[i]
            G_b, Wty_b, y2_b = block_gram(W, y_b, data.x_infr[i], data.incomplete)
            ss2, lpj2, n_uni, n_sub, counts = self._estep_block(
                generator, estate.ss[i], G_b, Wty_b, y2_b, valid_b, pre, cfg)
            lpj_full = torch.cat([pre["pre1"] * y2_b[:, None], lpj2], 1) if S_perm else lpj2
            vf = valid_b.to(dt)
            Fsum += (shifted_logsumexp(lpj_full) * vf).sum()
            r = posterior_weights(lpj_full) * vf[:, None]
            rs = r[:, S_perm:].contiguous()
            rho, s_abs, Wq_b = bsc_suffstat(ss2, rs, H=self.H)
            Wq += Wq_b
            pies += rho.sum(dim=0)
            if do_reconstruction:
                # posterior-predictive mean (reference _models.py:614-665)
                sf = unpack_bits_lane(ss2, self.H) if cfg.packed_states else ss2
                means = sf.to(dt) @ W.T  # [B, S, D]
                y_rec_all[i] = torch.where(data.x[i], y_b, (rs[:, None, :] @ means)[:, 0])
            if data.incomplete:
                # sum_s r ||m (y_rec - W s)||^2 from the reconstruction
                y_rec = y_rec_all[i]
                m = data.x_infr[i]
                dy = (y_rec[:, None, :] - means) * m[:, None, :]
                sig += (rs * (dy * dy).sum(dim=-1)).sum()
                if S_perm:
                    sig += (r[:, 0] * (y_rec * y_rec * m).sum(dim=-1)).sum()
                Wp += rho.T @ y_rec
            else:
                # sum_s r ||y - W s||^2 recovered from the lpj; reset-clamped
                # values would poison it, so they are masked out (their
                # responsibility is ~0 anyway)
                resid2 = torch.clamp((lpj2 - pre["pil_bar"] * s_abs) / pre["pre1"], min=0.0)
                sig += torch.where(lpj2 > floor, rs * resid2, 0.0).sum()
                if S_perm:
                    sig += (r[:, 0] * y2_b).sum()
                Wp += rho.T @ y_b
            nuni += (n_uni * valid_b).sum()
            nsub += (n_sub * valid_b).sum()
            resets += counts
            ss_all[i] = ss2
            lpj_all[i] = lpj_full

        acc = dict(Wp=Wp, Wq=Wq, pies=pies, sigma=sig)
        new_params, guard = self._m_step_finalize(params, acc, pre, data.incomplete, cfg)
        N = pre["N"]
        stats = StepStats(
            F=pre["ljc"] + Fsum / N, S_nunique=nuni / N, S_sub=nsub / N,
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
        correctness oracle."""
        params = self.check_params(params)
        pre = self._precompute(params, data)
        sm = torch.from_numpy(full_state_matrix(self.H).view(np.int8)).to(params.W.device)
        Fsum = torch.zeros((), dtype=params.W.dtype, device=params.W.device)
        for i in range(data.n_blocks):
            y_b = data.y[i]
            G_b, Wty_b, y2_b = block_gram(params.W, y_b, data.x_infr[i], data.incomplete)
            states = sm.expand(y_b.shape[0], -1, -1).contiguous()
            lpj_fn = lpj_masked_gram if data.incomplete else bsc_lpj
            lpj, _ = reset_lpj(lpj_fn(states, Wty_b, y2_b, G_b, pre["pre1"], pre["pil_bar"]))
            Fsum += (shifted_logsumexp(lpj) * data.row_valid[i].to(lpj.dtype)).sum()
        return pre["ljc"] + Fsum / pre["N"]

    def free_energy(self, params: BSCParams, estate: EState, data: Data) -> torch.Tensor:
        """Truncated free energy from the stored lpj."""
        pre = self._precompute(self.check_params(params), data)
        lpj = estate.lpj.reshape(-1, estate.lpj.shape[-1])
        return free_energy_from_lpj(lpj, pre["ljc"], data.row_valid.reshape(-1))
