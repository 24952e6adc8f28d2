"""Spike-and-Slab Sparse Coding trained with evolutionary E-steps (ES3C).

Counterpart: evo_tpu/models/sssc.py.  Generative model:

    s_h ~ Bernoulli(pies_h),  z ~ N(mus, Psi),  y = W (s * z) + N(0, sigma2 I)

The slab z is marginalized in closed form per binary state s (Sheikh et al.
2014): with G = W^T W, Wty = W^T y and y2 = ||y||^2 precomputed once per
block, every per-state quantity is an |s| x |s| solve, independent of D.

An epoch (``em_step``) is a Python loop over the data blocks.  In each
block the lpj of K^(n) and of each generation's children go through the
``sssc_lpj`` kernel, the merged states' sufficient statistics through the
``sssc_suffstat`` kernel (which solves the merged states again, as
evo_tpu's kernel path does), and the rest is plain PyTorch on the same
device.  evo_tpu's XLA path stashes the candidate solves instead
(``STASH_MAX_H``); that is an XLA strategy and is not carried over.

Incomplete data (NaN entries in ``make_data``) run under the per-datapoint
Gram G_n = W^T diag(m_n) W, built one block at a time, through the masked
kernels (``sssc_lpj_masked``, ``sssc_suffstat_masked``), and need
``do_reconstruction=True`` as in evo_tpu; the reconstruction
y_rec = where(x, y, <sz> W^T) is returned blocked [nb, B, D] and feeds the
W update.

With ``EAConfig.packed_states`` the state sets are stored lane-major
bit-packed; each block is unpacked to int8 at its start and the merged set
packed at its end, as in evo_tpu (evo_tpu/models/sssc.py:486-487, 597),
which routes packed ES3C to XLA; the port runs its kernels on the unpacked
block.  The permanent states (``allzero``, ``background``) and the merges
``swap_merge`` and ``unification=False`` run as in evo_tpu.

Envelope: H <= 128 on complete data and H <= 64 on incomplete data (the
kernels' envelope; evo_tpu runs wider models on its XLA path).  Wider
models and multi-process initialization raise NotImplementedError.
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
from evo_tpu_torch.ops.bitpack import pack_bits_lane, unpack_bits_lane
from evo_tpu_torch.ops.linalg import equilibrated_pd_inverse
from evo_tpu_torch.ops.numerics import (
    free_energy_from_lpj,
    posterior_weights,
    reset_lpj,
    shifted_logsumexp,
)
from evo_tpu_torch.ops.sssc_lpj import MASKED_MAX_H, MAX_H, sssc_lpj
from evo_tpu_torch.ops.sssc_suffstat import sssc_suffstat
from evo_tpu_torch.variational.config import EAConfig
from evo_tpu_torch.variational.evolve import evolve_states_block
from evo_tpu_torch.variational.state_init import EState, full_state_matrix
from evo_tpu_torch.variational.varykn import merge_states

PARAM_TOL = 1e-5  # reference noise_policy bounds (sssc.py:40,51-58)
EPS_PIES = 5e-5
EPS_PSI = 1e-5
EPS_SIGMA2 = 1e-5


@dataclasses.dataclass
class SSSCParams:
    W: torch.Tensor  # [D, H]
    pies: torch.Tensor  # [H]
    mus: torch.Tensor  # [H]
    Psi: torch.Tensor  # [H, H]
    sigma2: torch.Tensor  # scalar


@dataclasses.dataclass(frozen=True)
class SSSC:
    """Static model configuration.  ``device`` None means the CUDA card."""

    D: int
    H: int
    to_learn: Tuple[str, ...] = ("W", "pies", "mus", "sigma2", "Psi")
    device: torch.device = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def _check_width(self, data: Data):
        """The kernels' envelope: H <= 128, and H <= 64 on incomplete data
        (evo_tpu's masked kernels stop at Hp <= 64 and its XLA path runs
        wider models; the port has no such path yet)."""
        if self.H > MAX_H:
            raise NotImplementedError(
                f"H={self.H}: the port's SSSC kernels cover H <= {MAX_H}")
        if data.incomplete and self.H > MASKED_MAX_H:
            raise NotImplementedError(
                f"H={self.H}: the port's masked SSSC kernels (incomplete data) "
                f"cover H <= {MASKED_MAX_H}")

    # ------------------------------------------------------------------ init

    def standard_init(self, data: Data, seed: int = 0, y_host=None) -> SSSCParams:
        """Random-uniform pies, standard-normal mus, identity Psi, data-mean
        noisy W and data-variance sigma2 (reference sssc.py:104-197), drawn
        with NumPy from ``seed`` in evo_tpu's order (pies, mus, W), so Theta^0
        is the same as evo_tpu's.  Pass ``y_host`` (the flat [N, D] host
        data, NaN marking missing entries) to skip the device-to-host copy.
        On incomplete data the mean is normalized by N and sigma2 taken over
        the observed entries (reference sssc.py:146-153)."""
        self._check_width(data)
        check_single_process()
        y, m = host_data(data, self.D, y_host)
        N = y.shape[0]
        if data.incomplete:
            y_mean = (y * m).sum(0) / N
            sigma2 = (((y - y_mean) * m) ** 2).sum() / m.sum() + 0.001
        else:
            y_mean = y.mean(0)
            # mean per-dimension variance, np.cov's ddof=1 (sssc.py:150-160)
            sigma2 = float(np.var(y, axis=0, ddof=1).mean()) + 0.001
        return self._finish_init(data, y_mean, sigma2, seed)

    def _finish_init(self, data: Data, y_mean, sigma2, seed) -> SSSCParams:
        rng = np.random.default_rng(seed)
        pies = rng.uniform(0.1, 0.5, self.H)
        mus = rng.normal(0, 1, self.H) if "mus" in self.to_learn else np.ones(self.H)
        W = y_mean[:, None] + rng.normal(scale=np.sqrt(sigma2) / 4.0, size=(self.D, self.H))
        dt, dev = data.y.dtype, self.device

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        return SSSCParams(W=t(W), pies=t(pies), mus=t(mus), Psi=t(np.eye(self.H)),
                          sigma2=t(sigma2))

    # ----------------------------------------------------------- check/clamp

    def check_params(self, p: SSSCParams) -> SSSCParams:
        """Reference noise policy (sssc.py:51-58): pies in [tol, 1-tol],
        sigma2 >= tol, Psi's diagonal >= tol; Psi is symmetrized, as in
        evo_tpu (the reference's elementwise Psi update is asymmetric)."""
        Psi = 0.5 * (p.Psi + p.Psi.T)
        diag = torch.diagonal(Psi)
        Psi = Psi + torch.diag(torch.clamp(diag, min=PARAM_TOL) - diag)
        return SSSCParams(W=p.W, pies=torch.clamp(p.pies, PARAM_TOL, 1.0 - PARAM_TOL),
                          mus=p.mus, Psi=Psi, sigma2=torch.clamp(p.sigma2, min=PARAM_TOL))

    # ------------------------------------------------------------ generation

    def generate_from_hidden(self, params: SSSCParams, s: torch.Tensor,
                             generator: torch.Generator) -> dict:
        """y = W (s * z) + sqrt(sigma2) noise with z ~ N(mus, Psi)."""
        dev, dt = params.W.device, params.W.dtype
        L = torch.linalg.cholesky(params.Psi)
        z = params.mus + torch.randn((s.shape[0], self.H), generator=generator, device=dev,
                                     dtype=dt) @ L.T
        y_mean = (s.to(dt) * z) @ params.W.T
        noise = torch.randn(y_mean.shape, generator=generator, device=dev, dtype=dt)
        return {"y": y_mean + torch.sqrt(params.sigma2) * noise, "s": s, "z": z,
                "y_mean": y_mean}

    def generate_data(self, params: SSSCParams, N: int, generator: torch.Generator) -> dict:
        """s_h ~ Bernoulli(pies_h) (as p <= pies_h), then generate_from_hidden."""
        p = torch.rand((N, self.H), generator=generator, device=params.W.device)
        return self.generate_from_hidden(params, p <= params.pies, generator)

    # ------------------------------------------------------------ precompute

    def _precompute(self, p: SSSCParams, data: Data) -> dict:
        """State-independent terms (reference sssc.py:329-366); on incomplete
        data ljc counts the observed entries (evo_tpu sssc.py:249-253)."""
        dt = p.W.dtype
        valid = data.row_valid
        N = valid.sum().to(dt)
        log1mp = torch.log(1.0 - p.pies).sum()
        if data.incomplete:
            sum_d = (data.x_infr.to(dt) * valid[..., None].to(dt)).sum()
            ljc = log1mp + (-math.log(2 * math.pi) - torch.log(p.sigma2)) * sum_d / N / 2
        else:
            sum_d = N * self.D
            ljc = (log1mp - self.D / 2 * math.log(2 * math.pi)
                   - 0.5 * self.D * torch.log(p.sigma2))
        return dict(sigma2_inv=1.0 / p.sigma2, pil_bar=torch.log(p.pies / (1.0 - p.pies)),
                    piH=p.pies.sum(), ljc=ljc, N=N, sum_d=sum_d)

    # ---------------------------------------------------------------- E-step

    def _estep_block(self, generator, ss_b, G_b, Wty_b, y2_b, valid_b, params, pre,
                     cfg: EAConfig):
        """Evolutionary E-step of one block [B, ...] (mirrors BSC's).
        Returns (ss2, lpj2, n_uni [B], n_sub [B], reset counts [3])."""

        def lpj_block(states):
            lpj, _bad = sssc_lpj(states, Wty_b, y2_b, G_b, params.Psi, params.mus,
                                 pre["pil_bar"], pre["sigma2_inv"])
            lpj, counts = reset_lpj(lpj, valid=valid_b)
            return lpj, None, torch.stack(counts)

        lpj_K, _, counts = lpj_block(ss_b)
        if cfg.exact:
            zeros = torch.zeros(ss_b.shape[0], dtype=torch.int64, device=ss_b.device)
            return ss_b, lpj_K, zeros, zeros, counts
        children, child_lpj, new_unique, child_lpj_raw, aux = evolve_states_block(
            ss_b, lpj_K, lpj_block, cfg, pre["piH"], generator)
        ss2, lpj2, n_uni, n_sub, _ = merge_states(cfg, ss_b, lpj_K, children, child_lpj,
                                                  new_unique, child_lpj_raw)
        return ss2, lpj2, n_uni, n_sub, counts + sum(aux)

    # ---------------------------------------------------------------- epoch

    def em_step(self, params: SSSCParams, estate: EState, data: Data,
                generator: torch.Generator, cfg: EAConfig, do_reconstruction: bool = False):
        """One EM epoch: E-step, optional reconstruction and M-step over all
        blocks (reference SSSC.EM_step, sssc.py:420-813).

        Returns (new_params, new_estate, stats, y_rec [nb, B, D] or None).
        As in evo_tpu, F is the free energy of the updated K^(n) under the
        old parameters, and the M-step consumes the merged states; on
        incomplete data its W update reads the reconstruction, and its
        sigma2 update the observed entries of the original y.
        ``generator`` (on the data's device) drives every random draw of
        the EA."""
        check_em_step(data, do_reconstruction)
        self._check_width(data)
        params = self.check_params(params)
        pre = self._precompute(params, data)
        dt, dev, H = params.W.dtype, params.W.device, self.H
        acc = {k: torch.zeros((H, H), dtype=dt, device=dev)
               for k in ("xpt_ss", "xpt_szsz", "s_sz_outer", "sz_sz_outer")}
        acc.update(xpt_s=torch.zeros((H,), dtype=dt, device=dev),
                   xpt_sz=torch.zeros((H,), dtype=dt, device=dev),
                   Wp=torch.zeros((self.D, H), dtype=dt, device=dev),
                   y2sum=torch.zeros((), dtype=dt, device=dev),
                   trWszszW=torch.zeros((), dtype=dt, device=dev))
        Fsum = torch.zeros((), dtype=dt, device=dev)
        nuni = torch.zeros((), dtype=torch.int64, device=dev)
        nsub = torch.zeros((), dtype=torch.int64, device=dev)
        resets = torch.zeros((3,), dtype=torch.int64, device=dev)
        ss_all = torch.empty_like(estate.ss)
        lpj_all = torch.empty_like(estate.lpj)
        y_rec_all = torch.empty_like(data.y) if do_reconstruction else None

        for i in range(data.n_blocks):
            y_b, valid_b = data.y[i], data.row_valid[i]
            G_b, Wty_b, y2_b = block_gram(params.W, y_b, data.x_infr[i], data.incomplete)
            ss_b = estate.ss[i]
            if cfg.packed_states:
                ss_b = unpack_bits_lane(ss_b, H).to(torch.int8)
            ss2, lpj2, n_uni, n_sub, counts = self._estep_block(
                generator, ss_b, G_b, Wty_b, y2_b, valid_b, params, pre, cfg)
            if cfg.allzero:  # the permanent all-zero state (evo_tpu sssc.py:467-469)
                lpj2 = torch.cat([-0.5 * pre["sigma2_inv"] * y2_b[:, None], lpj2], 1)
            vf = valid_b.to(dt)
            Fsum += (shifted_logsumexp(lpj2) * vf).sum()
            rs = (posterior_weights(lpj2) * vf[:, None])[:, cfg.S_perm:].contiguous()
            xpt_sz, xpt_s, xpt_ss, xpt_szsz, s_sz, sz_sz = sssc_suffstat(
                ss2, rs, Wty_b, G_b, params.Psi, params.mus, pre["sigma2_inv"])
            y_m = y_b
            if do_reconstruction:
                est = xpt_sz @ params.W.T
                y_rec_all[i] = torch.where(data.x[i], y_b, est)
                if data.incomplete:
                    y_m = y_rec_all[i]
                    acc["trWszszW"] += (data.x_infr[i] * est * est).sum()
            acc["Wp"] += y_m.T @ xpt_sz
            acc["xpt_s"] += xpt_s.sum(0)
            acc["xpt_sz"] += xpt_sz.sum(0)
            acc["xpt_ss"] += xpt_ss
            acc["xpt_szsz"] += xpt_szsz
            acc["s_sz_outer"] += s_sz
            acc["sz_sz_outer"] += sz_sz
            acc["y2sum"] += (y2_b * vf).sum()
            nuni += (n_uni * valid_b).sum()
            nsub += (n_sub * valid_b).sum()
            resets += counts
            ss_all[i] = pack_bits_lane(ss2) if cfg.packed_states else ss2
            lpj_all[i] = lpj2

        new_params, guards = self._m_step_finalize(params, acc, pre, data.incomplete, cfg)
        N = pre["N"]
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        stats = StepStats(
            F=pre["ljc"] + Fsum / N, S_nunique=nuni / N, S_sub=nsub / N,
            n_reset_nan=resets[0], n_reset_small=resets[1], n_reset_inf=resets[2],
            n_guard_sigma_floor=zero, **guards)
        return new_params, EState(ss=ss_all, lpj=lpj_all), stats, y_rec_all

    # ---------------------------------------------------------------- M-step

    def _m_step_finalize(self, params: SSSCParams, acc: dict, pre: dict, incomplete: bool,
                         cfg: EAConfig):
        """Closed-form updates (reference sssc.py:687-770) with evo_tpu's
        guards (evo_tpu/models/sssc.py:637-749): W from an equilibrated PD
        solve, mus and Psi frozen for units whose activation mass
        collapsed, Psi's elementwise reference form, the sigma2 shortcut
        over the posterior-mean reconstructions (on incomplete data over
        their observed entries, plus sum_d times the old sigma2), and in
        f32 the gauge fix diag(Psi) = 1.  Returns (params, guard fields of
        StepStats)."""
        N, D, H = pre["N"], self.D, self.H
        dt, dev = params.W.dtype, params.W.device
        f64 = dt == torch.float64
        new = dict(W=params.W, pies=params.pies, mus=params.mus, Psi=params.Psi,
                   sigma2=params.sigma2)
        guards = dict(n_guard_mus_freeze=torch.zeros((), dtype=torch.int64, device=dev),
                      n_guard_psi_freeze=torch.zeros((), dtype=torch.int64, device=dev),
                      guard_psi_renorm=torch.zeros((), dtype=torch.float32, device=dev))
        alive = acc["xpt_s"] > 1e-4 * N

        if "W" in self.to_learn:
            new["W"] = acc["Wp"] @ equilibrated_pd_inverse(
                acc["xpt_szsz"], rel_ridge=0.0 if f64 else 1e-6)
        if "pies" in self.to_learn:
            new["pies"] = torch.clamp(acc["xpt_s"] / N, EPS_PIES, 1.0 - EPS_PIES)
            if cfg.background:  # evo_tpu sssc.py:672-673
                new["pies"][-1] = 1.0 - 1.1e-5
        if "mus" in self.to_learn:
            mus_upd = acc["xpt_sz"] / (acc["xpt_s"] + torch.finfo(dt).eps)
            new["mus"] = torch.where(alive, mus_upd, params.mus)
            guards["n_guard_mus_freeze"] = (~alive).sum()
        if "Psi" in self.to_learn:
            m = new["mus"]
            num = (torch.outer(m, m) * acc["xpt_ss"] + acc["xpt_szsz"]
                   - 2.0 * m[:, None] * acc["s_sz_outer"])
            Psi_upd = num * equilibrated_pd_inverse(
                acc["xpt_ss"] + EPS_PSI * torch.eye(H, dtype=dt, device=dev),
                rel_ridge=0.0 if f64 else 1e-4)
            if not f64:
                Psi_upd = torch.where(torch.outer(alive, alive), Psi_upd, params.Psi)
                guards["n_guard_psi_freeze"] = (~alive).sum()
            new["Psi"] = Psi_upd
        if "sigma2" in self.to_learn:
            if incomplete:
                s2 = acc["y2sum"] - acc["trWszszW"] + pre["sum_d"] * params.sigma2
            else:
                s2 = acc["y2sum"] - torch.trace(acc["sz_sz_outer"] @ (new["W"].T @ new["W"]))
            new["sigma2"] = torch.clamp(s2 / N / D + EPS_SIGMA2, min=EPS_SIGMA2)

        if {"W", "mus", "Psi"} <= set(self.to_learn) and not f64:
            d = torch.sqrt(torch.clamp(torch.diagonal(new["Psi"]), min=PARAM_TOL))
            new["Psi"] = new["Psi"] / torch.outer(d, d)
            new["mus"] = new["mus"] / d
            new["W"] = new["W"] * d[None, :]
            guards["guard_psi_renorm"] = torch.log(d).abs().max().to(torch.float32)
        return SSSCParams(**new), guards

    # ----------------------------------------------------------- free energy

    def exact_free_energy(self, params: SSSCParams, data: Data) -> torch.Tensor:
        """Exact log-likelihood by enumerating all 2^H states (small H): the
        correctness oracle (reference _models.py:334-451)."""
        self._check_width(data)
        params = self.check_params(params)
        pre = self._precompute(params, data)
        sm = torch.from_numpy(full_state_matrix(self.H).view(np.int8)).to(params.W.device)
        Fsum = torch.zeros((), dtype=params.W.dtype, device=params.W.device)
        for i in range(data.n_blocks):
            y_b = data.y[i]
            G_b, Wty_b, y2_b = block_gram(params.W, y_b, data.x_infr[i], data.incomplete)
            states = sm.expand(y_b.shape[0], -1, -1).contiguous()
            lpj, _ = sssc_lpj(states, Wty_b, y2_b, G_b, params.Psi, params.mus,
                              pre["pil_bar"], pre["sigma2_inv"])
            lpj, _ = reset_lpj(lpj)
            Fsum += (shifted_logsumexp(lpj) * data.row_valid[i].to(lpj.dtype)).sum()
        return pre["ljc"] + Fsum / pre["N"]

    def free_energy(self, params: SSSCParams, estate: EState, data: Data) -> torch.Tensor:
        """Truncated free energy from the stored lpj."""
        pre = self._precompute(self.check_params(params), data)
        lpj = estate.lpj.reshape(-1, estate.lpj.shape[-1])
        return free_energy_from_lpj(lpj, pre["ljc"], data.row_valid.reshape(-1))
