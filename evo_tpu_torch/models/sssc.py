"""Spike-and-Slab Sparse Coding trained with evolutionary E-steps (ES3C).

Counterpart: evo_tpu/models/sssc.py.  Generative model:

    s_h ~ Bernoulli(pies_h),  z ~ N(mus, Psi),  y = W (s * z) + N(0, sigma2 I)

The slab z is marginalized in closed form per binary state s (Sheikh et al.
2014): with G = W^T W, Wty = W^T y and y2 = ||y||^2 precomputed once per
block, every per-state quantity is an |s| x |s| solve, independent of D.

An epoch (``em_step``) is the runner that ``SSSC`` shares with ``BSC``
(``models/epoch.py``; reference SSSC.EM_step, sssc.py:420-813).  This
model supplies the math: the lpj through the ``sssc_lpj`` kernel, the
merged states' statistics through the ``sssc_suffstat`` kernel, which
solves the merged states again as evo_tpu's kernel path does
(``_suffstat_phase``), and the M-step; the rest is plain PyTorch on the
same device.  evo_tpu's XLA path stashes the candidate solves instead
(``STASH_MAX_H``); that is an XLA strategy and is not carried over.  The
blocks are not graphed yet (``_graphable``); ``_theta`` is the set of
static buffers they would read.

Incomplete data (NaN entries in ``make_data``) run under the per-datapoint
Gram G_n = W^T diag(m_n) W, built one block at a time, through the masked
kernels (``sssc_lpj_masked``, ``sssc_suffstat_masked``), and need
``do_reconstruction=True`` as in evo_tpu; the reconstruction
y_rec = where(x, y, <sz> W^T) is returned blocked [nb, B, D] and feeds the
W update, and the sigma2 update reads the observed entries of the
original y.

With ``EAConfig.packed_states`` the state sets are stored lane-major
bit-packed; each block is unpacked to int8 at its start and the merged set
packed at its end (``_states_in``, ``_states_out``), as in evo_tpu
(evo_tpu/models/sssc.py:486-487, 597), which routes packed ES3C to XLA;
the port runs its kernels on the unpacked block.  The permanent states
(``allzero``, ``background``) and the merges ``swap_merge`` and
``unification=False`` run as in evo_tpu.

Widths: the kernels cover H <= 128 on complete data and H <= 64 on
incomplete data (``ops.sssc_lpj.MAX_H``, ``MASKED_MAX_H``).  Wider models
take the wide path, the counterpart of evo_tpu's XLA path
(``SSSC._state_solve``, ``_lpj_states`` and the re-solve of the merged set,
evo_tpu/models/sssc.py:266-329, 509-539): plain PyTorch at model level,
``sssc_lpj_wide`` for the lpj and ``sssc_suffstat_wide`` for the
statistics, which solve each state's |s| x |s| system by a batched LU
factorization (see ``wide_solves``); on incomplete data each state is
solved under its own datapoint's G_n, whose build is the span
``wide.gram`` (``_gram``).  The path is chosen from H
and ``data.incomplete`` alone (``SSSC.wide``), before anything is
launched, the same way on every device, as evo_tpu's
``pallas_sssc_applicable`` chooses; the limits are read when the model is
called.

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
from evo_tpu_torch.ops import sssc_lpj as sssc_lpj_ops
from evo_tpu_torch.ops.bitpack import pack_bits_lane, unpack_bits_lane
from evo_tpu_torch.ops.linalg import equilibrated_pd_inverse
from evo_tpu_torch.ops.numerics import (
    posterior_weights,
    reset_lpj,
    shifted_logsumexp,
)
from evo_tpu_torch.ops.sssc_lpj import active_groups, gather_sub, gram_sub, sssc_lpj
from evo_tpu_torch.ops.sssc_suffstat import moments, sssc_suffstat
from evo_tpu_torch.parallel import distributed
from evo_tpu_torch.utils import tracing
from evo_tpu_torch.variational.config import EAConfig

PARAM_TOL = 1e-5  # reference noise_policy bounds (sssc.py:40,51-58)
EPS_PIES = 5e-5
EPS_PSI = 1e-5
EPS_SIGMA2 = 1e-5
WIDE_CHUNK_BYTES = 256 << 20  # the n x n temporaries of a chunk of the wide path's solves


def wide_solves(ss, Wty, G, Psi, mus, s2inv):
    """The slab solves of states ss [B, K, H] on the wide path: evo_tpu's
    ``SSSC._state_solve`` (evo_tpu/models/sssc.py:266-281), each state
    solved on its active units A (ascending) instead of identity-padded to
    H x H, which is the same math.  With a = mus_A and
    u = Wty[b]_A - G_AA a,

        Pinv = Psi_AA^-1,   M = s2inv G_AA + Pinv,   lam_u = M^-1 u,
        logdet = log|det M| + log|det Psi_AA|,

    by batched LU factorizations with partial pivoting, log|det| the sum of
    log|U_ii|: the sign is ignored, as evo_tpu's Schur recursion ignores it,
    so an indefinite Psi_AA gives finite values as there.  G is the shared
    Gram [H, H] or the per-datapoint one [B, H, H].  The states are grouped
    by |s| (the empty state has nothing to solve) and each group taken in
    chunks of at most WIDE_CHUNK_BYTES of n x n temporaries (about 64 n^2
    bytes a state, the gathers' int64 indices included).  A state is
    ``bad`` where Pinv is not finite (evo_tpu's rule) or either factor is
    singular.  Yields a dict per chunk: rows (into the flat [B K] states),
    b, A, a, wty (Wty[b]_A), u, lam_u, logdet, bad and the factors of M
    (LU_M, piv_M); entries of bad states are garbage.

    Counts on the innermost open span, from the groups' host shapes:
    ``wide.groups`` (|s| groups), ``wide.chunks`` (the chunks, each two
    batched factorizations), ``wide.states`` (the states solved, the empty
    state not among them) and ``wide.n1``, ``wide.n2``, ``wide.n3`` (the
    sums of n, n^2 and n^3 over them)."""
    B, K, H = ss.shape
    b_of = torch.arange(B * K, device=ss.device) // K
    for n, rows_n, A_n in active_groups(ss.reshape(B * K, H)):
        m = rows_n.numel()
        step = max(1, WIDE_CHUNK_BYTES // (64 * n * n))
        tracing.count("wide.groups", 1)
        tracing.count("wide.chunks", -(-m // step))
        tracing.count("wide.states", m)
        tracing.count("wide.n1", m * n)
        tracing.count("wide.n2", m * n * n)
        tracing.count("wide.n3", m * n ** 3)
        for c in range(0, m, step):
            rows, A = rows_n[c:c + step], A_n[c:c + step]
            b = b_of[rows]
            a = mus[A]
            G_AA = gram_sub(G, b, A)
            wty = Wty[b[:, None], A]
            u = wty - (G_AA @ a[..., None])[..., 0]
            eye = torch.eye(n, dtype=G.dtype, device=G.device).expand(rows.numel(), n, n)
            LU_P, piv_P, info_P = torch.linalg.lu_factor_ex(gather_sub(Psi, A))
            Pinv = torch.linalg.lu_solve(LU_P, piv_P, eye)
            LU_M, piv_M, info_M = torch.linalg.lu_factor_ex(s2inv * G_AA + Pinv)
            logdet = (torch.log(torch.diagonal(LU_M, dim1=-2, dim2=-1).abs()).sum(-1)
                      + torch.log(torch.diagonal(LU_P, dim1=-2, dim2=-1).abs()).sum(-1))
            bad = (info_P > 0) | (info_M > 0) | ~torch.isfinite(Pinv).flatten(1).all(-1)
            yield dict(rows=rows, b=b, A=A, a=a, wty=wty, u=u,
                       lam_u=torch.linalg.lu_solve(LU_M, piv_M, u[..., None])[..., 0],
                       logdet=logdet, bad=bad, LU_M=LU_M, piv_M=piv_M)


def sssc_lpj_wide(ss, Wty, y2, G, Psi, mus, pil_bar, s2inv):
    """``sssc_lpj``'s arguments and results, on the wide path: evo_tpu's
    ``SSSC._lpj_states`` (evo_tpu/models/sssc.py:284-329),

        lpj = -1/2 (log|det M| + log|det Psi_AA| + s2inv ||y - W_A a||^2
                    - s2inv^2 u^T M^-1 u) + sum_A pil_bar,

    with ||y - W_A a||^2 = y2 - 2 a.Wty_A + a^T G_AA a.  A bad state (see
    ``wide_solves``), or one whose lpj is not finite, is flagged and gets
    NaN, which ``reset_lpj`` floors (never +-inf, which it would make the
    dominant lpj).  The call is the span ``wide.lpj``, with
    ``wide_solves``'s counters."""
    B, K, _ = ss.shape
    with tracing.span("wide.lpj", ss.device):
        s2inv = torch.as_tensor(s2inv, dtype=Wty.dtype, device=Wty.device)
        b_of = torch.arange(B * K, device=ss.device) // K
        lpj = (-0.5 * s2inv * y2[b_of]).clone()  # the empty state
        bad = torch.zeros(B * K, dtype=Wty.dtype, device=Wty.device)
        for c in wide_solves(ss, Wty, G, Psi, mus, s2inv):
            a, wty, u = c["a"], c["wty"], c["u"]
            ynorm2 = y2[c["b"]] - 2.0 * (a * wty).sum(-1) + (a * (wty - u)).sum(-1)
            val = (-0.5 * (c["logdet"] + s2inv * ynorm2
                           - s2inv * s2inv * (u * c["lam_u"]).sum(-1))
                   + pil_bar[c["A"]].sum(-1))
            flag = c["bad"] | ~torch.isfinite(val)
            lpj[c["rows"]] = torch.where(flag, float("nan"), val)
            bad[c["rows"]] = flag.to(bad.dtype)
        return lpj.reshape(B, K), bad.reshape(B, K)


def sssc_suffstat_wide(ss, rs, Wty, G, Psi, mus, s2inv):
    """``sssc_suffstat``'s arguments and results, on the wide path: the
    merged states re-solved for the statistics, as evo_tpu does above
    ``STASH_MAX_H`` (evo_tpu/models/sssc.py:509-539), with the posterior
    slab means kappa = s2inv M^-1 u + a and covariances lambda = M^-1 on
    the active units.  A bad state contributes nothing, and non-finite
    entries are 0 (evo_tpu's ``nan_to_num``).  The lambda shares are summed
    per H^2 bin in f64, as in ``sssc_suffstat_plain``.  The call is the
    span ``wide.suffstat``, with ``wide_solves``'s counters."""
    B, S, H = ss.shape
    with tracing.span("wide.suffstat", ss.device):
        s2inv = torch.as_tensor(s2inv, dtype=Wty.dtype, device=Wty.device)
        r = rs.reshape(B * S)
        kappa = torch.zeros((B * S, H), dtype=Wty.dtype, device=Wty.device)
        szsz = torch.zeros(H * H, dtype=torch.float64, device=Wty.device)
        for c in wide_solves(ss, Wty, G, Psi, mus, s2inv):
            rows, A, ok = c["rows"], c["A"], ~c["bad"]
            n = A.shape[1]
            eye = torch.eye(n, dtype=Wty.dtype, device=Wty.device).expand(rows.numel(), n, n)
            lam = torch.linalg.lu_solve(c["LU_M"], c["piv_M"], eye)
            kap = s2inv * c["lam_u"] + c["a"]
            kappa[rows[:, None], A] = torch.nan_to_num(torch.where(ok[:, None], kap, 0.0),
                                                       nan=0.0, posinf=0.0, neginf=0.0)
            lam = torch.nan_to_num(torch.where(ok[:, None, None], lam, 0.0),
                                   nan=0.0, posinf=0.0, neginf=0.0)
            flat = (A[:, :, None] * H + A[:, None, :]).flatten()
            szsz.index_add_(0, flat, (r[rows, None, None] * lam).flatten().double())
        return moments(ss.reshape(B * S, H), r, kappa, szsz, B)


@dataclasses.dataclass
class SSSCParams:
    W: torch.Tensor  # [D, H]
    pies: torch.Tensor  # [H]
    mus: torch.Tensor  # [H]
    Psi: torch.Tensor  # [H, H]
    sigma2: torch.Tensor  # scalar


@dataclasses.dataclass(frozen=True)
class SSSC(EMModel):
    """Static model configuration.  ``device`` None means the CUDA card."""

    D: int
    H: int
    to_learn: Tuple[str, ...] = ("W", "pies", "mus", "sigma2", "Psi")
    device: torch.device = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def wide(self, data: Data) -> bool:
        """Whether this model takes the wide path on ``data``: H above the
        kernels' limit, ``MASKED_MAX_H`` on incomplete data and ``MAX_H``
        on complete data (evo_tpu's ``pallas_sssc_applicable``)."""
        limit = sssc_lpj_ops.MASKED_MAX_H if data.incomplete else sssc_lpj_ops.MAX_H
        return self.H > limit

    def _lpj_fns(self, data: Data):
        """(lpj, suffstat) functions of this model's path on ``data`` (or a
        block's ``io``, which says whether it is incomplete)."""
        if self.wide(data):
            return sssc_lpj_wide, sssc_suffstat_wide
        return sssc_lpj, sssc_suffstat

    def _graphable(self, data: Data) -> bool:
        """Whether the blocks may replay CUDA graphs: not yet."""
        return False

    # ------------------------------------------------------------------ init

    def standard_init(self, data: Data, seed: int = 0, y_host=None) -> SSSCParams:
        """Random-uniform pies, standard-normal mus, identity Psi, data-mean
        noisy W and data-variance sigma2 (reference sssc.py:104-197), drawn
        with NumPy from ``seed`` in evo_tpu's order (pies, mus, W), so Theta^0
        is the same as evo_tpu's.  Pass ``y_host`` (the flat [N, D] host
        data, NaN marking missing entries) to skip the device-to-host copy
        (this rank's rows under a process group).  On incomplete data the
        mean is normalized by N and sigma2 taken over the observed entries
        (reference sssc.py:146-153).  Under a group of several ranks the
        statistics are summed over the ranks (``global_init_stats``), so
        that every rank draws the same Theta^0."""
        if distributed.rank_world()[1] > 1:
            # Theta^0 from global sums, the same on every rank (evo_tpu
            # sssc.py:118-131)
            N, y_mean, ss_resid, m_sum = distributed.global_init_stats(data, y_host, self.D)
            if data.incomplete:
                sigma2 = ss_resid / m_sum + 0.001
            else:
                # np.cov's ddof=1, as below
                sigma2 = ss_resid / (N - 1.0) / self.D + 0.001
        else:
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

    # the data sums of _precompute that an epoch sums over the ranks
    DATA_SUMS = ("N", "sum_d")

    def _precompute(self, p: SSSCParams, data: Data, sums: dict = None) -> dict:
        """State-independent terms (reference sssc.py:329-366); on incomplete
        data ljc counts the observed entries (evo_tpu sssc.py:249-253).
        ``sums`` (``DATA_SUMS`` over every rank) replaces this rank's."""
        dt = p.W.dtype
        if sums is None:
            valid = data.row_valid
            N = valid.sum().to(dt)
            sum_d = ((data.x_infr.to(dt) * valid[..., None].to(dt)).sum() if data.incomplete
                     else N * self.D)
        else:
            N, sum_d = sums["N"], sums["sum_d"]
        log1mp = torch.log(1.0 - p.pies).sum()
        if data.incomplete:
            ljc = log1mp + (-math.log(2 * math.pi) - torch.log(p.sigma2)) * sum_d / N / 2
        else:
            ljc = (log1mp - self.D / 2 * math.log(2 * math.pi)
                   - 0.5 * self.D * torch.log(p.sigma2))
        return dict(sigma2_inv=1.0 / p.sigma2, pil_bar=torch.log(p.pies / (1.0 - p.pies)),
                    piH=p.pies.sum(), ljc=ljc, N=N, sum_d=sum_d)

    # ---------------------------------------------------------------- E-step
    #
    # The math of the runner's phases (``models/epoch.py``).

    @staticmethod
    def _theta(params: SSSCParams, pre: dict) -> dict:
        return dict(W=params.W, Psi=params.Psi, mus=params.mus, pil_bar=pre["pil_bar"],
                    sigma2_inv=pre["sigma2_inv"], piH=pre["piH"])

    def _gram(self, io):
        """``block_gram``; where it builds G_n for the wide path (incomplete
        data above ``MASKED_MAX_H``) it is the span ``wide.gram``, nested in
        ``em_step.lpj``, with the counters ``wide.gram_rows`` (the block's
        datapoints, B) and ``wide.gram_cells`` (the data entries read, B D),
        from host shapes."""
        if not (io.incomplete and self.wide(io)):
            return super()._gram(io)
        B, D = io.y.shape
        with tracing.span("wide.gram", io.dev):
            tracing.count("wide.gram_rows", B)
            tracing.count("wide.gram_cells", B * D)
            return super()._gram(io)

    def _lpj(self, io, cfg: EAConfig, states):
        """(lpj [B, K], None, reset counts [3]) of states [B, K, H] int8
        under the block's Gram, by the kernel or the wide path; the EA keys
        the states itself."""
        lpj, _bad = self._lpj_fns(io)[0](states, io.Wty, io.y2, io.G, io.Psi, io.mus,
                                         io.pil_bar, io.sigma2_inv)
        lpj, counts = reset_lpj(lpj, valid=io.valid)
        return lpj, None, torch.stack(counts)

    def _states_in(self, ss, cfg: EAConfig):
        return unpack_bits_lane(ss, self.H).to(torch.int8) if cfg.packed_states else ss

    def _states_out(self, ss, cfg: EAConfig):
        return pack_bits_lane(ss) if cfg.packed_states else ss

    def _suffstat_phase(self, io, acc, cfg: EAConfig):
        """F, responsibilities, the suffstat kernel (or the wide path's),
        the reconstruction into ``io.y_rec`` (unless None) and the M-step
        sums into ``acc``; the stored lpj (the all-zero state's first with
        ``allzero``) is ``io.lpj_full``."""
        dt, lpj2 = io.W.dtype, io.lpj2
        if cfg.allzero:  # the permanent all-zero state (evo_tpu sssc.py:467-469)
            lpj2 = torch.cat([-0.5 * io.sigma2_inv * io.y2[:, None], lpj2], 1)
        vf = io.valid.to(dt)
        acc.Fsum += (shifted_logsumexp(lpj2) * vf).sum()
        rs = (posterior_weights(lpj2) * vf[:, None])[:, cfg.S_perm:].contiguous()
        xpt_sz, xpt_s, xpt_ss, xpt_szsz, s_sz, sz_sz = self._lpj_fns(io)[1](
            io.ss2, rs, io.Wty, io.G, io.Psi, io.mus, io.sigma2_inv)
        y_m = io.y
        if io.y_rec is not None:
            est = xpt_sz @ io.W.T
            io.y_rec.copy_(torch.where(io.x, io.y, est))
            if io.incomplete:
                y_m = io.y_rec
                acc.trWszszW += (io.x_infr * est * est).sum()
        acc.Wp += y_m.T @ xpt_sz
        acc.xpt_s += xpt_s.sum(0)
        acc.xpt_sz += xpt_sz.sum(0)
        acc.xpt_ss += xpt_ss
        acc.xpt_szsz += xpt_szsz
        acc.s_sz_outer += s_sz
        acc.sz_sz_outer += sz_sz
        acc.y2sum += (io.y2 * vf).sum()
        io.lpj_full = lpj2

    def _sum_shapes(self) -> dict:
        H = self.H
        return dict(xpt_ss=(H, H), xpt_szsz=(H, H), s_sz_outer=(H, H), sz_sz_outer=(H, H),
                    xpt_s=(H,), xpt_sz=(H,), Wp=(self.D, H), y2sum=(), trWszszW=())

    # ---------------------------------------------------------------- M-step

    def _m_step_finalize(self, params: SSSCParams, acc: dict, pre: dict, incomplete: bool,
                         cfg: EAConfig):
        """Closed-form updates (reference sssc.py:687-770) with evo_tpu's
        guards (evo_tpu/models/sssc.py:637-749): W from an equilibrated PD
        solve, mus and Psi frozen for units whose activation mass
        collapsed, Psi's elementwise reference form, the sigma2 shortcut
        over the posterior-mean reconstructions (on incomplete data over
        their observed entries, plus sum_d times the old sigma2), and in
        f32 the gauge fix diag(Psi) = 1.  Returns (params, the guard fields
        of StepStats it sets)."""
        N, D, H = pre["N"], self.D, self.H
        dt, dev = params.W.dtype, params.W.device
        f64 = dt == torch.float64
        new = dict(W=params.W, pies=params.pies, mus=params.mus, Psi=params.Psi,
                   sigma2=params.sigma2)
        guards = {}
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
