"""Plain reference of one ES3C (spike-and-slab sparse coding) EM epoch, on
complete or incomplete data, with the reconstruction.

Generative model: s_h ~ Bernoulli(pies_h), z ~ N(mus, Psi),
y = W (s * z) + N(0, sigma2 I).  For a binary state s with active units A
the slab integrates out in closed form (Sheikh et al. 2014): with the
observed entries m of a datapoint, G = W_A^T diag(m) W_A, a = mus_A,
u = W_A^T (m y) - G a, M = G / sigma2 + Psi_AA^-1,

  lpj(s)  = -1/2 (log|det M| + log|det Psi_AA| + ||m (y - W_A a)||^2 / sigma2
                  - u^T M^-1 u / sigma2^2) + sum_A log(pies / (1 - pies))
  lpj(0)  = -||m y||^2 / (2 sigma2)
  lambda  = M^-1,  kappa = M^-1 u / sigma2 + a   (the slab's posterior on A)

each state solved on its own units (torch.linalg, in the precision given).
The epoch's outputs: F = ljc + 1/N sum_n logsumexp_s lpj, the
reconstruction where(x, y, <s z> W^T), and the M-step (the port's
reference algorithm, evo's ES3C, with its guards): W = sum_n y_n <sz>^T
(sum <sz sz^T>)^-1 through a ridge of 1e-6 and Jacobi equilibration,
pies = <s> clamped to [5e-5, 1 - 5e-5], mus and Psi (the elementwise
form) frozen for units with <s> below 1e-4 N, sigma2 from the
posterior-mean reconstructions (incomplete data: over the observed
entries, plus sum_d times the old sigma2), and the gauge fix
diag(Psi) = 1 when W, mus and Psi are all learned.  Theta_t is clamped
first (pies in [1e-5, 1 - 1e-5], sigma2 >= 1e-5, Psi symmetrised with its
diagonal >= 1e-5).  On incomplete data y_m in the W update is the
reconstruction.  Rows are taken in chunks; under several ranks each rank
sums its rows and the sums are added before ``finish``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import bounds
from portbench.reference.bsc import equilibrated_inverse
from portbench.reference.precision import Prec

PARAM_TOL = 1e-5
EPS_PIES, EPS_PSI, EPS_SIGMA2 = 5e-5, 1e-5, 1e-5
F32_EPS = float(np.finfo(np.float32).eps)
PARAMS = ("W", "pies", "mus", "Psi", "sigma2")


def checked(th: dict, prec: Prec) -> dict:
    Psi = prec.t(th["Psi"])
    Psi = 0.5 * (Psi + Psi.T)
    d = torch.diagonal(Psi)
    Psi = Psi + torch.diag(d.clamp(min=PARAM_TOL) - d)
    return dict(W=prec.t(th["W"]), pies=prec.t(th["pies"]).clamp(PARAM_TOL, 1 - PARAM_TOL),
                mus=prec.t(th["mus"]), Psi=Psi,
                sigma2=prec.t(th["sigma2"]).clamp(min=PARAM_TOL))


def _groups(ss_rows):
    counts = (ss_rows != 0).sum(-1)
    for n in torch.unique(counts).tolist():
        if n == 0:  # the empty state has nothing to solve
            continue
        rows = torch.nonzero(counts == n).flatten()
        A = torch.nonzero(ss_rows[rows] != 0)[:, 1].reshape(-1, n)
        yield n, rows, A


def solve(y, m, ss, th, prec: Prec):
    """Per state of ss [B, S, H] for rows y [B, D] (0 where missing) with
    observed entries m [B, D]: lpj [B, S], the magnitude of the terms it
    adds [B, S], kappa [B, S, H] and the list of (rows, A, lambda) per
    number of active units."""
    B, S, H = ss.shape
    W, Psi, mus = th["W"], th["Psi"], th["mus"]
    s2inv = 1.0 / th["sigma2"]
    pil = torch.log(th["pies"] / (1 - th["pies"]))
    mf = m.to(prec.dtype)
    ym = prec.t(y) * mf
    y2 = (ym * ym).sum(-1)
    Wty = prec.mm(ym, W)
    rows_ss = ss.reshape(B * S, H)
    b_of = torch.arange(B * S, device=ss.device) // S
    lp = (-0.5 * s2inv * y2)[b_of].clone()
    mag = (0.5 * s2inv * y2)[b_of].clone()
    kappa = torch.zeros(B * S, H, dtype=prec.dtype, device=ss.device)
    lams = []
    full_obs = bool(m.all())
    G_full = prec.mm(W.T, W) if full_obs else None
    for n, rows, A in _groups(rows_ss):
        b = b_of[rows]
        if full_obs:
            G = G_full[A[:, :, None], A[:, None, :]]
        else:
            WA = W.T[A]  # [M, n, D]
            G = prec.einsum("mid,md,mjd->mij", WA, mf[b], WA)
        PsiA = Psi[A[:, :, None], A[:, None, :]]
        a = mus[A]
        wty = Wty[b[:, None], A]
        Ga = prec.mm(G, a[..., None])[..., 0]
        u = wty - Ga
        Mmat = s2inv * G + torch.linalg.inv(PsiA)
        lam = torch.linalg.inv(Mmat)
        lam_u = prec.mm(lam, u[..., None])[..., 0]
        logdet = torch.linalg.slogdet(Mmat)[1] + torch.linalg.slogdet(PsiA)[1]
        aGa = (a * Ga).sum(-1)
        aw = (a * wty).sum(-1)
        quad = (u * lam_u).sum(-1)
        val = -0.5 * (logdet + s2inv * (y2[b] - 2 * aw + aGa) - s2inv * s2inv * quad)
        lp[rows] = val + pil[A].sum(-1)
        mag[rows] = 0.5 * (logdet.abs() + s2inv * (y2[b] + 2 * aw.abs() + aGa.abs())
                           + s2inv * s2inv * quad.abs()) + pil[A].abs().sum(-1)
        kappa[rows[:, None], A] = s2inv * lam_u + a
        lams.append((rows, A, lam))
    return lp.reshape(B, S), mag.reshape(B, S), kappa.reshape(B, S, H), lams


def lpj(y, m, ss, th, prec: Prec):
    lp, mag, _, _ = solve(y, m, ss, th, prec)
    return lp, mag


def zero_sums(D: int, H: int, prec: Prec, device) -> dict:
    z = dict(dtype=prec.dtype, device=device)
    out = {k: torch.zeros(H, H, **z) for k in ("xpt_ss", "xpt_szsz", "s_sz", "sz_sz")}
    out.update(xpt_s=torch.zeros(H, **z), xpt_sz=torch.zeros(H, **z), Wp=torch.zeros(D, H, **z),
               y2sum=torch.zeros((), **z), trWszszW=torch.zeros((), **z),
               Fsum=torch.zeros((), **z), N=torch.zeros((), **z), sum_d=torch.zeros((), **z))
    return out


def block(sums: dict, y, m, x, valid, ss, th, prec: Prec, incomplete: bool):
    """Add rows (y [B, D] with 0 at missing entries, observed m, kept x,
    valid [B], states [B, S, H]) to the sums.  Returns (lpj, magnitude,
    the reconstruction [B, D])."""
    B, S, H = ss.shape
    lp, mag, kappa, lams = solve(y, m, ss, th, prec)
    vf = valid.to(prec.dtype)
    mf = m.to(prec.dtype)
    r = torch.softmax(lp, -1) * vf[:, None]
    sf = ss.to(prec.dtype)
    xs = (r[..., None] * sf).sum(1)  # [B, H]
    xsz = (r[..., None] * kappa).sum(1)
    szsz = prec.einsum("bs,bsh,bsk->hk", r, kappa, kappa).reshape(-1)
    rf = r.reshape(-1)
    for rows, A, lam in lams:
        flat = (A[:, :, None] * H + A[:, None, :]).reshape(-1)
        szsz.index_add_(0, flat, (rf[rows, None, None] * lam).reshape(-1))
    yt = prec.t(y)
    est = prec.mm(xsz, th["W"].T)
    y_rec = torch.where(x, yt, est)
    ym = y_rec if incomplete else yt
    sums["Wp"] += prec.mm(ym.T, xsz)
    sums["xpt_s"] += xs.sum(0)
    sums["xpt_sz"] += xsz.sum(0)
    sums["xpt_ss"] += prec.einsum("bs,bsh,bsk->hk", r, sf, sf)
    sums["xpt_szsz"] += szsz.reshape(H, H)
    sums["s_sz"] += prec.mm(xs.T, xsz)
    sums["sz_sz"] += prec.mm(xsz.T, xsz)
    ymo = yt * mf
    sums["y2sum"] += ((ymo * ymo).sum(-1) * vf).sum()
    if incomplete:
        sums["trWszszW"] += (mf * est * est).sum()
    sums["Fsum"] += (torch.logsumexp(lp, -1) * vf).sum()
    sums["N"] += vf.sum()
    sums["sum_d"] += (mf.sum(-1) * vf).sum()
    return lp, mag, y_rec


def finish(sums: dict, th: dict, prec: Prec, D: int, H: int, incomplete: bool,
           to_learn=PARAMS):
    """(Theta_{t+1}, F) from the summed rows."""
    N = sums["N"]
    dt, dev = prec.dtype, sums["N"].device
    eye = torch.eye(H, dtype=dt, device=dev)
    new = {k: th[k] for k in PARAMS}
    alive = sums["xpt_s"] > 1e-4 * N
    if "W" in to_learn:
        new["W"] = prec.mm(sums["Wp"], equilibrated_inverse(sums["xpt_szsz"], 1e-6, prec))
    if "pies" in to_learn:
        new["pies"] = (sums["xpt_s"] / N).clamp(EPS_PIES, 1 - EPS_PIES)
    if "mus" in to_learn:
        new["mus"] = torch.where(alive, sums["xpt_sz"] / (sums["xpt_s"] + F32_EPS), th["mus"])
    if "Psi" in to_learn:
        mu = new["mus"]
        num = torch.outer(mu, mu) * sums["xpt_ss"] + sums["xpt_szsz"] - 2 * mu[:, None] * sums[
            "s_sz"]
        Psi = num * equilibrated_inverse(sums["xpt_ss"] + EPS_PSI * eye, 1e-4, prec)
        new["Psi"] = torch.where(torch.outer(alive, alive), Psi, th["Psi"])
    if "sigma2" in to_learn:
        if incomplete:
            s2 = sums["y2sum"] - sums["trWszszW"] + sums["sum_d"] * th["sigma2"]
        else:
            s2 = sums["y2sum"] - torch.trace(prec.mm(sums["sz_sz"], prec.mm(new["W"].T, new["W"])))
        new["sigma2"] = (s2 / N / D + EPS_SIGMA2).clamp(min=EPS_SIGMA2)
    if {"W", "mus", "Psi"} <= set(to_learn):
        d = torch.sqrt(torch.diagonal(new["Psi"]).clamp(min=PARAM_TOL))
        new["Psi"] = new["Psi"] / torch.outer(d, d)
        new["mus"] = new["mus"] / d
        new["W"] = new["W"] * d[None, :]
    log1mp = torch.log(1 - th["pies"]).sum()
    if incomplete:
        ljc = log1mp + (-math.log(2 * math.pi) - torch.log(th["sigma2"])) * sums["sum_d"] / N / 2
    else:
        ljc = log1mp - D / 2 * math.log(2 * math.pi) - 0.5 * D * torch.log(th["sigma2"])
    return new, ljc + sums["Fsum"] / N


def theta0(Y: np.ndarray, seed: int, H: int, to_learn=PARAMS) -> dict:
    """Theta^0 as the algorithm defines it, from the data [N, D] (NaN where
    missing): pies ~ U(0.1, 0.5), mus ~ N(0, 1) (ones when not learned),
    W = the data mean plus N(0, sigma2 / 16), in that order from NumPy's
    default_rng(seed); Psi = I; sigma2 = the mean per-dimension variance
    (ddof 1) plus 0.001, on incomplete data the observed entries' squared
    deviation from the mean (the mean normalised by N) plus 0.001."""
    Y = np.asarray(Y, dtype=np.float64)
    N, D = Y.shape
    m = ~np.isnan(Y)
    y = np.where(m, Y, 0.0)
    if not m.all():
        mean = (y * m).sum(0) / N
        sigma2 = (((y - mean) * m) ** 2).sum() / m.sum() + 0.001
    else:
        mean = y.mean(0)
        sigma2 = float(np.var(y, axis=0, ddof=1).mean()) + 0.001
    rng = np.random.default_rng(seed)
    pies = rng.uniform(0.1, 0.5, H)
    mus = rng.normal(0, 1, H) if "mus" in to_learn else np.ones(H)
    W = mean[:, None] + rng.normal(scale=np.sqrt(sigma2) / 4.0, size=(D, H))
    return dict(W=W, pies=pies, mus=mus, Psi=np.eye(H), sigma2=np.float64(sigma2))


def epoch_work(n, u, ea: dict, D: int, incomplete: bool, reconstructs: bool):
    """(the port kernels' calls of one EA epoch as work dicts, the f32
    operations of the epoch's dense products), from the state sets' active
    counts n [nb, B, S] and union sizes u [nb, B] (float64): per block the
    lpj of K^(n), of each generation's P C children (at the block's mean
    active count, on the block's unions) and the suffstat of the kept
    sets; the dense products are the Gram (per datapoint on incomplete
    data), W^T y, ||y||^2, the W accumulator and the reconstruction per
    block, and the M-step's inverses and products."""
    nb, B, S = n.shape
    H = ea["H"]
    PC = ea["n_parents"] * ea["n_children"]
    calls = []
    for b in range(nb):
        child = torch.full((B * PC,), float(n[b].mean()), dtype=torch.float64)
        if incomplete:
            calls.append(bounds.sssc_lpj_masked(n[b], u[b], B, S, H))
            for _ in range(ea["n_generations"]):
                calls.append(bounds.sssc_lpj_masked(child, u[b], B, PC, H))
            calls.append(bounds.sssc_suffstat_masked(n[b], u[b], B, S, H))
        else:
            calls.append(bounds.sssc_lpj(n[b], B, S, H))
            for _ in range(ea["n_generations"]):
                calls.append(bounds.sssc_lpj(child, B, PC, H))
            calls.append(bounds.sssc_suffstat(n[b], u[b], B, S, H))
    gram = 2 * B * D * H * H if incomplete else 2 * D * H * H
    per_block = gram + 4 * B * D * H + 2 * B * D + (2 * B * D * H if reconstructs else 0)
    per_block += 2 * B * D if incomplete else 0
    dense = nb * per_block + 4 * H**3 + 2 * D * H * H
    if not incomplete:  # sigma2's trace of sz_sz W^T W
        dense += 2 * H**3 + 2 * H * H * D
    return calls, float(dense)
