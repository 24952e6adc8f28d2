"""Plain reference of one EBSC (binary sparse coding) EM epoch on incomplete
data, with the reconstruction.

Generative model: s_h ~ Bernoulli(pi), y = W s + N(0, sigma^2 I), W [D, H].
A datapoint's observed entries m (x_infr) are the only ones its states are
judged on.  Given Theta_t and the state sets K^(n) that the E-step kept,
the epoch has to produce

  lpj(s) = -||m (y - W s)||^2 / (2 sigma^2) + |s| log(pi / (1 - pi))
  F      = H log(1 - pi) - sum_d / (2 N) log(2 pi sigma^2)
           + 1/N sum_n logsumexp_s lpj          (sum_d: the observed entries)
  r      = softmax_s lpj   (the truncated posterior)
  y_rec  = where(x, y, sum_s r W s)             (x: the entries kept)
  W      = (sum_n y_rec,n <s>_n^T) (sum_n <s s^T>_n)^-1
  pies   = 1/N sum_n <s>_n,  pi = mean_h pies_h
  sigma  = sqrt((sum_n <||m (y_rec,n - W_t s)||^2>_n + sum_d sigma_t^2) / (N D))

with the guards the algorithm states: Theta_t clamped first (pi in
[1e-5, 1 - 1e-5], sigma >= 1e-5), W's inverse taken with a relative ridge
of 1e-6 of the mean diagonal after Jacobi equilibration, and sigma floored
at 1e-3 of the observed entries' RMS.  The residual is taken directly over
the observed entries, m (y - W s), never in the Gram form
y2 - 2 s.W^T(m y) + s^T G_n s with G_n = W^T diag(m) W that the program
uses.  On complete data (every m true) the lpj, sums and update are those
of ``portbench/reference/bsc.py``.

Departures from the published algorithm (Drefs, Guiraud, Luecke, JMLR
23(21), 2022), each taken from the reference implementation (tvlearn/evo
and evo_tpu) that the program ports:

- sigma's update adds sum_d sigma_t^2 to the residual and divides by N D,
  not by sum_d: the missing entries' share of the noise is carried at the
  old sigma (evo_tpu/models/bsc.py:530-532).
- the W update reads the reconstruction y_rec in place of y, so the
  missing entries enter it at their posterior mean.
- Theta^0 (``theta0``): W = the data mean (summed over the observed
  entries, divided by N) plus N(0, (sigma/4)^2), sigma the observed
  entries' RMS deviation from that mean, pi = 1/H
  (evo_tpu/models/bsc.py:125-135).
- the lpj magnitude that the comparison divides by is floored at the
  smallest normal float of its precision: a patch whose observed entries
  are all 0 after DC centring (inside a flat region of the image) has an
  empty state whose lpj and magnitude are both 0, so an exact agreement
  reads 0 and any difference reads far above every limit.

Rows are taken in chunks; under several ranks each rank sums its rows and
the sums are added before ``finish``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import bounds
from portbench.reference import bsc as bsc_ref
from portbench.reference.bsc import RIDGE, checked, equilibrated_inverse  # noqa: F401
from portbench.reference.precision import Prec

PARAMS = ("W", "pi", "sigma", "pies")


def _terms(y, m, ss, th, prec: Prec):
    """(lpj [B, S], floored magnitude [B, S], the states' means W s
    [B, S, D]) of states ss [B, S, H] for rows y [B, D] (0 where missing)
    with observed entries m [B, D].  The magnitude is the size of the terms
    the program's Gram form adds, |pre1| (||m y||^2 + 2 |s.W^T (m y)|
    + s^T G_n s) + |log(pi/(1-pi))| |s|, which its rounding scales with."""
    W = th["W"]
    sf = ss.to(prec.dtype)
    mf = m.to(prec.dtype)
    ym = prec.t(y) * mf
    means = prec.mm(sf, W.T)  # [B, S, D]
    res = (ym[:, None, :] - means) * mf[:, None, :]
    r2 = (res * res).sum(-1)
    pre1 = -0.5 / th["sigma"] ** 2
    pil = torch.log(th["pi"] / (1 - th["pi"]))
    nbits = sf.sum(-1)
    with torch.no_grad():
        mWs = means * mf[:, None, :]
        mag = (pre1.abs() * ((ym * ym).sum(-1)[:, None] + 2 * (mWs * ym[:, None, :]).sum(-1).abs()
                             + (mWs * mWs).sum(-1)) + pil.abs() * nbits)
    mag = mag.clamp(min=torch.finfo(mag.dtype).tiny)
    return pre1 * r2 + pil * nbits, mag, means


def lpj(y, m, ss, th, prec: Prec):
    """(lpj [B, S], magnitude [B, S]) of states ss [B, S, H]."""
    lp, mag, _ = _terms(y, m, ss, th, prec)
    return lp, mag


def zero_sums(D: int, H: int, prec: Prec, device) -> dict:
    z = dict(dtype=prec.dtype, device=device)
    return dict(Wp=torch.zeros(H, D, **z), Wq=torch.zeros(H, H, **z),
                pies=torch.zeros(H, **z), sig=torch.zeros((), **z),
                Fsum=torch.zeros((), **z), N=torch.zeros((), **z),
                sum_d=torch.zeros((), **z), y2sum=torch.zeros((), **z))


def block(sums: dict, y, m, x, valid, ss, th, prec: Prec, incomplete: bool):
    """Add rows (y [B, D] with 0 at missing entries, observed m, kept x,
    valid [B] bool, states [B, S, H]) to the sums.  Returns (lpj,
    magnitude, the reconstruction [B, D])."""
    lp, mag, means = _terms(y, m, ss, th, prec)
    vf = valid.to(prec.dtype)
    mf = m.to(prec.dtype)
    r = torch.softmax(lp, dim=-1) * vf[:, None]
    sf = ss.to(prec.dtype)
    rho = (r[..., None] * sf).sum(1)  # [B, H]
    yt = prec.t(y)
    y_rec = torch.where(x, yt, prec.mm(rho, th["W"].T))  # sum_s r W s = W rho
    ym = y_rec if incomplete else yt
    dy = (ym[:, None, :] - means) * mf[:, None, :]
    sums["Fsum"] += (torch.logsumexp(lp, -1) * vf).sum()
    sums["Wp"] += prec.mm(rho.T, ym)
    sums["Wq"] += prec.einsum("bs,bsh,bsk->hk", r, sf, sf)
    sums["pies"] += rho.sum(0)
    sums["sig"] += (r * (dy * dy).sum(-1)).sum()
    sums["N"] += vf.sum()
    sums["sum_d"] += (mf.sum(-1) * vf).sum()
    yo = yt * mf
    sums["y2sum"] += ((yo * yo).sum(-1) * vf).sum()
    return lp, mag, y_rec


def finish(sums: dict, th: dict, prec: Prec, D: int, H: int, incomplete: bool,
           to_learn=PARAMS):
    """(Theta_{t+1} {W, pi, sigma, pies}, F) from the summed rows; a
    parameter not in ``to_learn`` keeps Theta_t's value (pies: pi's)."""
    N, sum_d = sums["N"], sums["sum_d"]
    pi, sigma = th["pi"], th["sigma"]
    new = dict(W=th["W"], pi=pi, sigma=sigma, pies=pi.expand(H).clone())
    if "W" in to_learn:
        new["W"] = prec.mm(equilibrated_inverse(sums["Wq"], RIDGE, prec), sums["Wp"]).T
    if "pi" in to_learn:
        new["pies"] = sums["pies"] / N
        new["pi"] = new["pies"].sum() / H
    if "sigma" in to_learn:
        corr = sum_d * sigma * sigma if incomplete else 0.0
        sigma_new = torch.sqrt((sums["sig"] + corr) / N / D)
        floor = 1e-3 * torch.sqrt(sums["y2sum"] / sum_d.clamp(min=1.0))
        new["sigma"] = torch.maximum(sigma_new, floor)
    log2pis = torch.log(2 * math.pi * sigma * sigma)
    if incomplete:
        ljc = H * torch.log(1 - pi) - log2pis * sum_d / N / 2
    else:
        ljc = H * torch.log(1 - pi) - D / 2 * log2pis
    return new, ljc + sums["Fsum"] / N


def theta0(Y: np.ndarray, seed: int, H: int, to_learn=PARAMS) -> dict:
    """Theta^0 as the algorithm defines it, from the data [N, D] (NaN where
    missing): W = the data mean plus N(0, (sigma/4)^2) drawn by NumPy's
    default_rng(seed), pi = 1/H and pies = pi in every unit.  The mean sums
    the observed entries and divides by N, and sigma is the observed
    entries' RMS deviation from it (on complete data the RMS deviation over
    every entry, as ``reference/bsc.py`` has it)."""
    Y = np.asarray(Y, dtype=np.float64)
    N, D = Y.shape
    m = ~np.isnan(Y)
    y = np.where(m, Y, 0.0)
    mean = (y * m).sum(0) / N
    sigma = np.sqrt((((y - mean) * m) ** 2).sum() / m.sum())
    W = mean[:, None] + np.random.default_rng(seed).normal(scale=sigma / 4.0, size=(D, H))
    return dict(W=W, pi=np.float64(1.0 / H), sigma=np.float64(sigma), pies=np.full(H, 1.0 / H))


def epoch_work(n, u, ea: dict, D: int, incomplete: bool, reconstructs: bool):
    """(the port kernels' calls of one EA epoch as work dicts, the f32
    operations of the epoch's dense products), from the state sets' active
    counts n [nb, B, S] (float64).  On incomplete data the lpj of K^(n) and
    of the children is plain (``lpj_gram`` under G_n), so the one kernel
    is ``bsc_suffstat`` per block; the dense products per block are G_n
    (2 B D H^2), W^T (m y) and ||m y||^2, the lpj of K^(n) and of each
    generation's P C children under G_n (2 H^2 + 4 H a state), the
    reconstruction's means W s, their weighted sum and sigma's residual
    (2 S D H + 5 S D a datapoint) and the W accumulator; then the M-step's
    inverse and product.  Complete data count as ``reference/bsc.py``
    does."""
    if not incomplete:
        return bsc_ref.epoch_work(n, u, ea, D, False, reconstructs)
    nb, B, S = n.shape
    H = ea["H"]
    PC = ea["n_parents"] * ea["n_children"]
    K = S + ea["n_generations"] * PC
    calls = [bounds.bsc_suffstat(n[b], B, S, H) for b in range(nb)]
    per_block = (2 * B * D * H * H + 2 * B * D * H + 3 * B * D
                 + B * K * (2 * H * H + 4 * H)
                 + 2 * B * S * D * H + 5 * B * S * D + 2 * B * H * D)
    dense = nb * per_block + 2 * H**3 + 2 * H * H * D
    return calls, float(dense)
