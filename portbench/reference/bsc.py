"""Plain reference of one EBSC (binary sparse coding) EM epoch, complete data.

Generative model: s_h ~ Bernoulli(pi), y = W s + N(0, sigma^2 I), W [D, H].
Given the parameters Theta_t that an epoch starts from and the state sets
K^(n) that its E-step kept, the epoch has to produce

  lpj(s) = -||y - W s||^2 / (2 sigma^2) + |s| log(pi / (1 - pi))
  F      = H log(1 - pi) - D/2 log(2 pi sigma^2) + 1/N sum_n logsumexp_s lpj
  r      = softmax_s lpj   (the truncated posterior)
  W      = (sum_n y_n <s>_n^T) (sum_n <s s^T>_n)^-1
  pies   = 1/N sum_n <s>_n,  pi = mean_h pies_h
  sigma  = sqrt(1/(N D) sum_n <||y_n - W_t s||^2>_n)

with the guards the algorithm states: Theta_t clamped first (pi in
[1e-5, 1 - 1e-5], sigma >= 1e-5), W's inverse taken with a relative ridge
of 1e-6 of the mean diagonal after Jacobi equilibration, and sigma floored
at 1e-3 of the data's RMS.  The residual is taken directly (y - W s), not
in the Gram form the program uses.  Sums run over blocks of datapoints, so
that a block's [B, S, D] products fit; under several ranks each rank sums
its rows and the sums are added before ``finish``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import bounds
from portbench.reference.precision import Prec

PARAM_TOL = 1e-5
RIDGE = 1e-6
PARAMS = ("W", "pi", "sigma", "pies")


def checked(th: dict, prec: Prec) -> dict:
    return dict(W=prec.t(th["W"]), pi=prec.t(th["pi"]).clamp(PARAM_TOL, 1 - PARAM_TOL),
                sigma=prec.t(th["sigma"]).clamp(min=PARAM_TOL))


def lpj(y, ss, th, prec: Prec):
    """(lpj [B, S], magnitude [B, S], squared residual [B, S]) of states
    ss [B, S, H] for data rows y [B, D] under checked parameters.  The
    magnitude is the size of the terms the program's Gram form adds, |pre1|
    (||y||^2 + 2 |s.W^T y| + s^T W^T W s) + |log(pi/(1-pi))| |s|, which its
    rounding scales with."""
    W = th["W"]
    sf = ss.to(prec.dtype)
    y = prec.t(y)
    res = y[:, None, :] - prec.mm(sf, W.T)
    r2 = (res * res).sum(-1)
    pre1 = -0.5 / th["sigma"] ** 2
    pil = torch.log(th["pi"] / (1 - th["pi"]))
    nbits = sf.sum(-1)
    with torch.no_grad():
        Ws = sf @ W.T
        mag = (pre1.abs() * ((y * y).sum(-1)[:, None] + 2 * (Ws * y[:, None, :]).sum(-1).abs()
                             + (Ws * Ws).sum(-1)) + pil.abs() * nbits)
    return pre1 * r2 + pil * nbits, mag, r2


def zero_sums(D: int, H: int, prec: Prec, device) -> dict:
    z = dict(dtype=prec.dtype, device=device)
    return dict(Wp=torch.zeros(H, D, **z), Wq=torch.zeros(H, H, **z),
                pies=torch.zeros(H, **z), sig=torch.zeros((), **z),
                Fsum=torch.zeros((), **z), N=torch.zeros((), **z),
                y2sum=torch.zeros((), **z))


def block(sums: dict, y, valid, ss, th, prec: Prec):
    """Add one block of rows (y [B, D], valid [B] bool, states [B, S, H])
    to the sums; returns (lpj, magnitude) of its states."""
    lp, mag, r2 = lpj(y, ss, th, prec)
    vf = valid.to(prec.dtype)
    r = torch.softmax(lp, dim=-1) * vf[:, None]
    sf = ss.to(prec.dtype)
    rho = (r[..., None] * sf).sum(1)  # [B, H]
    yt = prec.t(y)
    sums["Fsum"] += (torch.logsumexp(lp, -1) * vf).sum()
    sums["Wp"] += prec.mm(rho.T, yt)
    sums["Wq"] += prec.einsum("bs,bsh,bsk->hk", r, sf, sf)
    sums["pies"] += rho.sum(0)
    sums["sig"] += (r * r2).sum()
    sums["N"] += vf.sum()
    sums["y2sum"] += ((yt * yt).sum(-1) * vf).sum()
    return lp, mag


def equilibrated_inverse(A, rel_ridge: float, prec: Prec):
    H = A.shape[-1]
    eye = torch.eye(H, dtype=A.dtype, device=A.device)
    diag = torch.diagonal(A)
    if rel_ridge:
        ridge = rel_ridge * diag.mean()
        A, diag = A + ridge * eye, diag + ridge
    d = 1.0 / torch.sqrt(diag.clamp(min=torch.finfo(A.dtype).tiny))
    return torch.linalg.inv(A * d[:, None] * d[None, :]) * d[:, None] * d[None, :]


def finish(sums: dict, th: dict, prec: Prec, D: int, H: int):
    """(Theta_{t+1} {W, pi, sigma, pies}, F) from the summed blocks."""
    N = sums["N"]
    W = prec.mm(equilibrated_inverse(sums["Wq"], RIDGE, prec), sums["Wp"]).T
    pies = sums["pies"] / N
    sigma_new = torch.sqrt(sums["sig"] / N / D)
    floor = 1e-3 * torch.sqrt(sums["y2sum"] / (N * D))
    pi, sigma = th["pi"], th["sigma"]
    ljc = H * torch.log(1 - pi) - D / 2 * torch.log(2 * math.pi * sigma * sigma)
    F = ljc + sums["Fsum"] / N
    return dict(W=W, pi=pies.sum() / H, sigma=torch.maximum(sigma_new, floor), pies=pies), F


def theta0(Y: np.ndarray, seed: int, H: int) -> dict:
    """Theta^0 of complete data, as the algorithm defines it: W = the data
    mean plus N(0, (sigma/4)^2) drawn by NumPy's default_rng(seed), with
    sigma the data's RMS deviation from its mean; pi = 1/H."""
    Y = np.asarray(Y, dtype=np.float64)
    D = Y.shape[1]
    mean = Y.mean(0)
    sigma = np.sqrt(((Y - mean) ** 2).mean(0).sum() / D)
    W = mean[:, None] + np.random.default_rng(seed).normal(scale=sigma / 4.0, size=(D, H))
    return dict(W=W, pi=np.float64(1.0 / H), sigma=np.float64(sigma))


def epoch_work(n, u, ea: dict, D: int, incomplete: bool, reconstructs: bool):
    """(the port kernels' calls of one EA epoch as work dicts, the f32
    operations of the epoch's dense products), from the state sets' active
    counts n [nb, B, S] (float64): per block the lpj of K^(n), of each
    generation's P C children (at the block's mean active count) and the
    suffstat of the kept sets; the dense products are G = W^T W, W^T y,
    ||y||^2 and the W accumulator per block, the inverse and product of
    the W update."""
    if incomplete or reconstructs:
        raise NotImplementedError("the EBSC reference covers complete data without "
                                  "reconstruction")
    nb, B, S = n.shape
    H = ea["H"]
    PC = ea["n_parents"] * ea["n_children"]
    calls = []
    for b in range(nb):
        nbar = float(n[b].mean())
        calls.append(bounds.bsc_lpj(n[b], B, S, H))
        for _ in range(ea["n_generations"]):
            calls.append(bounds.bsc_lpj(torch.full((B * PC,), nbar, dtype=torch.float64), B, PC, H))
        calls.append(bounds.bsc_suffstat(n[b], B, S, H))
    dense = nb * (2 * D * H * H + 4 * B * D * H + 2 * B * D) + 2 * H**3 + 2 * H * H * D
    return calls, float(dense)
