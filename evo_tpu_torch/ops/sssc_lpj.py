"""ES3C log-pseudo-joints of candidate states, with the slab marginalized.

Counterpart: evo_tpu/ops/pallas_sssc.py:sssc_lpj_pallas (complete data);
the CUDA kernel is csrc/sssc_lpj.cu.  For a state s of datapoint b with
active set A = {h : s_h = 1}, n = |A|, a = s * mus, Ga = G a and
u = s * (Wty[b] - Ga):

    M'   = I + s2inv * Psi_AA G_AA                      (n x n)
    x    = M'^-1 Psi_AA u_A                             (= lambda_s u)
    lpj  = -1/2 s2inv (y2[b] - 2 a.Wty[b] + a.Ga) + sum_A pil_bar
           - 1/2 log|det M'| + 1/2 s2inv^2 u_A.x

with log|det M'| = log det M_s + log det Psi_s the sum of log|pivot| of an
UNPIVOTED LU of M' in ascending unit order.  ``bad`` is 1 where a pivot is
non-finite or below 1e-6 in magnitude, and such a state's lpj is NaN (never
+-inf: ``reset_lpj`` maps +-inf to the dominant lpj and NaN to the floor).

Widths, as the TPU kernel's modes fix them (Hp = max(8, next_pow2(H))):
every state is exact for H <= 64; for 64 < H <= 128 a state with more than
Hp/8 active units is flagged bad (lpj NaN) without being solved; H > 128
is not supported and raises.

Incomplete data (counterpart: pallas_sssc.py:_lpj_pallas_masked; the CUDA
kernel is csrc/sssc_lpj_masked.cu, ``sssc_lpj_masked``).  ``sssc_lpj``
dispatches to it when G is a per-datapoint Gram G_n = W^T diag(m_n) W
[B, H, H], as evo_tpu dispatches on G.ndim == 3.  Each state is solved as
the TPU kernel's ``_solve_core`` solves it, by two inverses:

    Psi_AA^-1, log det Psi_AA     (unpivoted Gauss-Jordan, ldP)
    lambda = M^-1, log det M      M = s2inv G_n,AA + Psi_AA^-1   (ldM)
    lpj  = base - 1/2 (ldM + ldP) + 1/2 s2inv^2 u_A^T lambda u_A

with the same base and u as above under G_n.  The flag rule is the TPU
kernel's, not the one above: ``bad`` is 1 where Psi_AA^-1 has a
non-finite entry or the assembled lpj is non-finite; a small but finite
pivot is not flagged.  Flagged states get NaN.  Every state is exact, up
to H = ``MASKED_MAX_H`` = 64 (the TPU kernels' Hp <= 64).

``sssc_lpj`` and ``sssc_lpj_masked`` run the kernel on a CUDA tensor and
the plain version (``sssc_lpj_plain``, ``sssc_lpj_masked_plain``) on a
CPU tensor; nothing falls back from one to the other.  Both kernels are
thin entry points over one body, csrc/sssc_lpj.cuh: a thread solves a state
with up to ``SPARSE_N`` active units in registers and a warp a denser
one, each state writing only its own lpj and bad, so the outputs are the
same from run to run.
"""

from __future__ import annotations

import torch

from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops.linalg import pd_inverse_logdet

MAX_H = 128
MASKED_MAX_H = 64
PIVOT_TINY = 1e-6
SPARSE_N = 8  # the SSSC kernels' sparse path: states with up to 8 units, a thread each


def overflow_cap(H: int) -> int:
    """Most active units a state may have before it is flagged bad: none
    (0) for H <= 64, Hp/8 = 16 for 64 < H <= 128.  Raises above 128."""
    if H > MAX_H:
        raise ValueError(f"SSSC kernels cover H <= {MAX_H}, got H={H}")
    return 0 if H <= 64 else 16


def active_groups(ss_rows: torch.Tensor):
    """Rows [R, H] of 0/1 states grouped by their number of active units.
    Yields (n, rows [m], A [m, n]) for every n > 0 present, with each
    row's active units in ascending order."""
    counts = (ss_rows != 0).sum(dim=-1)
    for n in torch.unique(counts).tolist():
        if n == 0:
            continue
        rows = torch.nonzero(counts == n).flatten()
        A = torch.nonzero(ss_rows[rows] != 0)[:, 1].reshape(-1, n)
        yield n, rows, A


def gather_sub(X: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """X[A_i, A_j] per row of A [m, n] -> [m, n, n]."""
    return X[A[:, :, None], A[:, None, :]]


def gram_sub(G: torch.Tensor, b: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """G_AA per row of A [m, n], from the shared Gram [H, H] or from the
    per-datapoint one [B, H, H] of datapoints b [m]."""
    if G.dim() == 2:
        return gather_sub(G, A)
    return G[b[:, None, None], A[:, :, None], A[:, None, :]]


def _lu_unpivoted(M: torch.Tensor):
    """Unpivoted LU of a batch [m, n, n]: the packed factors (unit L below
    the diagonal, U on and above) and the pivots."""
    M = M.clone()
    n = M.shape[-1]
    for k in range(n - 1):
        col = M[:, k + 1:, k] * (1.0 / M[:, k, k])[:, None]
        M[:, k + 1:, k] = col
        M[:, k + 1:, k + 1:] -= col[:, :, None] * M[:, k, None, k + 1:]
    return M, torch.diagonal(M, dim1=-2, dim2=-1)


def sssc_lpj_plain(ss, Wty, y2, G, Psi, mus, pil_bar, s2inv):
    """Plain PyTorch version of the kernel (same arguments and results):
    the states are grouped by |s| and each group solved as one batch."""
    B, K, H = ss.shape
    cap = overflow_cap(H)
    s2inv = torch.as_tensor(s2inv, dtype=Wty.dtype, device=Wty.device)
    rows_ss = ss.reshape(B * K, H)
    b_of = torch.arange(B * K, device=ss.device) // K
    lpj = (-0.5 * s2inv * y2[b_of]).clone()  # the empty state
    bad = torch.zeros(B * K, dtype=Wty.dtype, device=Wty.device)
    for n, rows, A in active_groups(rows_ss):
        if cap and n > cap:
            lpj[rows], bad[rows] = float("nan"), 1.0
            continue
        b = b_of[rows]
        a = mus[A]
        G_AA, Psi_AA = gather_sub(G, A), gather_sub(Psi, A)
        wty = Wty[b[:, None], A]
        Ga = (G_AA @ a[..., None])[..., 0]
        u = wty - Ga
        base = (-0.5 * s2inv * (y2[b] - 2.0 * (a * wty).sum(-1) + (a * Ga).sum(-1))
                + pil_bar[A].sum(-1))
        Mp = torch.eye(n, dtype=G.dtype, device=G.device) + s2inv * (Psi_AA @ G_AA)
        LU, piv = _lu_unpivoted(Mp)
        rhs = Psi_AA @ u[..., None]
        y = torch.linalg.solve_triangular(LU, rhs, upper=False, unitriangular=True)
        x = torch.linalg.solve_triangular(LU, y, upper=True)[..., 0]
        val = base - 0.5 * torch.log(piv.abs()).sum(-1) + 0.5 * s2inv * s2inv * (u * x).sum(-1)
        flag = ((piv.abs() < PIVOT_TINY) | ~torch.isfinite(piv)).any(-1)
        lpj[rows] = torch.where(flag, float("nan"), val)
        bad[rows] = flag.to(bad.dtype)
    return lpj.reshape(B, K), bad.reshape(B, K)


def sssc_lpj_masked_plain(ss, Wty, y2, G, Psi, mus, pil_bar, s2inv):
    """Plain PyTorch version of the masked kernel (same arguments and
    results, G the per-datapoint Gram [B, H, H]): the states grouped by |s|,
    each group inverted by the kernel's Gauss-Jordan steps."""
    B, K, H = ss.shape
    s2inv = torch.as_tensor(s2inv, dtype=Wty.dtype, device=Wty.device)
    rows_ss = ss.reshape(B * K, H)
    b_of = torch.arange(B * K, device=ss.device) // K
    lpj = (-0.5 * s2inv * y2[b_of]).clone()  # the empty state
    bad = torch.zeros(B * K, dtype=Wty.dtype, device=Wty.device)
    for n, rows, A in active_groups(rows_ss):
        b = b_of[rows]
        a = mus[A]
        G_AA = gram_sub(G, b, A)
        wty = Wty[b[:, None], A]
        Ga = (G_AA @ a[..., None])[..., 0]
        u = wty - Ga
        base = (-0.5 * s2inv * (y2[b] - 2.0 * (a * wty).sum(-1) + (a * Ga).sum(-1))
                + pil_bar[A].sum(-1))
        Pinv, ldP = pd_inverse_logdet(gather_sub(Psi, A))
        lam, ldM = pd_inverse_logdet(s2inv * G_AA + Pinv)
        quad = (u * (lam @ u[..., None])[..., 0]).sum(-1)
        val = base - 0.5 * (ldM + ldP) + 0.5 * s2inv * s2inv * quad
        flag = ~torch.isfinite(Pinv).flatten(1).all(-1) | ~torch.isfinite(val)
        lpj[rows] = torch.where(flag, float("nan"), val)
        bad[rows] = flag.to(bad.dtype)
    return lpj.reshape(B, K), bad.reshape(B, K)


def device_scalar(x, device) -> torch.Tensor:
    """A scalar as a 0-dim f32 tensor on ``device`` (no host sync)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(())


def check_f32(fn_name, dev, *specs):
    """Raise unless each (name, tensor, shape) is a contiguous f32 tensor
    of that shape on ``dev``."""
    for key, t, shape in specs:
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{fn_name}: {key} must be f32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn_name}: {key} must be contiguous")


def check_states(fn_name, ss):
    if ss.dtype != torch.int8 or not ss.is_contiguous():
        raise TypeError(f"{fn_name}: states must be contiguous int8, got {ss.dtype}")
    if ss.numel() == 0:
        raise ValueError(f"{fn_name}: empty shape {tuple(ss.shape)}")


def sssc_lpj(ss, Wty, y2, G, Psi, mus, pil_bar, s2inv):
    """(lpj [B, K], bad [B, K]) f32.  ss: int8 0/1 [B, K, H]; Wty f32
    [B, H]; y2 f32 [B]; G f32 [H, H], or [B, H, H] per datapoint (then
    ``sssc_lpj_masked``); Psi f32 [H, H]; mus, pil_bar f32 [H]; s2inv a
    float or 0-dim tensor."""
    if G.dim() == 3:
        return sssc_lpj_masked(ss, Wty, y2, G, Psi, mus, pil_bar, s2inv)
    if ss.device.type == "cpu":
        return sssc_lpj_plain(ss, Wty, y2, G, Psi, mus, pil_bar, s2inv)
    B, K, H = ss.shape
    dev = ss.device
    check_states("sssc_lpj", ss)
    check_f32("sssc_lpj", dev, ("Wty", Wty, (B, H)), ("y2", y2, (B,)), ("G", G, (H, H)),
              ("Psi", Psi, (H, H)), ("mus", mus, (H,)), ("pil_bar", pil_bar, (H,)))
    cap = overflow_cap(H)
    scal = device_scalar(s2inv, dev)
    lpj = torch.empty((B, K), dtype=torch.float32, device=dev)
    bad = torch.empty((B, K), dtype=torch.float32, device=dev)
    fn = _build.entry("evo_sssc_lpj")
    err = fn(ss.data_ptr(), Wty.data_ptr(), y2.data_ptr(), G.data_ptr(), Psi.data_ptr(),
             mus.data_ptr(), pil_bar.data_ptr(), scal.data_ptr(), lpj.data_ptr(),
             bad.data_ptr(), B, K, H, cap, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "sssc_lpj")
    sssc_lpj.launches += 1
    return lpj, bad


sssc_lpj.launches = 0


def sssc_lpj_masked(ss, Wty, y2, G, Psi, mus, pil_bar, s2inv):
    """``sssc_lpj`` under a per-datapoint Gram G f32 [B, H, H] (incomplete
    data), H <= 64."""
    B, K, H = ss.shape
    if H > MASKED_MAX_H:
        raise ValueError(f"masked SSSC kernels cover H <= {MASKED_MAX_H}, got H={H}")
    if ss.device.type == "cpu":
        return sssc_lpj_masked_plain(ss, Wty, y2, G, Psi, mus, pil_bar, s2inv)
    dev = ss.device
    check_states("sssc_lpj_masked", ss)
    check_f32("sssc_lpj_masked", dev, ("Wty", Wty, (B, H)), ("y2", y2, (B,)),
              ("G", G, (B, H, H)), ("Psi", Psi, (H, H)), ("mus", mus, (H,)),
              ("pil_bar", pil_bar, (H,)))
    scal = device_scalar(s2inv, dev)
    lpj = torch.empty((B, K), dtype=torch.float32, device=dev)
    bad = torch.empty((B, K), dtype=torch.float32, device=dev)
    fn = _build.entry("evo_sssc_lpj_masked")
    err = fn(ss.data_ptr(), Wty.data_ptr(), y2.data_ptr(), G.data_ptr(), Psi.data_ptr(),
             mus.data_ptr(), pil_bar.data_ptr(), scal.data_ptr(), lpj.data_ptr(),
             bad.data_ptr(), B, K, H, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "sssc_lpj_masked")
    sssc_lpj_masked.launches += 1
    return lpj, bad


sssc_lpj_masked.launches = 0
