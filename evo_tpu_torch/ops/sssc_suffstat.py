"""ES3C M-step sufficient statistics of the merged state sets.

Counterpart: evo_tpu/ops/pallas_sssc.py:sssc_suffstat_pallas (complete
data); the CUDA kernel is csrc/sssc_suffstat.cu.  Each merged state s
(slot k of datapoint b, responsibility r = rs[b, k], active set A) is
solved again:

    lambda_A = (s2inv G_AA + Psi_AA^-1)^-1,   kappa_A = s2inv lambda_A u_A + mus_A

with u = s * (Wty[b] - G (s * mus)) and kappa zero outside A; non-finite
entries of kappa and lambda are set to 0.  The outputs are

    xpt_sz[b] = sum_k r kappa        xpt_s[b] = sum_k r s                [B, H]
    xpt_ss    = sum_{b,k} r s s^T    xpt_szsz = sum_{b,k} r (lambda + kappa kappa^T)
    s_sz_outer  = sum_b xpt_s[b] xpt_sz[b]^T
    sz_sz_outer = sum_b xpt_sz[b] xpt_sz[b]^T                           [H, H]

For 64 < H <= 128 a state with more than 16 active units (``overflow_cap``)
has kappa = 0 and no lambda, but its r still counts in xpt_s and xpt_ss, as
in the TPU kernel's popcount buckets.  H > 128 raises.

Incomplete data (counterpart: pallas_sssc.py:_suffstat_pallas_masked; the
CUDA kernel is csrc/sssc_suffstat_masked.cu, ``sssc_suffstat_masked``):
``sssc_suffstat`` dispatches to it when G is a per-datapoint Gram [B, H, H],
as evo_tpu dispatches on G.ndim == 3.  The same solves and outputs under
G_n, for H <= 64 (``MASKED_MAX_H``), where every state is exact.

``sssc_suffstat`` and ``sssc_suffstat_masked`` run the kernel on a CUDA
tensor and the plain version ``sssc_suffstat_plain`` (which takes either
Gram) on a CPU tensor; nothing falls back from one to the other.  The
kernels solve a state with up to ``SPARSE_N`` active units in one thread's
registers and a denser one in a warp, and sum every output in an order
fixed by the data (no float atomics), so they are the same from run to run.
"""

from __future__ import annotations

import functools

import torch

from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops.linalg import pd_inverse_logdet
from evo_tpu_torch.ops.sssc_lpj import (
    MASKED_MAX_H,
    SPARSE_N,
    active_groups,
    check_f32,
    check_states,
    device_scalar,
    gather_sub,
    gram_sub,
    overflow_cap,
)


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


def sssc_suffstat_plain(ss, rs, Wty, G, Psi, mus, s2inv):
    """Plain PyTorch version of both kernels (G [H, H] shared or [B, H, H]
    per datapoint): (xpt_sz, xpt_s, xpt_ss, xpt_szsz, s_sz_outer,
    sz_sz_outer), the states grouped by |s| and inverted by the kernels'
    unpivoted Gauss-Jordan steps, so that a zero pivot leaves the same
    non-finite entries (then 0) here as there."""
    B, S, H = ss.shape
    cap = overflow_cap(H)
    s2inv = torch.as_tensor(s2inv, dtype=Wty.dtype, device=Wty.device)
    rows_ss = ss.reshape(B * S, H)
    r = rs.reshape(B * S)
    kappa = torch.zeros((B * S, H), dtype=Wty.dtype, device=Wty.device)
    # the lambda shares go into H^2 bins by a scatter-add, in f64: at the
    # inpainting path's 3M states, f32 adds per bin came out 3.1e-5 of the
    # largest value off an f64 sum (NVIDIA H100 80GB HBM3, 700 W)
    szsz = torch.zeros(H * H, dtype=torch.float64, device=Wty.device)
    for n, rows, A in active_groups(rows_ss):
        if cap and n > cap:
            continue
        b = rows // S
        a = mus[A]
        G_AA = gram_sub(G, b, A)
        u = Wty[b[:, None], A] - (G_AA @ a[..., None])[..., 0]
        Pinv = pd_inverse_logdet(gather_sub(Psi, A))[0]
        lam = pd_inverse_logdet(s2inv * G_AA + Pinv)[0]
        kappa[rows[:, None], A] = _finite(s2inv * (lam @ u[..., None])[..., 0] + a)
        flat = (A[:, :, None] * H + A[:, None, :]).flatten()
        szsz.index_add_(0, flat, (r[rows, None, None] * _finite(lam)).flatten().double())
    return moments(rows_ss, r, kappa, szsz, B)


def moments(rows_ss, r, kappa, szsz, B):
    """The six statistics from the flat states [B S, H], their
    responsibilities [B S], posterior slab means kappa [B S, H] (zero on
    inactive units) and the lambda shares summed per H^2 bin (f64 [H^2])."""
    H = rows_ss.shape[-1]
    sf = rows_ss.to(kappa.dtype)
    w_s, w_k = r[:, None] * sf, r[:, None] * kappa
    xpt_s = w_s.reshape(B, -1, H).sum(1)
    xpt_sz = w_k.reshape(B, -1, H).sum(1)
    return (xpt_sz, xpt_s, w_s.T @ sf, szsz.reshape(H, H).to(kappa.dtype) + w_k.T @ kappa,
            xpt_s.T @ xpt_sz, xpt_sz.T @ xpt_sz)


def sssc_suffstat(ss, rs, Wty, G, Psi, mus, s2inv):
    """ss: int8 0/1 [B, S, H] merged states; rs: f32 [B, S]
    responsibilities (zero on padding rows); Wty f32 [B, H]; G f32 [H, H],
    or [B, H, H] per datapoint (then ``sssc_suffstat_masked``); Psi f32
    [H, H]; mus f32 [H]; s2inv a float or 0-dim tensor.  Returns (xpt_sz
    [B, H], xpt_s [B, H], xpt_ss, xpt_szsz, s_sz_outer, sz_sz_outer
    [H, H]), all f32."""
    if G.dim() == 3:
        return sssc_suffstat_masked(ss, rs, Wty, G, Psi, mus, s2inv)
    if ss.device.type == "cpu":
        return sssc_suffstat_plain(ss, rs, Wty, G, Psi, mus, s2inv)
    out = _launch("evo_sssc_suffstat", False, ss, rs, Wty, G, Psi, mus, s2inv)
    sssc_suffstat.launches += 1
    return out


sssc_suffstat.launches = 0


def sssc_suffstat_masked(ss, rs, Wty, G, Psi, mus, s2inv):
    """``sssc_suffstat`` under a per-datapoint Gram G f32 [B, H, H]
    (incomplete data), H <= 64."""
    H = ss.shape[-1]
    if H > MASKED_MAX_H:
        raise ValueError(f"masked SSSC kernels cover H <= {MASKED_MAX_H}, got H={H}")
    if ss.device.type == "cpu":
        return sssc_suffstat_plain(ss, rs, Wty, G, Psi, mus, s2inv)
    out = _launch("evo_sssc_suffstat_masked", True, ss, rs, Wty, G, Psi, mus, s2inv)
    sssc_suffstat_masked.launches += 1
    return out


sssc_suffstat_masked.launches = 0


@functools.cache
def _n_blocks(entry, device_index, shape):
    """The kernel's number of blocks G for this shape (B, S, H and, without
    a mask, the cap) on this card; kept, so that a call made while a CUDA
    graph is captured asks the card nothing."""
    with torch.cuda.device(device_index):
        n = _build.entry(entry + "_blocks")(*shape)
    _build.check(-min(n, 0), entry)
    return n


def _launch(entry, masked, ss, rs, Wty, G, Psi, mus, s2inv):
    """Check the inputs and launch one of the two kernels; the shared-Gram
    one also takes the overflow cap."""
    B, S, H = ss.shape
    dev = ss.device
    check_states(entry, ss)
    g_shape = (B, H, H) if masked else (H, H)
    check_f32(entry, dev, ("rs", rs, (B, S)), ("Wty", Wty, (B, H)), ("G", G, g_shape),
              ("Psi", Psi, (H, H)), ("mus", mus, (H,)))
    shape = (B, S, H) if masked else (B, S, H, overflow_cap(H))
    n_blocks = _n_blocks(entry, dev.index, shape)
    scal = device_scalar(s2inv, dev)
    xpt_sz = torch.empty((B, H), dtype=torch.float32, device=dev)
    xpt_s = torch.empty((B, H), dtype=torch.float32, device=dev)
    out = torch.empty((4, H, H), dtype=torch.float32, device=dev)
    # each block's xpt_ss, xpt_szsz and sz_sz_outer triangles and s_sz_outer
    partial = torch.empty((n_blocks, 3 * (H * (H + 1) // 2) + H * H), dtype=torch.float32,
                          device=dev)
    err = _build.entry(entry)(ss.data_ptr(), rs.data_ptr(), Wty.data_ptr(), G.data_ptr(),
                              Psi.data_ptr(), mus.data_ptr(), scal.data_ptr(),
                              xpt_sz.data_ptr(), xpt_s.data_ptr(), out.data_ptr(),
                              partial.data_ptr(), *shape, n_blocks,
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)
    return xpt_sz, xpt_s, out[0], out[1], out[2], out[3]
