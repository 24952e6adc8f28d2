"""The unification merge ``vary_Kn`` in one CUDA kernel, and its plain twin.

No counterpart kernel: evo_tpu's ``vary_Kn`` (evo_tpu/variational/
varykn.py:29-80) is left to XLA, and ``vary_Kn_plain`` is the port's plain
form of it (a cat of both sets, a stable sort, a gather of the rows).  The
kernel, csrc/varykn_merge.cu (``varykn_merge_kernel``), ranks a datapoint's
S old states and T children by counting and copies the S best rows, with
the same results bit for bit: ``_prune_to_mprime``'s mask, the order of
``torch.sort(descending=True, stable=True)`` (an old state wins a tie
against a child; NaN above +inf, -0.0 equal to +0.0), the values' bits as
they came in.

``fits`` is the kernel's envelope, by shape and dtype alone: f32 lpjs, one
1-byte dtype on both row sets (int8 states, lane-major packed uint8 or any
other: the rows are only copied), B, S, W >= 1 and S + T up to
``MAX_CANDIDATES``.  ``variational.varykn.vary_Kn`` launches the kernel on
CUDA tensors inside it and runs the plain twin everywhere else;
``varykn_merge`` raises outside it.  Each launch counts in
``varykn_merge.launches``.
"""

from __future__ import annotations

import torch

from evo_tpu_torch.ops import _build

MAX_CANDIDATES = 1024  # S + T: the kernel's shared memory holds 12 bytes a candidate a warp


def _prune_to_mprime(child_lpj: torch.Tensor, Mprime: int) -> torch.Tensor:
    """[B, T] -> [B, T]: all but the Mprime best children of each row masked
    to -inf.  Every child strictly better than the Mprime-th value stays;
    ties at that value are kept in index order up to Mprime in all."""
    T = child_lpj.shape[-1]
    if Mprime >= T:
        return child_lpj
    kth = torch.sort(child_lpj, dim=-1, descending=True)[0][..., Mprime - 1:Mprime]
    greater = child_lpj > kth
    n_greater = greater.sum(dim=-1, keepdim=True)
    tie = child_lpj == kth
    tie_rank = torch.cumsum(tie.to(torch.int64), dim=-1)  # 1-based among ties
    keep = greater | (tie & (tie_rank <= Mprime - n_greater))
    return torch.where(keep, child_lpj, float("-inf"))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, K, W] gathered at idx [B, M] -> [B, M, W]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def vary_Kn_plain(ss: torch.Tensor, lpj: torch.Tensor, children: torch.Tensor,
                  child_lpj: torch.Tensor, Mprime: int):
    """Plain PyTorch version of the kernel, ``vary_Kn``'s arguments and
    results."""
    S = lpj.shape[-1]
    child_lpj = _prune_to_mprime(child_lpj, Mprime)
    combined = torch.cat([lpj, child_lpj], dim=-1)
    # variational.selection.stable_topk_idx, which this module cannot import
    # (the variational package imports it)
    idx = torch.sort(combined, dim=-1, descending=True, stable=True)[1][..., :S]
    vals = torch.gather(combined, -1, idx)
    ss_new = _rows(torch.cat([ss, children.to(ss.dtype)], dim=1), idx)
    return ss_new, vals, (idx >= S).sum(dim=-1), idx


def fits(ss: torch.Tensor, lpj: torch.Tensor, children: torch.Tensor,
         child_lpj: torch.Tensor) -> bool:
    """Whether the kernel takes this merge (shapes and dtypes only)."""
    if (ss.dim(), lpj.dim(), children.dim(), child_lpj.dim()) != (3, 2, 3, 2):
        return False
    B, S, W = ss.shape
    T = children.shape[1]
    return (lpj.dtype == child_lpj.dtype == torch.float32
            and children.dtype == ss.dtype and ss.element_size() == 1
            and tuple(lpj.shape) == (B, S) and tuple(children.shape) == (B, T, W)
            and tuple(child_lpj.shape) == (B, T)
            and min(B, S, W) >= 1 and S + T <= MAX_CANDIDATES)


def varykn_merge(ss: torch.Tensor, lpj: torch.Tensor, children: torch.Tensor,
                 child_lpj: torch.Tensor, Mprime: int):
    """ss [B, S, W], lpj [B, S], children [B, T, W], child_lpj [B, T] with
    -inf at duplicates, on one CUDA device and inside ``fits``.  Returns
    (ss_new [B, S, W], lpj_new [B, S], n_sub [B], idx [B, S]) as
    ``vary_Kn_plain`` does; idx points into concat(old, children)."""
    if not fits(ss, lpj, children, child_lpj):
        raise ValueError(
            f"varykn_merge: outside the kernel's envelope: states {tuple(ss.shape)} {ss.dtype}, "
            f"lpj {tuple(lpj.shape)} {lpj.dtype}, children {tuple(children.shape)} "
            f"{children.dtype}, child_lpj {tuple(child_lpj.shape)} {child_lpj.dtype} (f32 "
            f"lpjs, one 1-byte dtype, S + T <= {MAX_CANDIDATES})")
    if Mprime < 1:
        raise ValueError(f"varykn_merge: Mprime={Mprime} below 1")
    dev = ss.device
    if dev.type != "cuda" or any(t.device != dev for t in (lpj, children, child_lpj)):
        raise ValueError("varykn_merge: inputs must be on one CUDA device")
    ss, lpj, children, child_lpj = (t.contiguous() for t in (ss, lpj, children, child_lpj))
    B, S, W = ss.shape
    T = children.shape[1]
    ss_new = torch.empty_like(ss)
    vals = torch.empty((B, S), dtype=torch.float32, device=dev)
    n_sub = torch.empty((B,), dtype=torch.int64, device=dev)
    idx = torch.empty((B, S), dtype=torch.int64, device=dev)
    # Mprime >= T masks no child, so the cap (>= T) stands in for a larger one in a C int
    err = _build.entry("evo_varykn_merge")(
        ss.data_ptr(), lpj.data_ptr(), children.data_ptr(), child_lpj.data_ptr(),
        ss_new.data_ptr(), vals.data_ptr(), n_sub.data_ptr(), idx.data_ptr(),
        B, S, T, W, min(int(Mprime), MAX_CANDIDATES), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "varykn_merge")
    varykn_merge.launches += 1
    return ss_new, vals, n_sub, idx


varykn_merge.launches = 0
