"""BSC M-step sufficient statistics of the merged state sets.

Counterpart: evo_tpu/ops/pallas_suffstat.py:bsc_suffstat_pallas, int8
states and lane-major packed uint8 states; the CUDA kernel is
csrc/bsc_suffstat.cu.  For states ss [B, S, H] (or packed [B, S,
ceil(H/8)] with H given, see ops.bitpack) with responsibilities rs [B, S]:

    rho[b,h] = sum_s rs ss_h,   sabs[b,s] = sum_h ss_h,
    Wq[h,k]  = sum_{b,s} rs ss_h ss_k

``bsc_suffstat`` runs the kernel on a CUDA tensor and the plain version
``bsc_suffstat_plain`` on a CPU tensor; nothing falls back from one to the
other.  The kernel sums only each state's active bits, in an order fixed
by the data (no float atomics), so Wq is the same from run to run and the
int8 and packed modes give bit-identical results; it takes H up to MAX_H.
The mode follows the states' dtype (uint8: packed), and each mode counts
its own launches: ``bsc_suffstat.launches`` (int8),
``bsc_suffstat.packed_launches``.
"""

from __future__ import annotations

import functools

import torch

from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops.bitpack import n_bytes_lane, unpack_bits_lane

MAX_H = 65535  # the kernel lists a row's latents as uint16


def _width(ss, H):
    """H of the states, which packed states must be given."""
    if ss.dtype != torch.uint8:
        return ss.shape[-1] if H is None else H
    if H is None:
        raise ValueError("bsc_suffstat: packed states need H")
    return H


def bsc_suffstat_plain(ss, rs, H: int = None):
    """Plain PyTorch version of the kernel: (rho [B, H], sabs [B, S],
    Wq [H, H]), all f32."""
    H = _width(ss, H)
    if ss.dtype == torch.uint8:
        ss = unpack_bits_lane(ss, H)
    sf = ss.to(rs.dtype)
    w = rs[..., None] * sf
    return w.sum(dim=1), sf.sum(dim=-1), w.reshape(-1, H).T @ sf.reshape(-1, H)


@functools.cache
def _n_chunks(device_index, B, S, H):
    """The kernel's number of chunks G for this shape on this card (the
    same for both modes); kept, so that a call made while a CUDA graph is
    captured asks the card nothing."""
    with torch.cuda.device(device_index):
        n = _build.entry("evo_bsc_suffstat_chunks")(B, S, H)
    _build.check(-min(n, 0), "bsc_suffstat")
    return n


def bsc_suffstat(ss, rs, H: int = None):
    """ss: int8 0/1 [B, S, H] or lane-major packed uint8 [B, S, ceil(H/8)]
    (then H is required); rs: f32 [B, S].  Returns (rho, sabs, Wq)."""
    if ss.device.type == "cpu":
        return bsc_suffstat_plain(ss, rs, H)
    H = _width(ss, H)
    B, S, Win = ss.shape
    dev = ss.device
    packed = ss.dtype == torch.uint8
    if not (packed or ss.dtype == torch.int8):
        raise TypeError(f"bsc_suffstat: states must be int8 or packed uint8, got {ss.dtype}")
    if Win != (n_bytes_lane(H) if packed else H):
        raise ValueError(f"bsc_suffstat: states {tuple(ss.shape)} ({ss.dtype}) do not match "
                         f"H={H}")
    if rs.device != dev or rs.dtype != torch.float32 or tuple(rs.shape) != (B, S):
        raise ValueError(f"bsc_suffstat: rs must be f32 {(B, S)} on {dev}, got "
                         f"{rs.dtype} {tuple(rs.shape)} on {rs.device}")
    if not (ss.is_contiguous() and rs.is_contiguous()):
        raise ValueError("bsc_suffstat: inputs must be contiguous")
    if B * S * H == 0:
        raise ValueError(f"bsc_suffstat: empty shape {tuple(ss.shape)}")
    if H > MAX_H:
        raise ValueError(f"bsc_suffstat: H={H} above the kernel's {MAX_H}")
    n_chunks = _n_chunks(dev.index, B, S, H)
    rho = torch.empty((B, H), dtype=torch.float32, device=dev)
    sabs = torch.empty((B, S), dtype=torch.float32, device=dev)
    wq = torch.empty((H, H), dtype=torch.float32, device=dev)
    # each chunk's part of Wq's packed upper triangle
    partial = torch.empty((n_chunks, H * (H + 1) // 2), dtype=torch.float32, device=dev)
    fn = _build.entry("evo_bsc_suffstat_packed" if packed else "evo_bsc_suffstat")
    err = fn(ss.data_ptr(), rs.data_ptr(), rho.data_ptr(), sabs.data_ptr(),
             wq.data_ptr(), partial.data_ptr(), B, S, H, n_chunks,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "bsc_suffstat")
    if packed:
        bsc_suffstat.packed_launches += 1
    else:
        bsc_suffstat.launches += 1
    return rho, sabs, wq


bsc_suffstat.launches = 0
bsc_suffstat.packed_launches = 0
