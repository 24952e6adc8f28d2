"""BSC log-pseudo-joints of candidate states, with optional dedup keys.

Counterpart: evo_tpu/ops/pallas_lpj.py:bsc_lpj_pallas, int8 states and
lane-major packed uint8 states, both ``emit_keys`` modes; the CUDA kernel
is csrc/bsc_lpj.cu.  For states ss [B, K, H] (or packed [B, K, ceil(H/8)],
see ops.bitpack) of datapoints with Wty [B, H] and y2 [B] under the shared
Gram G [H, H]:

    lpj[b,k] = pre1 * (y2[b] - 2 s.Wty[b] + s^T G s) + pil_bar * |s|

The kernel sums only what each state's active latents select: s^T G s
over the pairs of active latents, s.Wty over the active latents, |s| by
popcount.

With ``emit_keys`` it also returns the dedup keys [B, K, W] of
``ops.bitpack.dedup_keys`` of the unpacked states (uint32 bit patterns in
int32): W = ceil(H/32) exact words for H <= 64, else the 2-word hash.  As
in evo_tpu, packed input gives the keys of the unpacked states, not
``dedup_keys_packed``.

``bsc_lpj`` runs the kernel on a CUDA tensor and the plain version
``bsc_lpj_plain`` on a CPU tensor; nothing falls back from one to the other.
The mode follows the states' dtype (uint8: packed), and each mode counts
its own launches: ``bsc_lpj.launches`` (int8), ``bsc_lpj.packed_launches``.
"""

from __future__ import annotations

import torch

from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops.bitpack import dedup_keys, n_bytes_lane, n_words, unpack_bits_lane

MAX_H = 1024  # the kernel keeps a state's mask in at most 32 words, one a lane of a warp


def key_words(H: int) -> int:
    return n_words(H) if H <= 64 else 2


def _scal(pre1, pil_bar, device) -> torch.Tensor:
    """[pre1, pil_bar] as an f32 tensor on ``device`` (no host sync)."""
    return torch.stack([torch.as_tensor(pre1, dtype=torch.float32, device=device),
                        torch.as_tensor(pil_bar, dtype=torch.float32, device=device)])


def bsc_lpj_plain(ss, Wty, y2, G, pre1, pil_bar, emit_keys: bool = False):
    """Plain PyTorch version of the kernel (same arguments and results)."""
    if ss.dtype == torch.uint8:
        ss = unpack_bits_lane(ss, G.shape[0]).to(torch.int8)
    scal = _scal(pre1, pil_bar, ss.device)
    sf = ss.to(Wty.dtype)
    sGs = ((sf @ G) * sf).sum(dim=-1)
    sWty = (sf * Wty[:, None, :]).sum(dim=-1)
    lpj = scal[0] * (y2[:, None] - 2.0 * sWty + sGs) + scal[1] * sf.sum(dim=-1)
    return (lpj, dedup_keys(ss)) if emit_keys else lpj


def bsc_lpj(ss, Wty, y2, G, pre1, pil_bar, emit_keys: bool = False):
    """lpj [B, K] f32 (and keys [B, K, W] with emit_keys).  ss: int8 0/1
    [B, K, H] or lane-major packed uint8 [B, K, ceil(H/8)]; Wty f32 [B, H];
    y2 f32 [B]; G f32 [H, H]; pre1 and pil_bar scalars (floats or 0-dim
    tensors)."""
    if ss.device.type == "cpu":
        return bsc_lpj_plain(ss, Wty, y2, G, pre1, pil_bar, emit_keys)
    B, K, Win = ss.shape
    H = G.shape[0]
    dev = ss.device
    packed = ss.dtype == torch.uint8
    if not (packed or ss.dtype == torch.int8):
        raise TypeError(f"bsc_lpj: states must be int8 or packed uint8, got {ss.dtype}")
    if Win != (n_bytes_lane(H) if packed else H):
        raise ValueError(f"bsc_lpj: states {tuple(ss.shape)} ({ss.dtype}) do not match H={H}")
    for name, t, shape in (("Wty", Wty, (B, H)), ("y2", y2, (B,)), ("G", G, (H, H))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"bsc_lpj: {name} must be f32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not all(t.is_contiguous() for t in (ss, Wty, y2, G)):
        raise ValueError("bsc_lpj: inputs must be contiguous")
    if not (H <= MAX_H and B * K > 0):
        raise ValueError(f"bsc_lpj: unsupported shape {tuple(ss.shape)}")
    scal = _scal(pre1, pil_bar, dev)
    lpj = torch.empty((B, K), dtype=torch.float32, device=dev)
    keys = (torch.empty((B, K, key_words(H)), dtype=torch.int32, device=dev)
            if emit_keys else None)
    fn = _build.entry("evo_bsc_lpj_packed" if packed else "evo_bsc_lpj")
    err = fn(ss.data_ptr(), Wty.data_ptr(), y2.data_ptr(), G.data_ptr(),
             scal.data_ptr(), lpj.data_ptr(), keys.data_ptr() if emit_keys else None,
             B, K, H, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "bsc_lpj")
    if packed:
        bsc_lpj.packed_launches += 1
    else:
        bsc_lpj.launches += 1
    return (lpj, keys) if emit_keys else lpj


bsc_lpj.launches = 0
bsc_lpj.packed_launches = 0
