"""Packed binary states, their keys and fixed-shape duplicate detection.

Counterpart: evo_tpu/ops/bitpack.py:24-262.  Keys are bit-identical to
evo_tpu's: ``pack_states`` words for H <= 64, the 2-word halfword hash
above.  torch has no full uint32 arithmetic, so the words are computed in
int64 holding values in [0, 2^32) (shifts on such values are logical, and
products are split so that nothing overflows int64), and are handed out as
int32 tensors that carry the uint32 bit patterns: ``keys.numpy().view(
np.uint32)`` gives evo_tpu's values.  Only equality is ever asked of a key.

Unlike evo_tpu's per-datapoint functions, the comparisons here are batched
over any leading dimensions.

The bit-packed state format of ``EAConfig.packed_states`` is evo_tpu's
lane-major uint8 layout: latent l of H lives in byte l mod W8, bit
l div W8, W8 = ceil(H/8) (``pack_bits_lane``), with the pad bits past H
zero.  ``dedup_keys_packed`` keys such states from their bytes; its keys
are compared only with keys of the same function.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

WORD_BITS = 32
_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def n_words(H: int) -> int:
    return -(-H // WORD_BITS)


def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _pack_words64(ss: torch.Tensor) -> torch.Tensor:
    """[..., H] 0/1 states -> int64 [..., ceil(H/32)] word values; bit h of
    word w is latent 32*w + h (little-endian)."""
    H = ss.shape[-1]
    W = n_words(H)
    bits = (ss != 0).to(torch.int64)
    pad = W * WORD_BITS - H
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    weights = torch.ones(WORD_BITS, dtype=torch.int64, device=ss.device) << torch.arange(
        WORD_BITS, device=ss.device)
    return (bits.reshape(bits.shape[:-1] + (W, WORD_BITS)) * weights).sum(-1)


def pack_states(ss: torch.Tensor) -> torch.Tensor:
    """Pack 0/1 states [..., H] into uint32 words [..., ceil(H/32)] (as int32
    bit patterns)."""
    return _as_int32_bits(_pack_words64(ss))


def _mul32(a: torch.Tensor, c) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a, c in [0, 2^32), split into 16-bit halves
    of c so that no product leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(k: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 values in [0, 2^32)."""
    k = k ^ (k >> 16)
    k = _mul32(k, 0x85EBCA6B)
    k = k ^ (k >> 13)
    k = _mul32(k, 0xC2B2AE35)
    return k ^ (k >> 16)


@functools.lru_cache(maxsize=64)
def _halfword_constants(W16: int, device: torch.device) -> tuple:
    """The odd multipliers c1_v, c2_v of evo_tpu's hash_halfwords, made
    once per width and device (some fifty small tensor ops)."""
    i = torch.arange(W16, dtype=torch.int64, device=device)
    c1 = _fmix32(_mul32(i + 1, _GOLDEN)) | 1
    c2 = _fmix32(_mul32(i + 1 + W16, _GOLDEN)) | 1
    return c1, c2


def hash_halfwords(hw: torch.Tensor) -> torch.Tensor:
    """Halfword values [..., W16] (each < 2^16) -> 2 hash words [..., 2]:
    two multilinear sums mod 2^32 with fixed odd constants, each passed
    through the murmur3 finalizer (evo_tpu/ops/bitpack.py:151-207)."""
    c1, c2 = _halfword_constants(hw.shape[-1], hw.device)
    h = hw.to(torch.int64)
    # each product is < 2^48, so the sum over any practical W16 fits int64
    k1 = (h * c1).sum(-1) & _MASK32
    k2 = (h * c2).sum(-1) & _MASK32
    return _as_int32_bits(torch.stack([_fmix32(k1), _fmix32(k2)], dim=-1))


def _hash_words64(words: torch.Tensor) -> torch.Tensor:
    hw = torch.stack([words & 0xFFFF, words >> 16], dim=-1)
    return hash_halfwords(hw.reshape(words.shape[:-1] + (-1,)))


def hash_words(keys: torch.Tensor) -> torch.Tensor:
    """Packed words [..., W] (uint32 bits in int32, or int64 values) -> the
    2-word hash of their little-endian (lo, hi) halfwords."""
    return _hash_words64(keys.to(torch.int64) & _MASK32)


def dedup_keys(ss: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """Duplicate-detection keys for states [..., H]: the exact packed words
    when they fit in 2 (H <= 64) or exact=True, else the 64-bit hash."""
    words = _pack_words64(ss)
    if exact or words.shape[-1] <= 2:
        return _as_int32_bits(words)
    return _hash_words64(words)


def pack_bits_u8(ss: torch.Tensor) -> torch.Tensor:
    """0/1 states [..., H] -> uint8 [..., ceil(H/8)], little bit order (as
    np.packbits(..., bitorder='little')): bit j of byte b is latent 8b + j."""
    H = ss.shape[-1]
    W8 = n_bytes_lane(H)
    bits = torch.nn.functional.pad((ss != 0).to(torch.int32), (0, W8 * 8 - H))
    weights = torch.ones(8, dtype=torch.int32, device=ss.device) << torch.arange(
        8, dtype=torch.int32, device=ss.device)
    return (bits.reshape(bits.shape[:-1] + (W8, 8)) * weights).sum(-1).to(torch.uint8)


def unpack_bits_u8(packed: torch.Tensor, H: int) -> torch.Tensor:
    """uint8 [..., ceil(H/8)] in little bit order -> bool [..., H]."""
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (-1,))[..., :H] != 0


def n_bytes_lane(H: int) -> int:
    return -(-H // 8)


def pack_bits_lane(ss: torch.Tensor) -> torch.Tensor:
    """0/1 states [..., H] -> lane-major packed uint8 [..., ceil(H/8)]."""
    H = ss.shape[-1]
    W8 = n_bytes_lane(H)
    bits = torch.nn.functional.pad((ss != 0).to(torch.int32), (0, W8 * 8 - H))
    weights = (torch.ones(8, dtype=torch.int32, device=ss.device) << torch.arange(
        8, dtype=torch.int32, device=ss.device))[:, None]
    # [..., j, b] holds latent j*W8 + b, which goes to bit j of byte b
    return (bits.reshape(bits.shape[:-1] + (8, W8)) * weights).sum(-2).to(torch.uint8)


def unpack_bits_lane(packed: torch.Tensor, H: int) -> torch.Tensor:
    """Lane-major packed uint8 [..., ceil(H/8)] -> bool [..., H]."""
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)[:, None]
    bits = (packed.to(torch.int32)[..., None, :] >> shifts) & 1  # [..., 8, W8]
    return bits.reshape(packed.shape[:-1] + (-1,))[..., :H] != 0


def pack_bits_lane_host(ss: np.ndarray) -> np.ndarray:
    """NumPy twin of ``pack_bits_lane`` for states made on the host."""
    H = ss.shape[-1]
    W8 = n_bytes_lane(H)
    pad = W8 * 8 - H
    if pad:
        ss = np.concatenate([ss, np.zeros(ss.shape[:-1] + (pad,), ss.dtype)], axis=-1)
    bits = ss.reshape(ss.shape[:-1] + (8, W8)).astype(np.uint8)
    out = np.zeros(ss.shape[:-1] + (W8,), np.uint8)
    for j in range(8):
        out |= bits[..., j, :] << j
    return out


def dedup_keys_packed(packed: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """Keys of lane-major packed states [..., W8] from their bytes: each 4
    bytes (W8 zero-padded to a multiple of 4) make one exact word, little
    endian; more than 2 words are hashed to 2 unless ``exact``.  These
    keys differ from ``dedup_keys`` of the unpacked states, so the two are
    never compared with each other."""
    W8 = packed.shape[-1]
    W4 = -(-W8 // 4)
    b = torch.nn.functional.pad(packed.to(torch.int64), (0, W4 * 4 - W8))
    weights = torch.ones(4, dtype=torch.int64, device=packed.device) << (
        8 * torch.arange(4, dtype=torch.int64, device=packed.device))
    words = (b.reshape(b.shape[:-1] + (W4, 4)) * weights).sum(-1)
    if exact or W4 <= 2:
        return _as_int32_bits(words)
    return _hash_words64(words)


def eq_matrix(keys_a: torch.Tensor, keys_b: torch.Tensor) -> torch.Tensor:
    """All-pairs equality of keys: [..., A, W] x [..., B, W] -> bool [..., A, B]."""
    return (keys_a[..., :, None, :] == keys_b[..., None, :, :]).all(dim=-1)


def dup_within(keys: torch.Tensor) -> torch.Tensor:
    """[..., K, W] -> bool [..., K]: True iff an earlier row holds the same
    key (first occurrence wins, as np.unique's return_index)."""
    K = keys.shape[-2]
    earlier = torch.ones(K, K, dtype=torch.bool, device=keys.device).tril(-1)
    return (eq_matrix(keys, keys) & earlier).any(dim=-1)


def dup_against(keys: torch.Tensor, seen_keys: torch.Tensor,
                seen_valid: torch.Tensor) -> torch.Tensor:
    """[..., K, W] against [..., M, W] with validity [..., M] -> bool
    [..., K]: True iff a key equals any valid seen key."""
    return (eq_matrix(keys, seen_keys) & seen_valid[..., None, :]).any(dim=-1)
