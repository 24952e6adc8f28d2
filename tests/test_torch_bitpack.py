"""evo_tpu_torch.ops.bitpack against evo_tpu.ops.bitpack: packed words and
dedup keys must be bit-identical (they are compared for equality only, so
no tolerance applies), and the duplicate masks must agree exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from evo_tpu.ops import bitpack as jbp
from evo_tpu_torch.ops import bitpack as tbp


def _u32(t):
    return t.numpy().view(np.uint32)


def _states(H, seed, n=64, K=9, p=0.3):
    rng = np.random.default_rng(seed)
    ss = rng.random((n, K, H)) < p
    ss[0, 0] = False  # all-zero and all-one rows hit the word edges
    ss[0, 1] = True
    return ss


@pytest.mark.parametrize("H", [8, 32, 40, 64, 100, 256])
def test_pack_and_dedup_keys_bit_identical(H):
    ss = _states(H, seed=H)
    t = torch.from_numpy(ss.astype(np.int8))
    np.testing.assert_array_equal(_u32(tbp.pack_states(t)),
                                  np.asarray(jbp.pack_states(jnp.asarray(ss))))
    want = np.asarray(jbp.dedup_keys(jnp.asarray(ss)))
    got = _u32(tbp.dedup_keys(t))
    assert got.shape == want.shape == (64, 9, tbp.n_words(H) if H <= 64 else 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _u32(tbp.dedup_keys(t, exact=True)),
        np.asarray(jbp.dedup_keys(jnp.asarray(ss), exact=True)))


@pytest.mark.parametrize("W", [1, 3, 8])
def test_hash_words_bit_identical(W):
    rng = np.random.default_rng(W)
    words = rng.integers(0, 2**32, size=(50, W), dtype=np.uint64).astype(np.uint32)
    words[0] = 0xFFFFFFFF
    want = np.asarray(jbp.hash_words(jnp.asarray(words)))
    got = _u32(tbp.hash_words(torch.from_numpy(words.view(np.int32))))
    np.testing.assert_array_equal(got, want)


def test_dup_within_first_wins_and_dup_against():
    rng = np.random.default_rng(3)
    H = 40
    base = rng.random((5, H)) < 0.3
    # rows 5..9 repeat rows 0..4 in another order: the first copy is kept
    ss = np.concatenate([base, base[[3, 0, 4, 1, 2]], base[:2]], axis=0)
    t = torch.from_numpy(ss.astype(np.int8))
    keys_t = tbp.dedup_keys(t)
    keys_j = jbp.dedup_keys(jnp.asarray(ss))
    got = tbp.dup_within(keys_t).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbp.dup_within(keys_j)))
    np.testing.assert_array_equal(got, np.arange(len(ss)) >= 5)

    seen = np.concatenate([base[:3], rng.random((4, H)) < 0.3], axis=0)
    valid = np.array([True, False, True, True, True, True, True])
    seen_t = tbp.dedup_keys(torch.from_numpy(seen.astype(np.int8)))
    got = tbp.dup_against(keys_t, seen_t, torch.from_numpy(valid)).numpy()
    want = jbp.dup_against(keys_j, jbp.dedup_keys(jnp.asarray(seen)), jnp.asarray(valid))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got[0] and not got[1] and got[2]  # row 1 matches an invalid entry


def test_batched_dup_matches_vmapped_reference():
    ss = _states(256, seed=11, n=16, K=12, p=0.02)
    ss[:, 6:] = ss[:, :6]
    keys_j = jbp.dedup_keys(jnp.asarray(ss))
    got = tbp.dup_within(tbp.dedup_keys(torch.from_numpy(ss.astype(np.int8)))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.vmap(jbp.dup_within)(keys_j)))


@pytest.mark.parametrize("H", [8, 12, 32, 64, 100, 256])
def test_lane_and_u8_packing_and_packed_keys_bit_identical(H):
    """Lane-major and little-endian byte packing, their unpacking, the host
    packer and dedup_keys_packed (exact words for W8 <= 8 bytes, else the
    hash; and with exact=True) equal evo_tpu's, ragged H included."""
    ss = _states(H, seed=H + 1)
    t = torch.from_numpy(ss.astype(np.int8))
    lane = tbp.pack_bits_lane(t)
    want = np.asarray(jbp.pack_bits_lane(jnp.asarray(ss)))
    assert lane.dtype == torch.uint8 and tuple(lane.shape) == (64, 9, tbp.n_bytes_lane(H))
    np.testing.assert_array_equal(lane.numpy(), want)
    np.testing.assert_array_equal(tbp.pack_bits_lane_host(ss), jbp.pack_bits_lane_host(ss))
    np.testing.assert_array_equal(tbp.pack_bits_lane_host(ss), want)
    np.testing.assert_array_equal(tbp.unpack_bits_lane(lane, H).numpy(), ss)
    u8 = tbp.pack_bits_u8(t)
    np.testing.assert_array_equal(u8.numpy(), np.asarray(jbp.pack_bits_u8(jnp.asarray(ss))))
    np.testing.assert_array_equal(u8.numpy(), np.packbits(ss, axis=-1, bitorder="little"))
    np.testing.assert_array_equal(tbp.unpack_bits_u8(u8, H).numpy(), ss)
    for exact in (False, True):
        got = _u32(tbp.dedup_keys_packed(lane, exact=exact))
        np.testing.assert_array_equal(
            got, np.asarray(jbp.dedup_keys_packed(jnp.asarray(want), exact=exact)))
    assert got.shape[-1] == -(-tbp.n_bytes_lane(H) // 4)
