"""The port's lpj (its plain PyTorch version, which the CUDA kernel is held
to on the card) against evo_tpu's Pallas kernel in interpret mode, in both
``emit_keys`` modes, on int8 and on lane-major packed uint8 states; the
int8 cases include a ragged H = 100 and the density extremes that the
kernel's card checks use (states with no bit or every bit on).

Tolerance: both sides compute the same f32 Gram-form sum in different
orders, so each lpj may differ by a few f32 roundings of the magnitudes it
sums: 1e-5 * (|pre1| (y2 + 2|s.Wty| + s^T G s) + |pil_bar| |s|), elementwise.
Keys are compared for equality only, so they must be bit-identical.  On
packed states the port's lpj and keys are bit-identical to its own on the
unpacked states, and the keys are ``dedup_keys`` of the unpacked states, as
evo_tpu's packed kernel emits them.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from evo_tpu.ops.bitpack import dedup_keys, pack_bits_lane_host
from evo_tpu.ops.pallas_lpj import bsc_lpj_pallas
from evo_tpu_torch.ops.bsc_lpj import bsc_lpj, key_words

PRE1, PIL = -0.4, -1.5


def _problem(H, B, K, p, seed, fill=None):
    """Random states at density p with one dense row, or with fill
    "no bit on" / "every bit on" states that have none or all of their bits
    on."""
    rng = np.random.default_rng(seed)
    ss = (rng.random((B, K, H)) < p).astype(np.int8)
    ss[0, 0] = 1  # a dense row
    if fill is not None:
        ss[:] = {"no bit on": 0, "every bit on": 1}[fill]
    W = rng.standard_normal((H, H)).astype(np.float32)
    G = W.T @ W
    Wty = (rng.standard_normal((B, H)) * 3).astype(np.float32)
    y2 = (rng.random(B) * 50 + 10).astype(np.float32)
    return ss, Wty, y2, G


def _scale(ss, Wty, y2, G):
    sf = ss.astype(np.float64)
    sGs = np.einsum("bkh,hj,bkj->bk", sf, G.astype(np.float64), sf)
    sW = np.abs(np.einsum("bkh,bh->bk", sf, Wty.astype(np.float64)))
    return abs(PRE1) * (y2[:, None] + 2 * sW + sGs) + abs(PIL) * sf.sum(-1)


@pytest.mark.parametrize("H,fill", [
    pytest.param(40, None, id="40"), pytest.param(64, None, id="64"),
    pytest.param(256, None, id="256"), pytest.param(100, None, id="100"),  # ragged H
    *(pytest.param(H, fill, id=f"{H}-{fill.replace(' ', '_')}")
      for H in (40, 256) for fill in ("no bit on", "every bit on")),
])
@pytest.mark.parametrize("emit_keys", [False, True])
def test_plain_lpj_matches_pallas_interpret(H, fill, emit_keys):
    ss, Wty, y2, G = _problem(H, B=128, K=10, p=0.15, seed=H, fill=fill)
    want = bsc_lpj_pallas(jnp.asarray(ss), jnp.asarray(Wty), jnp.asarray(y2),
                          jnp.asarray(G), jnp.float32(PRE1), jnp.float32(PIL),
                          interpret=True, emit_keys=emit_keys)
    got = bsc_lpj(*(torch.from_numpy(a) for a in (ss, Wty, y2, G)),
                  torch.tensor(PRE1), torch.tensor(PIL), emit_keys=emit_keys)
    if emit_keys:
        (got, got_keys), (want, want_keys) = got, want
        assert got_keys.shape == (128, 10, key_words(H))
        np.testing.assert_array_equal(got_keys.numpy().view(np.uint32),
                                      np.asarray(want_keys))
        np.testing.assert_array_equal(got_keys.numpy().view(np.uint32),
                                      np.asarray(dedup_keys(jnp.asarray(ss))))
    err = np.abs(got.numpy().astype(np.float64) - np.asarray(want))
    assert (err <= 1e-5 * _scale(ss, Wty, y2, G)).all(), err.max()


@pytest.mark.parametrize("H", [32, 256])
@pytest.mark.parametrize("emit_keys", [False, True])
def test_plain_lpj_packed_matches_pallas_interpret(H, emit_keys):
    ss, Wty, y2, G = _problem(H, B=128, K=10, p=0.15, seed=H + 1)
    pk = pack_bits_lane_host(ss)
    want = bsc_lpj_pallas(jnp.asarray(pk), jnp.asarray(Wty), jnp.asarray(y2),
                          jnp.asarray(G), jnp.float32(PRE1), jnp.float32(PIL),
                          interpret=True, emit_keys=emit_keys)
    args = [torch.from_numpy(a) for a in (Wty, y2, G)] + [torch.tensor(PRE1), torch.tensor(PIL)]
    got = bsc_lpj(torch.from_numpy(pk), *args, emit_keys=emit_keys)
    unpacked = bsc_lpj(torch.from_numpy(ss), *args, emit_keys=emit_keys)
    if emit_keys:
        (got, got_keys), (want, want_keys), (unpacked, unpacked_keys) = got, want, unpacked
        np.testing.assert_array_equal(got_keys.numpy().view(np.uint32), np.asarray(want_keys))
        np.testing.assert_array_equal(got_keys.numpy(), unpacked_keys.numpy())
        np.testing.assert_array_equal(got_keys.numpy().view(np.uint32),
                                      np.asarray(dedup_keys(jnp.asarray(ss))))
    np.testing.assert_array_equal(got.numpy(), unpacked.numpy())
    err = np.abs(got.numpy().astype(np.float64) - np.asarray(want))
    assert (err <= 1e-5 * _scale(ss, Wty, y2, G)).all(), err.max()
