"""The port's sufficient statistics (their plain PyTorch version, which the
CUDA kernel is held to on the card) against evo_tpu's Pallas kernel in
interpret mode, on int8 and on lane-major packed uint8 states.  rho and Wq
are f32 sums of non-negative terms taken in different orders: relative
1e-5.  sabs counts 0/1 values: exact.  On packed states the port's results
are bit-identical to its own on the unpacked states."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from evo_tpu.ops.bitpack import pack_bits_lane_host
from evo_tpu.ops.pallas_suffstat import bsc_suffstat_pallas
from evo_tpu_torch.ops.bsc_suffstat import bsc_suffstat


@pytest.mark.parametrize("H,S", [(256, 12), (100, 16)])
def test_plain_suffstat_matches_pallas_interpret(H, S):
    B = 128
    rng = np.random.default_rng(H)
    ss = (rng.random((B, S, H)) < 0.1).astype(np.int8)
    r = rng.random((B, S)).astype(np.float32)
    rs = (r / r.sum(1, keepdims=True)).astype(np.float32)
    want = bsc_suffstat_pallas(jnp.asarray(ss), jnp.asarray(rs), H=H, interpret=True)
    got = bsc_suffstat(torch.from_numpy(ss), torch.from_numpy(rs))
    rho, sabs, wq = (g.numpy() for g in got)
    np.testing.assert_allclose(rho, np.asarray(want[0]), rtol=1e-5, atol=0)
    np.testing.assert_array_equal(sabs, np.asarray(want[1]))
    np.testing.assert_allclose(wq, np.asarray(want[2]), rtol=1e-5, atol=0)
    assert wq.shape == (H, H) and rho.shape == (B, H) and sabs.shape == (B, S)


@pytest.mark.parametrize("H,S", [(32, 12), (256, 12)])
def test_plain_suffstat_packed_matches_pallas_interpret(H, S):
    B = 128
    rng = np.random.default_rng(H + 1)
    ss = (rng.random((B, S, H)) < 0.1).astype(np.int8)
    r = rng.random((B, S)).astype(np.float32)
    rs = (r / r.sum(1, keepdims=True)).astype(np.float32)
    pk = pack_bits_lane_host(ss)
    want = bsc_suffstat_pallas(jnp.asarray(pk), jnp.asarray(rs), H=H, interpret=True)
    got = bsc_suffstat(torch.from_numpy(pk), torch.from_numpy(rs), H=H)
    unpacked = bsc_suffstat(torch.from_numpy(ss), torch.from_numpy(rs))
    for g, u in zip(got, unpacked):
        np.testing.assert_array_equal(g.numpy(), u.numpy())
    rho, sabs, wq = (g.numpy() for g in got)
    np.testing.assert_allclose(rho, np.asarray(want[0]), rtol=1e-5, atol=0)
    np.testing.assert_array_equal(sabs, np.asarray(want[1]))
    np.testing.assert_allclose(wq, np.asarray(want[2]), rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="need H"):
        bsc_suffstat(torch.from_numpy(pk), torch.from_numpy(rs))


def _edge_case(case, packed):
    """(int8 states [B, S, H], responsibilities [B, S], Pallas block_rows) of
    one end of the density range the CUDA kernel handles apart.  The ragged
    width is H = 100, or 104 for packed states (evo_tpu's packed kernel
    unpacks 8 ceil(H/8) latents, so it takes H a multiple of 8 only).
    EA-converged states (the kernel's skewed case): each datapoint's 64
    unique states are one- and two-bit flips of its own 2-unit core, so its
    core units are on in most of its rows."""
    rng = np.random.default_rng(len(case))
    B, S, H, block_rows = 64, 8, 40, 64
    if case == "ragged_H":
        H = 104 if packed else 100
    elif case == "B_not_multiple_of_block_rows":
        B, block_rows = 72, 8
    ss = (rng.random((B, S, H)) < 2.0 / H).astype(np.int8)
    if case == "no_bit":
        ss[:] = 0
    elif case == "every_bit":
        ss[:] = 1
    elif case == "one_dense_row":
        H = 256
        ss = (rng.random((B, S, H)) < 2.0 / H).astype(np.int8)
        ss[5, 3] = rng.random(H) < 0.5
    elif case in ("ragged_H", "B_not_multiple_of_block_rows"):
        ss = (rng.random((B, S, H)) < rng.random((B, 1, 1))).astype(np.int8)
    elif case == "ea_converged":
        S, half = 64, 32
        core = np.zeros((B, H), np.int8)
        np.put_along_axis(core, np.argsort(rng.random((B, H)), 1)[:, :2], 1, 1)
        q = np.argsort(rng.random((B, H)), 1)  # the flipped units, in this order
        flips = np.zeros((B, S, H), np.int8)
        b, j = np.arange(B)[:, None], np.arange(half)
        flips[b, j, q[:, j]] = 1
        flips[b, half + j, q[:, j]] = 1
        flips[b, half + j, q[:, j + 1]] = 1
        ss = core[:, None, :] ^ flips
    r = rng.random((B, S)).astype(np.float32)
    rs = (r / r.sum(1, keepdims=True)).astype(np.float32)
    if case == "rs_exactly_0":
        rs[::3] = 0.0  # invalid datapoints
        rs[:, S // 2:] = 0.0  # the softmax's underflowed tail
        ss = (rng.random((B, S, H)) < 0.3).astype(np.int8)
    return ss, rs, block_rows


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])
@pytest.mark.parametrize("case", ["no_bit", "every_bit", "one_dense_row", "ragged_H",
                                  "B_not_multiple_of_block_rows", "rs_exactly_0",
                                  "ea_converged"])
def test_plain_suffstat_density_edges_match_pallas_interpret(case, packed):
    """The ends of the density range (rows with no bit or every bit on, one
    dense row among sparse ones, a ragged H, a B that is not a multiple of
    the default block rows, rows with rs exactly 0) and EA-converged states
    against evo_tpu's kernel: the same tolerances, and packed states equal
    to int8 ones."""
    ss, rs, block_rows = _edge_case(case, packed)
    B, S, H = ss.shape
    if case == "ea_converged":  # unique states, and the core on in most rows
        assert all(len(np.unique(ss[i], axis=0)) == S for i in range(B))
        assert (ss.sum(1).max(1) >= S - 4).all()
    x = pack_bits_lane_host(ss) if packed else ss
    want = bsc_suffstat_pallas(jnp.asarray(x), jnp.asarray(rs), H=H, block_rows=block_rows,
                               interpret=True)
    got = bsc_suffstat(torch.from_numpy(x), torch.from_numpy(rs), H=H)
    if packed:
        for g, u in zip(got, bsc_suffstat(torch.from_numpy(ss), torch.from_numpy(rs))):
            np.testing.assert_array_equal(g.numpy(), u.numpy())
    rho, sabs, wq = (g.numpy() for g in got)
    np.testing.assert_allclose(rho, np.asarray(want[0]), rtol=1e-5, atol=0)
    np.testing.assert_array_equal(sabs, np.asarray(want[1]))
    np.testing.assert_allclose(wq, np.asarray(want[2]), rtol=1e-5, atol=0)
    assert wq.shape == (H, H) and rho.shape == (B, H) and sabs.shape == (B, S)
