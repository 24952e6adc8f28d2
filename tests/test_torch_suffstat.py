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
