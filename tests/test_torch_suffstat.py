"""The port's sufficient statistics (their plain PyTorch version, which the
CUDA kernel is held to on the card) against evo_tpu's Pallas kernel in
interpret mode.  rho and Wq are f32 sums of non-negative terms taken in
different orders: relative 1e-5.  sabs counts 0/1 values: exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

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
