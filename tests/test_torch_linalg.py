"""evo_tpu_torch.ops.linalg.pd_inverse_logdet against evo_tpu's.

evo_tpu inverts by an unpivoted Schur recursion, the port by unpivoted
Gauss-Jordan elimination (the steps of the SSSC suffstat kernel), so the two
agree to f32 rounding of well-conditioned systems: inverses within 1e-4 of
their largest entry, log|det| within 1e-4 (absolute plus relative)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from evo_tpu.ops.linalg import pd_inverse_logdet as j_pd_inverse_logdet
from evo_tpu_torch.ops.linalg import pd_inverse_logdet


@pytest.mark.parametrize("H", [5, 8, 32])
def test_pd_inverse_logdet_matches_evo_tpu(H):
    rng = np.random.default_rng(H)
    A = rng.standard_normal((3, 4, H, H)).astype(np.float32)
    A = (A @ np.swapaxes(A, -1, -2) / H + np.eye(H, dtype=np.float32)).astype(np.float32)
    inv, ld = pd_inverse_logdet(torch.from_numpy(A))
    j_inv, j_ld = (np.asarray(x) for x in j_pd_inverse_logdet(jnp.asarray(A)))
    assert inv.shape == (3, 4, H, H) and ld.shape == (3, 4)
    np.testing.assert_allclose(inv.numpy(), j_inv, atol=1e-4 * np.abs(j_inv).max())
    np.testing.assert_allclose(ld.numpy(), j_ld, rtol=1e-4, atol=1e-4)


def test_sign_ignored_and_singular_input_never_raises():
    """Symmetric but indefinite: log|det|, as evo_tpu (the sign is
    dropped).  Singular: non-finite values, no exception."""
    A = np.array([[[1.0, 2.0], [2.0, 1.0]], [[1.0, 1.0], [1.0, 1.0]]], np.float32)
    inv, ld = pd_inverse_logdet(torch.from_numpy(A))
    j_inv, j_ld = (np.asarray(x) for x in j_pd_inverse_logdet(jnp.asarray(A)))
    np.testing.assert_allclose(inv.numpy()[0], j_inv[0], rtol=1e-6)
    assert float(ld[0]) == pytest.approx(float(j_ld[0]), rel=1e-6)
    assert not np.isfinite(inv.numpy()[1]).all() and not np.isfinite(float(ld[1]))
    assert not np.isfinite(j_inv[1]).all()


@pytest.mark.parametrize("A,evo_tpu_finite", [
    # invertible, but its leading 2 x 2 block is singular
    ([[1.0, 1.0, 0.0, 0.0], [1.0, 1.0, 1.0, 0.0], [0.0, 1.0, 2.0, 0.0],
      [0.0, 0.0, 0.0, 1.0]], False),
    # invertible, zero first entry, regular leading 2 x 2 block
    ([[0.0, 1.0], [1.0, 0.0]], True),
])
def test_zero_pivot_gives_non_finite_values(A, evo_tpu_finite):
    """A zero pivot of the unpivoted elimination gives non-finite values,
    as in the suffstat kernel.  evo_tpu's Schur recursion works on 2 x 2
    blocks: it fails as well on a singular leading 2 x 2 block, and inverts
    a regular one whose first entry is zero."""
    A = np.asarray(A, np.float32)
    inv, ld = pd_inverse_logdet(torch.from_numpy(A))
    assert not np.isfinite(inv.numpy()).all() and not np.isfinite(float(ld))
    j_inv, _ = j_pd_inverse_logdet(jnp.asarray(A))
    assert np.isfinite(np.asarray(j_inv)).all() == evo_tpu_finite
