"""evo_tpu_torch.ops.numerics against evo_tpu.ops.numerics.  reset_lpj is
a pure select, so values and counts must be identical; the logsumexp and
posterior weights are f32 elementwise maths taken in another order by
another library, so they are held to 1e-6 relative."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from evo_tpu.ops import numerics as jn
from evo_tpu_torch.ops import numerics as tn

FLOOR = float(np.finfo(np.float32).min)


def test_reset_lpj_values_and_counts():
    lpj = np.array([[0.5, np.nan, -np.inf, np.inf],
                    [-3.0, FLOOR, np.nan, -1e30],
                    [np.nan, -np.inf, 2.0, -7.0]], np.float32)
    valid = np.array([True, True, False])
    for v in (None, valid):
        j_out, j_counts = jn.reset_lpj(jnp.asarray(lpj),
                                       None if v is None else jnp.asarray(v))
        t_out, t_counts = tn.reset_lpj(torch.from_numpy(lpj),
                                       None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
        assert [int(c) for c in t_counts] == [int(c) for c in j_counts]
    # -inf is both sub-floor and infinite: it ends as B_MAX, after the floor
    assert t_out[0, 2] == tn.B_MAX and t_out[0, 1] == FLOOR
    assert [int(c) for c in t_counts] == [2, 1, 2]


@pytest.mark.parametrize("fn", ["shifted_logsumexp", "posterior_weights"])
def test_logsumexp_and_weights(fn):
    rng = np.random.default_rng(1)
    lpj = (rng.standard_normal((20, 30)) * 50 - 300).astype(np.float32)
    lpj[3, 5:] = FLOOR
    want = np.asarray(getattr(jn, fn)(jnp.asarray(lpj)))
    got = getattr(tn, fn)(torch.from_numpy(lpj)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_free_energy_from_lpj():
    rng = np.random.default_rng(2)
    lpj = (rng.standard_normal((12, 7)) * 10 - 40).astype(np.float32)
    valid = np.arange(12) < 9
    want = float(jn.free_energy_from_lpj(jnp.asarray(lpj), -3.0, jnp.asarray(valid)))
    got = float(tn.free_energy_from_lpj(torch.from_numpy(lpj), -3.0, torch.from_numpy(valid)))
    assert got == pytest.approx(want, rel=1e-6)
