"""The port's ES3C lpj (its plain PyTorch version, which the CUDA kernel is
held to on the card) against evo_tpu's Pallas kernel in interpret mode and
against evo_tpu's XLA path (``SSSC._lpj_states``).

Tolerance: that of evo_tpu's own kernel tests (tests/test_pallas_sssc.py),
rtol 2e-4 and atol 2e-3: the two sides solve the same f32 systems by other
algorithms and in other orders.  The ``bad`` flags must be identical.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from evo_tpu.models.sssc import SSSC as JSSSC
from evo_tpu.ops.numerics import eps_lpj
from evo_tpu.ops.pallas_sssc import TB, sssc_lpj_pallas
from evo_tpu_torch.ops.numerics import reset_lpj
from evo_tpu_torch.ops.sssc_lpj import overflow_cap, sssc_lpj

ARGS = ("ss", "Wty", "y2", "G", "Psi", "mus", "pil")


def problem(B, K, H, D, seed=0, p=0.25):
    """Random model and states (the recipe of tests/test_pallas_sssc.py)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((D, H)).astype(np.float32)
    Psi0 = rng.standard_normal((H, H)).astype(np.float32)
    Y = rng.standard_normal((B, D)).astype(np.float32)
    return dict(G=(W.T @ W).astype(np.float32),
                Psi=(Psi0 @ Psi0.T / H + np.eye(H)).astype(np.float32),
                mus=rng.standard_normal(H).astype(np.float32),
                pil=rng.standard_normal(H).astype(np.float32), s2inv=np.float32(0.7),
                Wty=(Y @ W).astype(np.float32), y2=(Y * Y).sum(-1).astype(np.float32),
                ss=(rng.random((B, K, H)) < p).astype(np.int8))


def sparse_states(rng, B, K, H, max_active):
    """States with |s| <= max_active, one of them all-zero."""
    ss = np.zeros((B, K, H), np.int8)
    n_act = rng.integers(0, max_active + 1, size=(B, K))
    for b in range(B):
        for k in range(K):
            ss[b, k, rng.choice(H, size=n_act[b, k], replace=False)] = 1
    ss[0, 0] = 0
    return ss


def oracle(p):
    """evo_tpu's XLA path: (lpj, bad count, kappa, lambda) per datapoint."""
    return jax.vmap(JSSSC._lpj_states, in_axes=(0, None, 0, 0, None, None, None, None))(
        *(jnp.asarray(p[k]) for k in ("ss", "G", "Wty", "y2", "Psi", "mus", "s2inv", "pil")))


def port(p):
    lpj, bad = sssc_lpj(*(torch.from_numpy(np.asarray(p[k])) for k in ARGS),
                        float(p["s2inv"]))
    return lpj.numpy(), bad.numpy()


@pytest.mark.parametrize("H,K", [(12, 3), (32, 5)])
def test_plain_lpj_matches_pallas_interpret(H, K):
    p = problem(TB, K, H, D=9)
    want, want_bad = sssc_lpj_pallas(*(jnp.asarray(p[k]) for k in ARGS), p["s2inv"],
                                     interpret=True)
    got, bad = port(p)
    np.testing.assert_array_equal(bad, np.asarray(want_bad))
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-3)


@pytest.fixture(scope="module")
def h100():
    """H = 100 (Hp = 128): sparse states, one with |s| = 16 (the most that
    stays exact), one with 17 and one with 19 active units; with the port's
    and evo_tpu's XLA-path lpj."""
    B, K, H = 64, 4, 100
    p = problem(B, K, H, D=9, seed=7)
    ss = sparse_states(np.random.default_rng(7), B, K, H, max_active=12)
    ss[3, 1] = 0
    ss[3, 1, :16] = 1
    ss[5, 2, 10:29] = 1  # |s| = 19
    ss[6, 0, :17] = 1  # |s| = 17
    p["ss"] = ss
    return p, port(p), np.asarray(oracle(p)[0])


def test_plain_lpj_matches_xla_path_at_h100(h100):
    """States with |s| <= 16 are exact at H = 100."""
    p, (got, _), want = h100
    ok = p["ss"].sum(-1) <= 16
    assert ok.sum() == ok.size - 2 and p["ss"].sum(-1)[ok].max() == 16
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-4, atol=2e-3)


def test_overflow_rule_at_h100(h100):
    """64 < H <= 128: a state with more than Hp/8 = 16 active units is
    flagged and its lpj is NaN; no other state is flagged."""
    assert overflow_cap(100) == 16 and overflow_cap(64) == 0
    with pytest.raises(ValueError):
        overflow_cap(129)
    p, (got, bad), _ = h100
    over = p["ss"].sum(-1) > 16
    np.testing.assert_array_equal(bad > 0, over)
    assert np.isnan(got[over]).all() and np.isfinite(got[~over]).all()


@pytest.mark.parametrize("H,sparse", [(8, False), (32, True)])
def test_poisoned_psi_flags_nan_never_inf(H, sparse):
    """The two poisoned-Psi cases of tests/test_pallas_sssc.py: Psi[0, 0] =
    -1/(s2inv G[0, 0]) makes M' = 1 + s2inv Psi_00 G_00 of the single-unit
    state {0} singular.  Such states are flagged, their lpj is NaN (never
    +-inf), the flags agree with the Pallas kernel's, and reset_lpj puts
    them at the floor, never at the dominant lpj."""
    B, K = TB, 2
    p = problem(B, K, H, D=9 if sparse else 5, seed=5 if sparse else 2)
    p["Psi"] = p["Psi"].copy()
    p["Psi"][0, 0] = -1.0 / (float(p["s2inv"]) * float(p["G"][0, 0]))
    if sparse:
        p["ss"] = sparse_states(np.random.default_rng(5), B, K, H, max_active=6)
    else:
        p["ss"] = np.zeros((B, K, H), np.int8)
    p["ss"][:, 0, :] = 0
    p["ss"][:, 0, 0] = 1
    got, bad = port(p)
    _, want_bad = sssc_lpj_pallas(*(jnp.asarray(p[k]) for k in ARGS), p["s2inv"],
                                  interpret=True)
    np.testing.assert_array_equal(bad, np.asarray(want_bad))
    flagged = bad > 0
    assert flagged[:, 0].all()
    assert np.isnan(got[flagged]).all() and not np.isinf(got).any()
    reset, counts = reset_lpj(torch.from_numpy(got))
    assert (reset.numpy()[flagged] <= 0.5 * eps_lpj(np.float32)).all()
    assert int(counts.n_nan) == int(flagged.sum()) and int(counts.n_inf) == 0
