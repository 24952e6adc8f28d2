"""The port's ES3C sufficient statistics (the plain PyTorch version, which
the CUDA kernel is held to on the card) against the einsum expectations
built from evo_tpu's XLA-path slab posteriors (kappa, lambda of
``SSSC._lpj_states``), as tests/test_pallas_sssc.py builds them.

Tolerance: that of evo_tpu's own kernel tests, each output divided by its
largest magnitude within 4e-5 (f32 inverses taken by other algorithms).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from evo_tpu_torch.ops.sssc_suffstat import sssc_suffstat
from test_torch_sssc_lpj import oracle, problem, sparse_states

NAMES = ("xpt_sz", "xpt_s", "xpt_ss", "xpt_szsz", "s_sz", "sz_sz")


def expectations(p, kappa, lam):
    rs = jnp.asarray(p["rs"])
    sf = jnp.asarray(p["ss"], jnp.float32)
    want = dict(
        xpt_sz=jnp.einsum("bs,bsh->bh", rs, kappa),
        xpt_s=jnp.einsum("bs,bsh->bh", rs, sf),
        xpt_ss=jnp.einsum("bs,bsh,bsk->hk", rs, sf, sf),
        xpt_szsz=jnp.einsum("bs,bshj->hj", rs, lam)
        + jnp.einsum("bs,bsh,bsj->hj", rs, kappa, kappa))
    want["s_sz"] = jnp.einsum("bh,bk->hk", want["xpt_s"], want["xpt_sz"])
    want["sz_sz"] = jnp.einsum("bh,bk->hk", want["xpt_sz"], want["xpt_sz"])
    return [np.asarray(want[k]) for k in NAMES]


def port(p):
    out = sssc_suffstat(*(torch.from_numpy(np.asarray(p[k]))
                          for k in ("ss", "rs", "Wty", "G", "Psi", "mus")), float(p["s2inv"]))
    return [t.numpy() for t in out]


def with_rs(p, seed):
    rs = np.random.default_rng(seed).random(p["ss"].shape[:2]).astype(np.float32)
    p["rs"] = rs / rs.sum(1, keepdims=True)
    return p


@pytest.mark.parametrize("H,B,S,p_on", [(12, 256, 4, 0.25), (32, 128, 3, 0.15),
                                        (100, 64, 4, None)])
def test_plain_suffstat_matches_einsum_expectations(H, B, S, p_on):
    p = with_rs(problem(B, S, H, D=11, seed=H, p=p_on or 0.0), H)
    if p_on is None:  # H = 100: states within the exact popcount range
        p["ss"] = sparse_states(np.random.default_rng(H), B, S, H, max_active=16)
    _, _, kappa, lam = oracle(p)
    for name, got, ref in zip(NAMES, port(p), expectations(p, kappa, lam)):
        scale = np.abs(ref).max() + 1e-6
        np.testing.assert_allclose(got / scale, ref / scale, atol=4e-5, err_msg=name)


def test_overflow_state_counts_in_s_but_not_in_sz_at_h100():
    """At H = 100 a state with |s| > 16 gets kappa = 0 and no lambda, while
    its responsibility still counts in xpt_s and xpt_ss (the TPU kernel's
    w_s uses the unmasked responsibilities)."""
    B, S, H = 64, 4, 100
    p = with_rs(problem(B, S, H, D=11, seed=3), 3)
    p["ss"] = sparse_states(np.random.default_rng(3), B, S, H, max_active=5)
    p["ss"][4, 1] = 0
    p["ss"][4, 1, 20:39] = 1  # |s| = 19, responsibility rs[4, 1]
    r = float(p["rs"][4, 1])
    got = port(p)
    # the same statistics with that state taken out of the solve's sums
    _, _, kappa, lam = oracle(p)
    kappa, lam = np.asarray(kappa).copy(), np.asarray(lam).copy()
    kappa[4, 1], lam[4, 1] = 0.0, 0.0
    want = expectations(p, kappa, lam)
    for name, g, ref in zip(NAMES, got, want):
        scale = np.abs(ref).max() + 1e-6
        np.testing.assert_allclose(g / scale, ref / scale, atol=4e-5, err_msg=name)
    xpt_sz, xpt_s, xpt_ss = got[0], got[1], got[2]
    on = p["ss"][4, 1] != 0
    assert r > 0 and (xpt_s[4, on] >= r - 1e-6).all()
    assert (xpt_ss[np.ix_(on, on)] >= r - 1e-6).all()
    others = p["ss"][4, 0] != 0
    assert (xpt_sz[4, on & ~others] == 0).all()


def test_zero_pivot_states_at_h12():
    """A state whose Psi_AA meets a zero pivot in the unpivoted elimination
    (Psi[0, 0] = 0 with unit 0 first in A) is left out of the solve: kappa
    = 0 and no lambda, its r still counted in xpt_s and xpt_ss.  A single
    unit with Psi_hh = 0 takes the limit of a fixed slab instead: lambda =
    0 and kappa = mus_h."""
    B, S, H = 64, 4, 12
    p = with_rs(problem(B, S, H, D=11, seed=5), 5)
    p["ss"] = sparse_states(np.random.default_rng(5), B, S, H, max_active=4)
    p["ss"][:, :, 0] = 0
    p["ss"][4, 1] = 0
    p["ss"][4, 1, [0, 1, 6]] = 1
    p["ss"][5, 2] = 0
    p["ss"][5, 2, 0] = 1
    _, _, kappa, lam = oracle(p)  # on the unpoisoned Psi
    p["Psi"][0, 0] = 0.0
    kappa, lam = np.asarray(kappa).copy(), np.asarray(lam).copy()
    kappa[4, 1], lam[4, 1] = 0.0, 0.0
    kappa[5, 2], lam[5, 2] = 0.0, 0.0
    kappa[5, 2, 0] = p["mus"][0]
    for name, got, ref in zip(NAMES, port(p), expectations(p, kappa, lam)):
        scale = np.abs(ref).max() + 1e-6
        np.testing.assert_allclose(got / scale, ref / scale, atol=4e-5, err_msg=name)
