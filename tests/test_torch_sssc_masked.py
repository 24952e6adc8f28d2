"""The port's masked-Gram ES3C lpj and sufficient statistics (incomplete
data) against evo_tpu's masked Pallas kernels.

The same NumPy inputs (a per-datapoint Gram G_n = W^T diag(m_n) W, masked
Wty and y2) go to evo_tpu's ``sssc_lpj_pallas`` / ``sssc_suffstat_pallas``
in interpret mode, as tests/test_pallas_sssc.py runs them, and to the
port's plain versions.  Tolerances are evo_tpu's own: lpj rtol 2e-4 and
atol 2e-3 with identical ``bad`` flags (NaN exactly where flagged), each
statistic within 5e-5 of its largest magnitude.  Interpret mode is slow at
Hp = 64, so the dense H = 64 states are held against evo_tpu's XLA path
(``SSSC._lpj_states``) instead.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from evo_tpu.models.sssc import SSSC as JSSSC
from evo_tpu.ops.linalg import _next_pow2
from evo_tpu.ops.pallas_sssc import _tb_masked, sssc_lpj_pallas, sssc_suffstat_pallas
from evo_tpu_torch.ops.sssc_lpj import (
    sssc_lpj,
    sssc_lpj_masked,
    sssc_lpj_masked_plain,
    sssc_lpj_plain,
)
from evo_tpu_torch.ops.sssc_suffstat import sssc_suffstat, sssc_suffstat_plain

NAMES = ("xpt_sz", "xpt_s", "xpt_ss", "xpt_szsz", "s_sz", "sz_sz")


def _problem(B, K, H, D, seed=0, p=0.25, miss=0.15):
    """tests/test_pallas_sssc.py's _masked_problem: random model, 15% of the
    entries missing, states with about p H units on."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((D, H)).astype(np.float32)
    Psi0 = rng.standard_normal((H, H)).astype(np.float32)
    Psi = (Psi0 @ Psi0.T / H + np.eye(H)).astype(np.float32)
    Y = rng.standard_normal((B, D)).astype(np.float32)
    m = (rng.random((B, D)) >= miss).astype(np.float32)
    Ym = Y * m
    rs = rng.random((B, K)).astype(np.float32)
    return dict(ss=(rng.random((B, K, H)) < p).astype(np.int8),
                Wty=(Ym @ W).astype(np.float32), y2=(Ym * Ym).sum(-1).astype(np.float32),
                G=np.einsum("di,bd,dj->bij", W, m, W).astype(np.float32), Psi=Psi,
                mus=rng.standard_normal(H).astype(np.float32),
                pil_bar=rng.standard_normal(H).astype(np.float32), s2inv=np.float32(0.7),
                rs=rs / rs.sum(1, keepdims=True))


def _poison(p):
    """Psi with a zero row and column for unit 0, which only the last
    datapoint's slot 0 holds (with unit 1): that one state is flagged."""
    p["ss"][..., 0] = 0
    p["ss"][-1, 0, :2] = 1
    p["Psi"][0, :] = 0.0
    p["Psi"][:, 0] = 0.0


def _lpj_args(p):
    return {k: p[k] for k in ("ss", "Wty", "y2", "G", "Psi", "mus", "pil_bar", "s2inv")}


def _port_lpj(p):
    args = {k: torch.from_numpy(np.asarray(v)) for k, v in _lpj_args(p).items()}
    lpj, bad = sssc_lpj(**args)
    return lpj.numpy(), bad.numpy()


def _evo_lpj(p):
    a = _lpj_args(p)
    lpj, bad = sssc_lpj_pallas(*(jnp.asarray(a[k]) for k in (
        "ss", "Wty", "y2", "G", "Psi", "mus", "pil_bar")), a["s2inv"], interpret=True)
    return np.asarray(lpj), np.asarray(bad)


def _assert_lpj_close(got, want):
    (lpj, bad), (lpj_w, bad_w) = got, want
    np.testing.assert_array_equal(bad, bad_w)
    np.testing.assert_array_equal(np.isnan(lpj), bad > 0)
    np.testing.assert_array_equal(np.isnan(lpj_w), bad_w > 0)
    ok = bad == 0
    np.testing.assert_allclose(lpj[ok], lpj_w[ok], rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("H,K", [(12, 3), (32, 5), (48, 4)])
def test_masked_lpj_matches_pallas_kernel(H, K):
    B = 2 * _tb_masked(max(8, _next_pow2(H)))
    p = _problem(B, K, H, D=9)
    _poison(p)
    got, want = _port_lpj(p), _evo_lpj(p)
    assert got[1].sum() == want[1].sum() == 1 and got[1][-1, 0] == 1
    _assert_lpj_close(got, want)


def test_masked_lpj_dense_states_at_h64_match_xla_path():
    """Every state is exact at H = 64: |s| from 1 up to 64 against evo_tpu's
    XLA oracle (identity-padded full-H solves)."""
    B, K, H = 16, 4, 64
    p = _problem(B, K, H, D=9, seed=3, p=2.0 / H)
    rng = np.random.default_rng(4)
    for i in range(B):
        n = 4 * (i + 1)
        p["ss"][i, 0] = 0
        p["ss"][i, 0, rng.permutation(H)[:n]] = 1
    assert p["ss"].sum(-1).max() == H
    lpj_o = jax.vmap(JSSSC._lpj_states, in_axes=(0, 0, 0, 0, None, None, None, None))(
        *(jnp.asarray(p[k]) for k in ("ss", "G", "Wty", "y2", "Psi", "mus", "s2inv",
                                      "pil_bar")))[0]
    lpj_o = np.asarray(lpj_o)
    _assert_lpj_close(_port_lpj(p), (lpj_o, np.isnan(lpj_o).astype(np.float32)))


def test_tiny_finite_pivot_is_not_flagged():
    """The masked kernel flags only a non-finite Psi_AA^-1 or lpj.  State
    {0} with s2inv G_n[0, 0] = 1 and Psi[0, 0] = -(1 - 2^-22) gives
    M = s2inv G_n,00 + 1/Psi_00 = -2^-22: a tiny, finite pivot that evo_tpu's
    masked kernel does not flag, nor does the port's; the complete-data
    rule (a pivot of M' below 1e-6) would flag it."""
    H, K = 8, 2
    B = 2 * _tb_masked(8)
    p = _problem(B, K, H, D=9, seed=5)
    p["ss"][..., 0] = 0
    p["ss"][3, 1] = 0
    p["ss"][3, 1, 0] = 1
    W = np.random.default_rng(6).standard_normal((9, H)).astype(np.float32)
    W[:, 0] = 0.0
    W[0, 0] = 1.0
    m = np.ones((B, 9), np.float32)
    m[:, 5] = 0.0
    p["G"] = np.einsum("di,bd,dj->bij", W, m, W).astype(np.float32)
    p["s2inv"] = np.float32(1.0)
    p["Psi"][0, :] = 0.0
    p["Psi"][:, 0] = 0.0
    p["Psi"][0, 0] = -(1.0 - 2.0**-22)
    got, want = _port_lpj(p), _evo_lpj(p)
    assert got[1].sum() == want[1].sum() == 0
    assert np.isfinite(got[0][3, 1])
    _assert_lpj_close(got, want)
    one = {k: torch.from_numpy(np.asarray(v)) for k, v in _lpj_args(p).items()}
    one.update(ss=one["ss"][3:4], Wty=one["Wty"][3:4], y2=one["y2"][3:4], G=one["G"][3])
    assert float(sssc_lpj_plain(**one)[1][0, 1]) == 1.0


def test_masked_suffstat_matches_pallas_kernel():
    H, S = 16, 4
    B = 2 * _tb_masked(16)
    p = _problem(B, S, H, D=11, seed=1)
    args = [p[k] for k in ("ss", "rs", "Wty", "G", "Psi", "mus")]
    want = sssc_suffstat_pallas(*(jnp.asarray(a) for a in args), p["s2inv"], interpret=True)
    got = sssc_suffstat(*(torch.from_numpy(a) for a in args), p["s2inv"])
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        scale = np.abs(w).max() + 1e-6
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=5e-5, err_msg=name)


def test_masked_wrappers_dispatch_and_envelope():
    """A [B, H, H] Gram takes the masked versions, which stop at H = 64; a
    shared Gram in the suffstat's plain version gives the complete-data
    statistics."""
    p = _problem(6, 3, 5, D=7, seed=2)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
    lpj_args = [t[k] for k in ("ss", "Wty", "y2", "G", "Psi", "mus", "pil_bar", "s2inv")]
    for a, b in zip(sssc_lpj(*lpj_args), sssc_lpj_masked_plain(*lpj_args)):
        assert torch.equal(a, b)
    shared = torch.stack([t["G"][0]] * 6)
    ss_args = [t["ss"], t["rs"], t["Wty"], shared, t["Psi"], t["mus"], t["s2inv"]]
    for a, b in zip(sssc_suffstat_plain(*ss_args[:3], t["G"][0], *ss_args[4:]),
                    sssc_suffstat(*ss_args)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    wide = torch.zeros((2, 1, 65), dtype=torch.int8)
    with pytest.raises(ValueError, match="H <= 64"):
        sssc_lpj_masked(wide, torch.zeros(2, 65), torch.zeros(2), torch.zeros(2, 65, 65),
                        torch.eye(65), torch.zeros(65), torch.zeros(65), 1.0)
