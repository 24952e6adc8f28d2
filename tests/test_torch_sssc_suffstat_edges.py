"""The port's ES3C sufficient statistics at the edges of the CUDA kernel's
paths, against evo_tpu's Pallas kernel in interpret mode on the same
numpy-seeded inputs.

The port's CPU path is the plain version (``sssc_suffstat_plain``), which
``chip_smoke.py`` holds the kernel to on the card; the cases are those the
kernel's split creates: states solved a thread each up to ``SPARSE_N``
active units and a warp each past it, units of whole datapoints dealt to a
persistent grid (6 datapoints at S = 20, so B = 512 ends in a part unit),
rows that add nothing (no bit on, or r exactly 0), and the overflow cap at
H = 100.  Tolerance: evo_tpu's own, each output within 4e-5 of its largest
magnitude (tests/test_torch_sssc_suffstat.py).  The H = 32 cases share one
shape, so the Pallas kernel compiles once for them.

The cases with states of 31 to 64 units run at s2inv = 0.2: at the
generators' s2inv = 0.7 the Pallas kernel's own f32 solve of such states
is 4e-5 (H = 32) to 1.9e-3 (H = 64, D = 9) of the largest value off the
same function evaluated in f64, while the port's is within 3e-6.  The
port is held there against an f64 NumPy evaluation (pivoted inverses)
instead, with the same tolerance.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from evo_tpu.ops.pallas_sssc import sssc_suffstat_pallas
from evo_tpu_torch.ops.sssc_suffstat import SPARSE_N, sssc_suffstat
from test_torch_sssc_lpj import problem
from test_torch_sssc_masked import _problem as masked_problem

NAMES = ("xpt_sz", "xpt_s", "xpt_ss", "xpt_szsz", "s_sz", "sz_sz")
ARGS = ("ss", "rs", "Wty", "G", "Psi", "mus")


def _set(ss, b, k, n, rng):
    """State (b, k) with n of its H units on, drawn at random."""
    ss[b, k] = 0
    ss[b, k, rng.permutation(ss.shape[-1])[:n]] = 1


def _edit(case, ss, rs, rng):
    """The case's states and responsibilities, in place."""
    H = ss.shape[-1]
    if case == "no_bit":  # whole datapoints and scattered rows with no bit on
        ss[:3] = 0
        ss[10:200:7, 3] = 0
    elif case == "threshold":  # |s| at the sparse path's threshold and one past it
        for i in range(24):
            _set(ss, 2 * i + (i % 3), i % ss.shape[1], SPARSE_N + i % 2, rng)
    elif case == "dense":  # |s| = H - 1, and a datapoint with every unit on in one state
        for i in range(6):
            _set(ss, 40 * i + 1, i, H - 1, rng)
        ss[7, 2] = 1
    elif case == "rs_zero":  # rows with r exactly 0, dense ones and a whole datapoint too
        _set(ss, 5, 0, SPARSE_N + 3, rng)
        rs[5, 0] = 0.0
        rs[9] = 0.0
        rs[20:400:11, 1] = 0.0
    elif case == "equal":  # every state of a datapoint the same, sparse and dense
        _set(ss, 4, 0, 3, rng)
        ss[4] = ss[4, 0]
        _set(ss, 11, 0, SPARSE_N + 5, rng)
        ss[11] = ss[11, 0]
    elif case == "cap":  # H = 100: |s| = 16 (solved) and 17 (over the cap), and the threshold
        for i, n in enumerate((16, 17, 16, 17, SPARSE_N, SPARSE_N + 1, 12, 40)):
            _set(ss, 3 * i + 1, i % ss.shape[1], n, rng)


def _inputs(case, B, S, H, seed):
    p = problem(B, S, H, D=11, seed=seed, p=2.0 / H)
    rng = np.random.default_rng(seed + 100)
    rs = rng.random((B, S)).astype(np.float32)
    p["rs"] = rs / rs.sum(1, keepdims=True)
    _edit(case, p["ss"], p["rs"], rng)
    return p


def _dense_masked():
    """H = 64 under a per-datapoint Gram: one datapoint whose states are all
    dense (|s| 40, 52, 63 and 64, all units on), beside sparse ones and one
    state past the sparse threshold."""
    B, S, H = 128, 4, 64
    p = masked_problem(B, S, H, D=9, seed=8, p=2.0 / H)
    rng = np.random.default_rng(9)
    for k, n in enumerate((40, 52, 63, 64)):
        _set(p["ss"], 6, k, n, rng)
    _set(p["ss"], 30, 1, SPARSE_N + 1, rng)
    assert p["ss"][6].sum(-1).min() == 40 and p["ss"].sum(-1).max() == H
    return p


def _trained(B, S, H, masked, seed):
    """States shaped as the inpainting cell's trained K^(n): each datapoint's
    states drawn from a union of 5 to 9 units, |s| mostly 2-4 (1 to 8, and
    none), and every 7th datapoint one state past the sparse threshold
    (SPARSE_N + 1 to SPARSE_N + 3 units, its union widened to hold it)."""
    make = masked_problem if masked else problem
    p = make(B, S, H, D=11, seed=seed, p=2.0 / H)
    rng = np.random.default_rng(seed + 100)
    share = np.array([0.01, 0.04, 0.30, 0.36, 0.22, 0.06, 0.008, 0.0015, 0.0005])
    ss = p["ss"]
    ss[:] = 0
    for b in range(B):
        dense = SPARSE_N + 1 + (b // 7) % 3 if b % 7 == 0 else 0
        units = rng.permutation(H)[:max(5 + rng.integers(0, 5), dense)]
        for k in range(S):
            n = min(rng.choice(share.size, p=share / share.sum()), units.size)
            ss[b, k, rng.permutation(units)[:n]] = 1
        if dense:
            ss[b, rng.integers(0, S)] = 0
            ss[b, rng.integers(0, S), units[:dense]] = 1
    rs = rng.random((B, S)).astype(np.float32)
    p["rs"] = rs / rs.sum(1, keepdims=True)
    return p


def _port(p):
    args = [torch.from_numpy(np.ascontiguousarray(p[k])) for k in ARGS]
    return [t.numpy() for t in sssc_suffstat(*args, float(p["s2inv"]))]


def _assert_close(got, want):
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        scale = np.abs(w).max() + 1e-6
        np.testing.assert_allclose(g / scale, w / scale, atol=4e-5, err_msg=name)


def _compare(p):
    args = [jnp.asarray(np.ascontiguousarray(p[k])) for k in ARGS]
    _assert_close(_port(p), sssc_suffstat_pallas(*args, p["s2inv"], interpret=True))


def _oracle64(p):
    """The statistics in f64 by NumPy, state by state with pivoted inverses
    (the overflow rule of H > 64 included)."""
    ss = p["ss"] != 0
    rs, Wty, G, Psi, mus = (np.asarray(p[k], np.float64) for k in ARGS[1:])
    s2inv = float(p["s2inv"])
    B, S, H = ss.shape
    kappa = np.zeros((B, S, H))
    lam_r = np.zeros((H, H))
    for b in range(B):
        Gb = G[b] if G.ndim == 3 else G
        for k in range(S):
            A = np.flatnonzero(ss[b, k])
            if A.size == 0 or (H > 64 and A.size > 16):
                continue
            GAA = Gb[np.ix_(A, A)]
            lam = np.linalg.inv(s2inv * GAA + np.linalg.inv(Psi[np.ix_(A, A)]))
            kappa[b, k, A] = s2inv * lam @ (Wty[b, A] - GAA @ mus[A]) + mus[A]
            lam_r[np.ix_(A, A)] += rs[b, k] * lam
    sf = ss.astype(np.float64)
    xpt_sz = np.einsum("bs,bsh->bh", rs, kappa)
    xpt_s = np.einsum("bs,bsh->bh", rs, sf)
    return (xpt_sz, xpt_s, np.einsum("bs,bsh,bsk->hk", rs, sf, sf),
            lam_r + np.einsum("bs,bsh,bsk->hk", rs, kappa, kappa), xpt_s.T @ xpt_sz,
            xpt_sz.T @ xpt_sz)


@pytest.mark.parametrize("case,B,S,H", [
    ("ragged_B", 512, 20, 32),
    ("no_bit", 512, 20, 32),
    ("threshold", 512, 20, 32),
    ("dense", 512, 20, 32),
    ("rs_zero", 512, 20, 32),
    ("equal", 512, 20, 32),
    ("cap", 128, 4, 100),
])
def test_plain_suffstat_edges_match_pallas_interpret(case, B, S, H):
    p = _inputs(case, B, S, H, seed=len(case))
    n = p["ss"].sum(-1)
    if case in ("threshold", "cap"):
        assert {SPARSE_N, SPARSE_N + 1} <= set(n.ravel().tolist())
    if case == "cap":
        assert {16, 17} <= set(n.ravel().tolist())
    if case == "dense":
        assert n.max() == H and (n == H - 1).sum() == 6
        p["s2inv"] = np.float32(0.2)
    _compare(p)


def test_plain_masked_suffstat_dense_datapoint_at_h64_matches_pallas_interpret():
    p = _dense_masked()
    p["s2inv"] = np.float32(0.2)
    _compare(p)


@pytest.mark.parametrize("masked,B,S,H", [(True, 256, 20, 32), (False, 128, 8, 64)],
                         ids=["masked_h32", "complete_h64"])
def test_plain_suffstat_trained_states_past_sparse_n_match_pallas_interpret(masked, B, S, H):
    """States as training leaves them (a few units a datapoint, shared by
    its states), with rows past SPARSE_N, masked at H = 32 and on complete
    data at H = 64: the widths at which a warp takes a datapoint."""
    p = _trained(B, S, H, masked, seed=H + masked)
    n = p["ss"].sum(-1)
    assert (n > SPARSE_N).sum() >= B // 7 and (n == 0).any() and n.max() <= SPARSE_N + 3
    _compare(p)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_suffstat_dense_states_match_f64_oracle(masked):
    """The dense cases at the generators' s2inv = 0.7, against the f64
    evaluation."""
    p = _dense_masked() if masked else _inputs("dense", 512, 20, 32, seed=5)
    assert float(p["s2inv"]) == np.float32(0.7)
    _assert_close(_port(p), _oracle64(p))
