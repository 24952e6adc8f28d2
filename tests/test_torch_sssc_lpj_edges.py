"""The port's two ES3C lpj functions at the edges of the CUDA kernels'
paths, against evo_tpu's Pallas kernel in interpret mode on the same
numpy-seeded inputs.

The port's CPU path is the plain version (``sssc_lpj_plain``,
``sssc_lpj_masked_plain``), which ``chip_smoke.py`` holds both kernels to on
the card; the cases are those the kernels' split creates: states solved a
thread each up to ``SPARSE_N`` active units and a warp each past it (and
|s| = H - 1 and H), rows with no bit on, every state of a datapoint the
same, K = 1, H = 13, the overflow cap at H = 100 and 128 (|s| = 16 solved,
17 flagged), the poisoned Psi of each kernel's flag rule, and single-unit
states whose pivot decides the flag: M' at 1.5e-6 (kept) and 0.5e-6
(flagged) on complete data, and, masked, a Psi_AA pivot of 1e-8 (kept: that
kernel flags only non-finite values).  The masked B = 256 at K = 20 ends in
a part block of the kernel's 6 datapoints.  Shapes are shared, so the
Pallas kernel compiles a few times only.

Tolerance: evo_tpu's own (tests/test_torch_sssc_lpj.py), flags identical,
NaN exactly on them, the rest within 2e-3 + 2e-4 |lpj|.  One value is left
out of that: the kept state with a pivot of M' of 1.5e-6, whose lpj moves
by about 4% for one rounding of that pivot (a ulp of 1 over 1.5e-6) in any
f32 evaluation; its flag is the check there.  Where interpret mode would be
slow (Hp = 64, where the masked datapoint has 8 dense states; K = 1; a
datapoint's 150 states, which the masked kernel takes in two pieces), the
port is held against an f64 NumPy evaluation instead, with the same
tolerance and no state flagged.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from evo_tpu.ops.pallas_sssc import sssc_lpj_pallas
from evo_tpu_torch.ops.sssc_lpj import SPARSE_N, sssc_lpj
from test_torch_sssc_lpj import problem
from test_torch_sssc_masked import _problem as masked_problem

ARGS = ("ss", "Wty", "y2", "G", "Psi", "mus", "pil_bar")


def _set(ss, b, k, units):
    """State (b, k) with exactly these units on."""
    ss[b, k] = 0
    ss[b, k, units] = 1


def _draw(ss, b, k, n, rng, lo=0):
    """State (b, k) with n of the units lo .. H - 1 on, drawn at random."""
    _set(ss, b, k, lo + rng.permutation(ss.shape[-1] - lo)[:n])


def _inputs(masked, B, K, H, seed):
    if masked:
        p = masked_problem(B, K, H, D=11, seed=seed, p=2.0 / H)
        del p["rs"]
    else:
        p = problem(B, K, H, D=11, seed=seed, p=2.0 / H)
        p["pil_bar"] = p.pop("pil")
    return p


def _edit(case, p, masked, rng):
    """The case's states and Psi, in place; returns the (b, k) of states
    whose lpj value is not compared (see the module docstring)."""
    ss, Psi = p["ss"], p["Psi"]
    B, K, H = ss.shape
    if case == "threshold":  # |s| at the sparse path's threshold and one past it
        for i in range(24):
            _draw(ss, 7 * i + 1, i % K, SPARSE_N + i % 2, rng)
    elif case == "no_bit":  # whole datapoints and scattered rows with no bit on
        ss[:3] = 0
        ss[10:B:13, K // 2] = 0
    elif case == "equal":  # every state of a datapoint the same, sparse and dense
        _draw(ss, 4, 0, 3, rng)
        ss[4] = ss[4, 0]
        _draw(ss, 11, 0, SPARSE_N + 5, rng)
        ss[11] = ss[11, 0]
    elif case == "dense":  # |s| = H - 1, and every unit on
        for i in range(6):
            _draw(ss, 20 * i + 1, i % K, H - 1, rng)
        ss[7, 2] = 1
    elif case == "poisoned":
        ss[..., 0] = 0
        _set(ss, B - 1, 0, [0])
        if masked:  # a singular Psi_AA wherever unit 0 is on, a dense state too
            Psi[0, :] = Psi[:, 0] = 0.0
            _set(ss, 40, 3, np.arange(12))
        else:  # M' = 1 + s2inv Psi_00 G_00 = 0 for the state {0}
            Psi[0, 0] = -1.0 / (float(p["s2inv"]) * float(p["G"][0, 0]))
    elif case == "pivots":
        ss[..., :4] = 0
        Psi[:4, :] = Psi[:, :4] = 0.0
        Psi[2:4, 2:4] = np.eye(2)
        if masked:  # a first pivot of Psi_AA of 1e-8 in {2} and {2, 3}
            Psi[2, 2] = 1e-8
            _set(ss, 2, 0, [2])
            _set(ss, 3, 0, [2, 3])
        else:  # the pivot of M' of {0} at 1.5e-6, of {1} at 0.5e-6
            for h, t in ((0, 1.5e-6), (1, 0.5e-6)):
                Psi[h, h] = (t - 1.0) / (float(p["s2inv"]) * float(p["G"][h, h]))
                _set(ss, h, 0, [h])
            return [(0, 0)]
    elif case == "cap":  # H = 100 and 128: |s| = 16 (solved) and 17 (over the cap)
        for i, n in enumerate((16, 17, 16, 17, SPARSE_N, SPARSE_N + 1, 12, 40)):
            _draw(ss, 3 * i + 1, i % K, n, rng)
    return []


def _port(p):
    lpj, bad = sssc_lpj(*(torch.from_numpy(np.ascontiguousarray(p[k])) for k in ARGS),
                        float(p["s2inv"]))
    return lpj.numpy(), bad.numpy()


def _pallas(p):
    lpj, bad = sssc_lpj_pallas(*(jnp.asarray(p[k]) for k in ARGS), p["s2inv"], interpret=True)
    return np.asarray(lpj), np.asarray(bad)


def _oracle64(p):
    """The lpj in f64 by NumPy, state by state: base - 1/2 log det(I +
    s2inv Psi_AA G_AA) + 1/2 s2inv^2 u^T (Psi_AA^-1 + s2inv G_AA)^-1 u, the
    function both kernels evaluate (the masked one as two inverses)."""
    ss = p["ss"] != 0
    Wty, y2, G, Psi, mus, pil = (np.asarray(p[k], np.float64) for k in ARGS[1:])
    s2inv = float(p["s2inv"])
    B, K, H = ss.shape
    lpj = np.empty((B, K))
    for b in range(B):
        Gb = G[b] if G.ndim == 3 else G
        for k in range(K):
            A = np.flatnonzero(ss[b, k])
            GAA, PAA, a = Gb[np.ix_(A, A)], Psi[np.ix_(A, A)], mus[A]
            Ga = GAA @ a
            u = Wty[b, A] - Ga
            base = -0.5 * s2inv * (y2[b] - 2.0 * a @ Wty[b, A] + a @ Ga) + pil[A].sum()
            if A.size == 0:
                lpj[b, k] = base
                continue
            ld = np.linalg.slogdet(np.eye(A.size) + s2inv * PAA @ GAA)[1]
            lam = np.linalg.inv(np.linalg.inv(PAA) + s2inv * GAA)
            lpj[b, k] = base - 0.5 * ld + 0.5 * s2inv**2 * u @ lam @ u
    return lpj


def _assert_lpj_close(got, want, skip=()):
    (lpj, bad), (lpj_w, bad_w) = got, want
    np.testing.assert_array_equal(bad, bad_w)
    np.testing.assert_array_equal(np.isnan(lpj), bad > 0)
    np.testing.assert_array_equal(np.isnan(lpj_w), bad_w > 0)
    ok = bad == 0
    for r in skip:
        ok[r] = False
    np.testing.assert_allclose(lpj[ok], lpj_w[ok], rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("case", ["threshold", "no_bit", "equal", "dense", "poisoned", "pivots"])
@pytest.mark.parametrize("masked", [False, True], ids=["complete", "masked"])
def test_plain_lpj_edges_match_pallas_interpret(masked, case):
    B, K, H = (256, 20, 32) if masked else (1024, 6, 32)
    p = _inputs(masked, B, K, H, seed=len(case))
    skip = _edit(case, p, masked, np.random.default_rng(len(case) + 100))
    got = _port(p)
    n = p["ss"].sum(-1)
    if case == "threshold":
        assert {SPARSE_N, SPARSE_N + 1} <= set(n.ravel().tolist())
    if case == "dense":
        assert n.max() == H and (n == H - 1).sum() == 6
    if case == "poisoned":
        flagged = got[1] > 0
        np.testing.assert_array_equal(flagged, p["ss"][..., 0] != 0)
    if case == "pivots":
        rows = [(2, 0), (3, 0)] if masked else [(0, 0), (1, 0)]
        assert [bool(got[1][r]) for r in rows] == ([False, False] if masked else [False, True])
    _assert_lpj_close(got, _pallas(p), skip)


@pytest.mark.parametrize("masked,B,K,H", [(False, 1024, 2, 13), (True, 256, 2, 13)])
def test_plain_lpj_ragged_h_matches_pallas_interpret(masked, B, K, H):
    p = _inputs(masked, B, K, H, seed=K + H)
    _assert_lpj_close(_port(p), _pallas(p))


@pytest.mark.parametrize("H", [100, 128])
def test_plain_lpj_cap_matches_pallas_interpret(H):
    """Past the cap (|s| > 16) flagged, without a solve; |s| = 16 exact."""
    p = _inputs(False, 128, 4, H, seed=H)
    _edit("cap", p, False, np.random.default_rng(H))
    got = _port(p)
    np.testing.assert_array_equal(got[1] > 0, p["ss"].sum(-1) > 16)
    _assert_lpj_close(got, _pallas(p))


@pytest.mark.parametrize("masked,B,K,H,dense", [
    (True, 40, 8, 64, True),
    (True, 300, 1, 32, False),
    (False, 300, 1, 32, False),
    (True, 3, 150, 32, False),
    (False, 3, 150, 32, False),
])
def test_plain_lpj_matches_f64_oracle(masked, B, K, H, dense):
    """A datapoint whose 8 states are all dense at H = 64 (|s| 40 to 64,
    masked), K = 1, and a datapoint's 150 states (the masked kernel takes
    them in two pieces), against the f64 evaluation."""
    p = _inputs(masked, B, K, H, seed=B + K)
    rng = np.random.default_rng(K)
    if dense:
        for k, n in enumerate((40, 43, 46, 49, 52, 55, 58, 64)):
            _draw(p["ss"], 6, k, n, rng)
        _draw(p["ss"], 9, 2, SPARSE_N + 1, rng)
    lpj, bad = _port(p)
    assert not bad.any()
    np.testing.assert_allclose(lpj, _oracle64(p), rtol=2e-4, atol=2e-3)
