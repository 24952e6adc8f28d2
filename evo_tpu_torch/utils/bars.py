"""Ground-truth bars dictionary of the standard bars test (counterpart:
evo_tpu/utils/bars.py): H bases on an R x R grid (R = H//2), half
horizontal, half vertical."""

from __future__ import annotations

import numpy as np


def generate_bars_dict(H: int, neg_bars: bool = False, rng=None) -> np.ndarray:
    """[R*R, H] bars; with ``neg_bars`` each bar's sign drawn from ``rng``
    (default: ``np.random.default_rng(0)``)."""
    R = H // 2
    D = R * R
    W = np.zeros((R, R, H))
    for i in range(R):
        W[i, :, i] = 1.0
        W[:, i, R + i] = 1.0
    if neg_bars:
        rng = rng or np.random.default_rng(0)
        sign = 1 - 2 * rng.integers(0, 2, size=(H,))
        W = sign[None, None, :] * W
    return W.reshape(D, H)
