"""Image quality metrics (counterpart: evo_tpu/prepost/metrics.py)."""

from __future__ import annotations

import numpy as np


def psnr(target: np.ndarray, estimate: np.ndarray, data_range: float = 255.0) -> float:
    """10 log10(data_range^2 / MSE); NaNs in ``estimate`` are ignored."""
    t = np.asarray(target, dtype=float)
    e = np.asarray(estimate, dtype=float)
    ok = ~np.isnan(e)
    mse = np.mean((t[ok] - e[ok]) ** 2)
    return float(10.0 * np.log10(data_range**2 / mse))
