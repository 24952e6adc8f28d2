"""Filter and image grids (counterpart: evo_tpu/prepost/viz.py).

NumPy on the host; ``save_grid`` imports matplotlib (Agg backend) when it
is called, so nothing else here needs it."""

from __future__ import annotations

import numpy as np


def scale(x: np.ndarray, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """Affinely rescale to [lo, hi] (NaN ignored; a constant maps to the middle)."""
    x = np.asarray(x, dtype=float)
    mn, mx = np.nanmin(x), np.nanmax(x)
    if mx == mn:
        return np.full_like(x, (lo + hi) / 2.0)
    return lo + (x - mn) * (hi - lo) / (mx - mn)


def make_grid(images: np.ndarray, ncol: int = 8, pad: int = 1,
              scale_each: bool = True, pad_value: float = 0.0) -> np.ndarray:
    """Tile [n, h, w] (or [n, h, w, C]) images into one grid image with
    ``pad`` pixels of ``pad_value`` between tiles, each image rescaled to
    [0, 1] first with ``scale_each``."""
    images = np.asarray(images, dtype=float)
    if images.ndim == 3:
        images = images[..., None]
    n, h, w, C = images.shape
    if scale_each:
        images = np.stack([scale(img) for img in images], axis=0)
    ncol = min(ncol, n)
    nrow = -(-n // ncol)
    grid = np.full((nrow * (h + pad) + pad, ncol * (w + pad) + pad, C), pad_value, dtype=float)
    for k in range(n):
        r, c = divmod(k, ncol)
        grid[pad + r * (h + pad):pad + r * (h + pad) + h,
             pad + c * (w + pad):pad + c * (w + pad) + w] = images[k]
    return grid.squeeze(-1) if C == 1 else grid


def save_grid(path: str, images: np.ndarray, ncol: int = 8, **kwargs) -> None:
    """Render a filter grid to an image file (PNG through matplotlib's Agg)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grid = make_grid(images, ncol=ncol, **kwargs)
    fig, ax = plt.subplots(figsize=(max(4, grid.shape[1] / 24), max(4, grid.shape[0] / 24)))
    ax.imshow(grid, cmap="gray" if grid.ndim == 2 else None, interpolation="nearest")
    ax.axis("off")
    fig.savefig(path, bbox_inches="tight", dpi=150)
    plt.close(fig)
