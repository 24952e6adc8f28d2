"""Plain reference of the image apps' data and merge (NumPy, float64).

An image [h, w] or [h, w, C] is cut into every overlapping p x p patch at
stride 1, row-major over the patch's top-left corner; a patch vector holds
channel 0's p x p values row by row, then channel 1's, and so on.  Each
patch is centred on the mean of its observed values (a patch with none
observed on 0).  A reconstruction [N, D] gets its patch means back and is
merged into an image by the mean, or the median, of the values that the
patches covering a pixel give it; PSNR = 10 log10(255^2 / MSE).
"""

from __future__ import annotations

import numpy as np


def _channels(img):
    img = np.asarray(img, dtype=np.float64)
    return img[..., None] if img.ndim == 2 else img


def patches(img, p: int):
    """(Y [N, D] with NaN where img is NaN, centred; dc [N, 1])."""
    im = _channels(img)
    h, w, C = im.shape
    ni, nj = h - p + 1, w - p + 1
    cols = []
    for c in range(C):
        for a in range(p):
            for b in range(p):
                cols.append(im[a:a + ni, b:b + nj, c].reshape(-1))
    Y = np.stack(cols, axis=1)
    with np.errstate(invalid="ignore"):
        dc = np.nanmean(Y, axis=1, keepdims=True)
    dc = np.where(np.isfinite(dc), dc, 0.0)
    return Y - dc, dc


def merge(Y_rec, dc, shape, p: int):
    """(mean-merged, median-merged) image of shape ``shape`` from the
    centred reconstruction [N, D] and its dc [N, 1]."""
    h, w = shape[:2]
    C = shape[2] if len(shape) == 3 else 1
    ni, nj = h - p + 1, w - p + 1
    V = np.asarray(Y_rec, dtype=np.float64) + dc
    mean = np.empty((h, w, C))
    median = np.empty((h, w, C))
    k = 0
    for c in range(C):
        stack = np.full((p * p, h, w), np.nan)
        for a in range(p):
            for b in range(p):
                stack[a * p + b, a:a + ni, b:b + nj] = V[:, k].reshape(ni, nj)
                k += 1
        mean[..., c] = np.nanmean(stack, axis=0)
        median[..., c] = np.nanmedian(stack, axis=0)
    if len(shape) == 2:
        return mean[..., 0], median[..., 0]
    return mean, median


def psnr(clean, img) -> float:
    mse = np.mean((np.asarray(clean, dtype=np.float64) - img) ** 2)
    return float(10.0 * np.log10(255.0**2 / mse))
