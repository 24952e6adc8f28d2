"""Overlapping image patches: extraction and merge, on the host with NumPy.

Counterpart: evo_tpu/prepost/patches.py (the reference drivers' tvutil
``OverlappingPatches``, ``MultiDimOverlappingPatches``, ``mean_merger`` and
``median_merger``).  The patch matrix is [D, N], one column per patch, as
the drivers consume it through ``.get().T``; merging lays each in-patch
offset onto a NaN-padded canvas and reduces with nanmean or nanmedian.
"""

from __future__ import annotations

import numpy as np


def mean_merger(stack: np.ndarray) -> np.ndarray:
    """Average of all patch values covering each pixel (NaN = not covered)."""
    return np.nanmean(stack, axis=0)


def median_merger(stack: np.ndarray) -> np.ndarray:
    """Median of all patch values covering each pixel."""
    return np.nanmedian(stack, axis=0)


class OverlappingPatches:
    """All overlapping patches of a 2D image on a regular stride grid."""

    def __init__(self, image: np.ndarray, patch_height: int, patch_width: int,
                 patch_shift: int = 1):
        if np.ndim(image) != 2:
            raise ValueError("use MultiDimOverlappingPatches for images with channels")
        self.image = np.asarray(image)
        self.ph, self.pw, self.shift = patch_height, patch_width, patch_shift
        Hh, Ww = self.image.shape
        self.ni = (Hh - patch_height) // patch_shift + 1
        self.nj = (Ww - patch_width) // patch_shift + 1

    @property
    def num_patches(self) -> int:
        return self.ni * self.nj

    def get(self) -> np.ndarray:
        """Patch matrix [D, N] with D = ph * pw."""
        win = np.lib.stride_tricks.sliding_window_view(self.image, (self.ph, self.pw))
        win = win[:: self.shift, :: self.shift]  # [ni, nj, ph, pw]
        return win.reshape(self.num_patches, self.ph * self.pw).T.copy()

    def set_and_merge(self, patches: np.ndarray, merge_method=mean_merger) -> np.ndarray:
        """The image reassembled from (modified) patches [D, N]."""
        ph, pw, shift = self.ph, self.pw, self.shift
        Hh, Ww = self.image.shape
        p = patches.T.reshape(self.ni, self.nj, ph, pw)
        stack = np.full((ph * pw, Hh, Ww), np.nan, dtype=float)
        for a in range(ph):
            for b in range(pw):
                stack[a * pw + b, a:a + self.ni * shift:shift,
                      b:b + self.nj * shift:shift] = p[:, :, a, b]
        return merge_method(stack)


class MultiDimOverlappingPatches:
    """Channel-wise ``OverlappingPatches`` of an [H, W, C] image; a patch
    vector is the per-channel patches one after the other (D = ph pw C)."""

    def __init__(self, image: np.ndarray, patch_height: int, patch_width: int,
                 patch_shift: int = 1):
        if np.ndim(image) != 3:
            raise ValueError("MultiDimOverlappingPatches takes [H, W, C] images")
        self.C = image.shape[2]
        self.ovps = [OverlappingPatches(image[:, :, c], patch_height, patch_width,
                                        patch_shift) for c in range(self.C)]

    @property
    def num_patches(self) -> int:
        return self.ovps[0].num_patches

    def get(self) -> np.ndarray:
        return np.concatenate([o.get() for o in self.ovps], axis=0)  # [D, N]

    def set_and_merge(self, patches: np.ndarray, merge_method=mean_merger) -> np.ndarray:
        D = patches.shape[0] // self.C
        return np.stack([o.set_and_merge(patches[c * D:(c + 1) * D], merge_method)
                         for c, o in enumerate(self.ovps)], axis=2)
