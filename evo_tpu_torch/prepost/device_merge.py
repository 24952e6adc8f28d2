"""Merge of overlapping reconstructed patches and PSNR, on the card.

Counterpart: evo_tpu/prepost/device_merge.py (``DeviceMerger``).  The image
apps merge the reconstruction and take the PSNR at every merge epoch, and
inpainting merges every epoch; the host's nanmean/nanmedian merge of a
full-size image costs about as much as a whole epoch.  Here the merge runs
where the reconstruction already is: the geometry is static for a fixed
image and patch shape (which patch covers which pixel, each pixel's
coverage count and, for the median, the ranks to take), so it is computed
once with NumPy and the merge is a fixed sequence of slices, a sort and a
gather.  Only the PSNR values need to come back to the host.

Numerics: f32 on the device against the host path's f64.  The mean sums at
most ph pw values a pixel; the median is a sort and a selection, exact up
to the inputs' rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from evo_tpu_torch._device import resolve_device


def coverage(ni: int, nj: int, ph: int, pw: int, Hh: int, Ww: int) -> np.ndarray:
    """[Hh, Ww] int: how many in-patch offsets (a, b) cover each pixel at
    stride 1 (pixel (i, j) is covered by offset (a, b) iff a <= i < a + ni
    and b <= j < b + nj)."""
    cnt = np.zeros((Hh, Ww), np.int64)
    for a in range(ph):
        for b in range(pw):
            cnt[a:a + ni, b:b + nj] += 1
    return cnt


class DeviceMerger:
    """Mean and median merge plus PSNR for one fixed patch geometry.

    Built from an ``OverlappingPatches`` or ``MultiDimOverlappingPatches``
    (of the port or of evo_tpu: only the geometry attributes are read) and
    the clean image.  Called with the blocked reconstruction [nb, B, D]
    (padding rows at the tail are dropped) and the per-patch DC [N, 1], it
    returns tensors on the card: {mean, median, psnr_mean, psnr_median}.

    Needs patch_shift == 1, the only stride the image apps use; every pixel
    is then covered at least once, so the host path's NaN handling of
    uncovered pixels has nothing to do here.
    """

    def __init__(self, ovp, clean_image: np.ndarray, data_range: float = 255.0,
                 device=None):
        ovps = getattr(ovp, "ovps", None)
        base = ovps[0] if ovps is not None else ovp
        if base.shift != 1:
            raise ValueError("DeviceMerger supports patch_shift == 1 only")
        dev = resolve_device(device)
        self.C = len(ovps) if ovps is not None else 0  # 0: grayscale [H, W]
        self.ph, self.pw = base.ph, base.pw
        self.ni, self.nj = base.ni, base.nj
        self.Hh, self.Ww = base.image.shape
        self.N = base.num_patches
        self.data_range = float(data_range)
        cnt = coverage(self.ni, self.nj, self.ph, self.pw, self.Hh, self.Ww)
        self._cnt = torch.as_tensor(cnt, dtype=torch.float32, device=dev)
        # np.nanmedian over the cnt covered values: the mean of the ascending
        # ranks (cnt - 1) // 2 and cnt // 2; uncovered slots sort last (+inf)
        self._lo = torch.as_tensor((cnt - 1) // 2, device=dev)[None]
        self._hi = torch.as_tensor(cnt // 2, device=dev)[None]
        self._clean = torch.as_tensor(np.asarray(clean_image), dtype=torch.float32,
                                      device=dev)

    def _merge_channel(self, yc: torch.Tensor):
        """yc [N, ph pw] -> (mean, median), each [Hh, Ww]."""
        ni, nj, ph, pw = self.ni, self.nj, self.ph, self.pw
        p = yc.reshape(ni, nj, ph, pw)
        acc = torch.zeros((self.Hh, self.Ww), dtype=torch.float32, device=yc.device)
        layers = torch.full((ph * pw, self.Hh, self.Ww), float("inf"), dtype=torch.float32,
                            device=yc.device)
        for a in range(ph):
            for b in range(pw):
                acc[a:a + ni, b:b + nj] += p[:, :, a, b]
                layers[a * pw + b, a:a + ni, b:b + nj] = p[:, :, a, b]
        srt = torch.sort(layers, dim=0).values
        lo = torch.gather(srt, 0, self._lo)[0]
        hi = torch.gather(srt, 0, self._hi)[0]
        return acc / self._cnt, 0.5 * (lo + hi)

    def psnr(self, img: torch.Tensor) -> torch.Tensor:
        """10 log10(data_range^2 / MSE) against the clean image, 0-dim."""
        mse = torch.mean(torch.square(self._clean - img))
        return 10.0 * torch.log10(self.data_range**2 / mse)

    def __call__(self, y_rec_blocked: torch.Tensor, dc: torch.Tensor) -> dict:
        """y_rec_blocked [nb, B, D]: the DC-centred reconstruction with any
        padding rows at the tail; dc [N, 1]."""
        D = y_rec_blocked.shape[-1]
        flat = y_rec_blocked.reshape(-1, D)[:self.N].to(torch.float32) + dc.to(torch.float32)
        if self.C:  # channel c's patches are columns [c php, (c + 1) php)
            php = D // self.C
            mm = [self._merge_channel(flat[:, c * php:(c + 1) * php]) for c in range(self.C)]
            mean = torch.stack([m[0] for m in mm], dim=2)
            median = torch.stack([m[1] for m in mm], dim=2)
        else:
            mean, median = self._merge_channel(flat)
        return {"mean": mean, "median": median, "psnr_mean": self.psnr(mean),
                "psnr_median": self.psnr(median)}
