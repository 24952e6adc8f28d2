"""The port's patches, mergers, PSNR and DeviceMerger against evo_tpu.prepost.

The same NumPy images and reconstructions go through both packages.  The
host classes must give identical patch matrices and merged images; the
port's DeviceMerger (f32 in torch, here on the CPU) is held against
evo_tpu's host path (f64) and evo_tpu's own DeviceMerger: merged images
within 1e-5 of the data range 255, PSNR within 1e-3 dB, for grayscale and
RGB, odd and even coverage counts, blocked reconstructions with padding.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from evo_tpu import prepost as jp
from evo_tpu.prepost.device_merge import DeviceMerger as JDeviceMerger
from evo_tpu_torch import prepost as tp
from evo_tpu_torch.prepost.device_merge import DeviceMerger

IMAGES = {
    "gray_5x5": ((17, 13), 5, 5),
    "gray_2x3": ((16, 11), 2, 3),
    "rgb_3x4": ((14, 11, 3), 3, 4),
    "rgb_5x5": ((12, 15, 3), 5, 5),
}


def _setup(name):
    shape, ph, pw = IMAGES[name]
    rng = np.random.default_rng(len(name))
    clean = rng.uniform(0, 255, shape)
    cls = "MultiDimOverlappingPatches" if len(shape) == 3 else "OverlappingPatches"
    return clean, rng, getattr(jp, cls)(clean, ph, pw, 1), getattr(tp, cls)(clean, ph, pw, 1)


@pytest.mark.parametrize("name", list(IMAGES))
def test_host_patches_merge_and_psnr_match_evo_tpu(name):
    clean, rng, jo, to = _setup(name)
    assert to.num_patches == jo.num_patches
    np.testing.assert_array_equal(to.get(), jo.get())
    rec = jo.get() + rng.normal(scale=20.0, size=jo.get().shape)
    for jm, tm in ((jp.mean_merger, tp.mean_merger), (jp.median_merger, tp.median_merger)):
        want = jo.set_and_merge(rec, merge_method=jm)
        got = to.set_and_merge(rec, merge_method=tm)
        np.testing.assert_array_equal(got, want)
        assert tp.psnr(clean, got) == jp.psnr(clean, want)
    noisy = clean + rng.normal(scale=10.0, size=clean.shape)
    noisy[0, 0] = np.nan
    assert tp.psnr(clean, noisy, data_range=200.0) == jp.psnr(clean, noisy, data_range=200.0)


@pytest.mark.parametrize("name", list(IMAGES))
def test_device_merger_matches_evo_tpu(name):
    clean, rng, jo, to = _setup(name)
    N, D = to.num_patches, to.get().shape[0]
    y = rng.standard_normal((N, D)).astype(np.float32) * 40.0
    dc = rng.standard_normal((N, 1)).astype(np.float32) * 100.0
    nb, pad = 2, 2 + N % 2  # two blocks with padding rows at the tail
    blocked = np.concatenate([y, np.full((pad, D), 123.456, np.float32)]).reshape(nb, -1, D)
    got = DeviceMerger(to, clean, device="cpu")(torch.from_numpy(blocked), torch.from_numpy(dc))
    j_dev = JDeviceMerger(jo, clean)(jnp.asarray(blocked), jnp.asarray(dc))
    rec = (y.astype(np.float64) + dc).T
    for key, merger in (("mean", jp.mean_merger), ("median", jp.median_merger)):
        host = jo.set_and_merge(rec, merge_method=merger)
        for want in (host, np.asarray(j_dev[key])):
            np.testing.assert_allclose(got[key].numpy(), want, rtol=0, atol=1e-5 * 255)
        assert abs(float(got[f"psnr_{key}"]) - jp.psnr(clean, host)) < 1e-3
        assert abs(float(got[f"psnr_{key}"]) - float(j_dev[f"psnr_{key}"])) < 1e-3


def test_stride_other_than_one_is_refused():
    clean = np.zeros((16, 16))
    with pytest.raises(ValueError, match="patch_shift"):
        DeviceMerger(tp.OverlappingPatches(clean, 4, 4, 2), clean, device="cpu")
