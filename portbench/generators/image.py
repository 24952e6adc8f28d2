"""Image denoising and inpainting through the image apps' own set-up.

Traffic keys: ``task`` ("denoising": additive Gaussian noise of std
``noise``; "inpainting": a share ``missing`` of the entries missing
completely at random), ``image`` (``{"kind": "rgb", "height": h,
"width": w}``, a piecewise-smooth colour image drawn from the seed, or
``{"kind": "gray", "size": n}``, the apps' own synthetic grayscale image),
``merge_every`` (epochs between merges; the first epoch merges too).  The
noise or the missing entries are drawn with NumPy from the seed.  The
program gets the corrupted image through ``apps.images.build`` and its
epoch callback through ``make_epoch_callback`` (no visualizer); the
reference gets the clean and the corrupted image.
"""

from __future__ import annotations

import numpy as np

from portbench.generators.common import ea_flags

NO_EPOCHS = 10**9  # the harness ends the run; no epoch is the apps' last


def rgb_image(h: int, w: int, seed: int) -> np.ndarray:
    """A piecewise-smooth RGB image [h, w, 3] in [0, 255] from ``seed``: a
    smooth colour field per channel, six flat rectangles, a shaded triangle
    and a little pixel noise (frozen copy of chip_smoke.py:synthetic_image,
    :1349)."""
    c = 3
    rng = np.random.default_rng(seed)
    i, j = np.mgrid[0:h, 0:w].astype(float) / max(h, w)
    img = np.empty((h, w, c))
    for ch in range(c):
        f1, f2 = rng.uniform(1.5, 4.0, 2)
        p1, p2 = rng.uniform(0, 2 * np.pi, 2)
        img[..., ch] = 110 + 70 * np.cos(f1 * np.pi * i + p1) * np.sin(f2 * np.pi * j + p2)
    for _ in range(6):
        r0, c0 = rng.integers(0, 2 * h // 3), rng.integers(0, 2 * w // 3)
        img[r0:r0 + rng.integers(h // 16, h // 3), c0:c0 + rng.integers(w // 16, w // 3)] = \
            rng.uniform(20, 235, c)
    tri = i + j < 0.35
    img[tri] = (160 - 200 * (i + j)[tri])[:, None] * rng.uniform(0.6, 1.0, c)
    return np.clip(img + rng.normal(scale=2.0, size=img.shape), 0, 255)


def gray_image(size: int) -> np.ndarray:
    """The image apps' synthetic grayscale image [size, size] in [0, 255]
    (frozen copy of evo_tpu_torch/apps/images.py:synthetic_image)."""
    i, j = np.mgrid[0:size, 0:size].astype(float) / size
    img = 90 + 100 * np.cos(3.1 * i) * np.sin(2.3 * j)
    img[int(0.2 * size):int(0.55 * size), int(0.25 * size):int(0.6 * size)] = 210
    img[int(0.3 * size):int(0.45 * size), int(0.35 * size):int(0.5 * size)] = 40
    tri = (i + j < 0.5)
    img[tri] = 160 - 120 * (i + j)[tri]
    return np.clip(img, 0, 255)


def inputs(traffic: dict, seed: int):
    """(clean, corrupted) images."""
    im = traffic["image"]
    clean = (rgb_image(im["height"], im["width"], seed) if im["kind"] == "rgb"
             else gray_image(im["size"]))
    rng = np.random.default_rng(seed)
    if traffic["task"] == "inpainting":
        corrupted = clean.copy()
        corrupted[rng.random(clean.shape) < traffic["missing"]] = np.nan
    elif traffic["task"] == "denoising":
        corrupted = clean + rng.normal(scale=traffic["noise"], size=clean.shape)
    else:
        raise ValueError(f"unknown task {traffic['task']!r}")
    return clean, corrupted


def make(traffic: dict, config: dict, seed: int, device, world: int = 1) -> dict:
    from evo_tpu_torch.apps import images

    clean, corrupted = inputs(traffic, seed)
    args = images.get_args([traffic["task"], config["app_algo"], *ea_flags(config),
                            "--patch_height", str(config["patch"]),
                            "--merge_every", str(traffic["merge_every"]),
                            "--no_epochs", str(NO_EPOCHS), "--seed", str(seed)])
    inpainting = traffic["task"] == "inpainting"
    keep = images.observed(corrupted, args) if inpainting else None
    b = images.build(args, clean, corrupted, keep, device)

    def make_callback(dlog):
        return images.make_epoch_callback(args, b, clean, dlog, device)[0]

    return dict(model=b["model"], data=b["data"], params=b["params"], cfg=b["cfg"],
                estate=b["estate"], reconstruct_at=b["reconstruct_at"],
                make_callback=make_callback, merge_every=traffic["merge_every"],
                init_seed=seed, ref=dict(Y=None, image=dict(
                    task=traffic["task"], clean=clean, corrupted=corrupted,
                    patch=config["patch"])))
