"""Cut random patches from an image into the .npz file that the
feature-learning app reads (counterpart: examples/feature-learning/
get-patches.py).

    python -m evo_tpu_torch.apps.get_patches [--image_file F] [--patch_height 8]
        [--patch_width W] [--no_patches 2000] [--output_file ./data/patches.npz]
        [--seed 0]

Without --image_file the synthetic 256 x 256 image is cut.  Each patch has
its mean (DC component) removed; the file holds data [N, D] f32,
patch_height, patch_width and no_channels.  Runs on the host only: no card
is needed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from evo_tpu_torch.apps.images import get_image, synthetic_image
from evo_tpu_torch.prepost import extract_random_patches


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Extract random image patches",
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--image_file", type=str, required=False, default=None,
                   help="Image to extract patches from (synthetic if omitted)")
    p.add_argument("--patch_height", type=int, default=8)
    p.add_argument("--patch_width", type=int, default=None)
    p.add_argument("--no_patches", type=int, default=2000)
    p.add_argument("--output_file", type=str, default="./data/patches.npz")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def write_patches(args) -> np.ndarray:
    """Cut args.no_patches random patches of args.image_file (or of the
    synthetic 256 x 256 image) from args.seed, remove each one's mean and
    write them to args.output_file; returns the patches [N, D] f32."""
    pw = args.patch_width or args.patch_height
    img = get_image(args.image_file) if args.image_file else synthetic_image(256)
    C = 1 if img.ndim == 2 else img.shape[2]
    P = extract_random_patches(img[None], args.patch_height, pw, args.no_patches,
                               rng=np.random.default_rng(args.seed))
    P = (P - P.mean(axis=1, keepdims=True)).astype(np.float32)
    os.makedirs(os.path.dirname(args.output_file) or ".", exist_ok=True)
    np.savez(args.output_file, data=P, patch_height=args.patch_height, patch_width=pw,
             no_channels=C)
    print(f"Wrote {P.shape[0]} patches of dim {P.shape[1]} to {args.output_file}")
    return P


def main(argv=None):
    return write_patches(get_args(argv))


if __name__ == "__main__":
    main()
