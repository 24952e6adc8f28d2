"""Image patches, their merge, PSNR and filter grids (counterpart:
evo_tpu/prepost/).

``patches``, ``metrics`` and ``viz`` are NumPy on the host;
``device_merge`` merges reconstructed patches and takes the PSNR on the
card."""

from evo_tpu_torch.prepost.metrics import psnr  # noqa: F401
from evo_tpu_torch.prepost.patches import (  # noqa: F401
    MultiDimOverlappingPatches,
    OverlappingPatches,
    extract_random_patches,
    mean_merger,
    median_merger,
)
from evo_tpu_torch.prepost.viz import make_grid, save_grid, scale  # noqa: F401
