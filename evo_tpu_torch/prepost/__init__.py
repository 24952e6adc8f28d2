"""Image patches, their merge and PSNR (counterpart: evo_tpu/prepost/).

``patches`` and ``metrics`` are NumPy on the host; ``device_merge`` merges
reconstructed patches and takes the PSNR on the card."""

from evo_tpu_torch.prepost.metrics import psnr  # noqa: F401
from evo_tpu_torch.prepost.patches import (  # noqa: F401
    MultiDimOverlappingPatches,
    OverlappingPatches,
    mean_merger,
    median_merger,
)
