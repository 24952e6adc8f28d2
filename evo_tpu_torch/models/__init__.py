"""Models (counterpart: evo_tpu/models/)."""

from evo_tpu_torch.models.base import (  # noqa: F401
    Data, StepStats, blockify, em_steps, epoch_generator, make_data, unblockify)
from evo_tpu_torch.models.bsc import BSC, BSCParams  # noqa: F401
from evo_tpu_torch.models.sssc import SSSC, SSSCParams  # noqa: F401
