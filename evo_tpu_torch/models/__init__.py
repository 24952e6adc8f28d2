"""Models (counterpart: evo_tpu/models/)."""

from evo_tpu_torch.models.base import Data, StepStats, make_data  # noqa: F401
from evo_tpu_torch.models.bsc import BSC, BSCParams  # noqa: F401
from evo_tpu_torch.models.sssc import SSSC, SSSCParams  # noqa: F401
