"""The evolutionary E-step (counterpart: evo_tpu/variational/)."""

from evo_tpu_torch.variational.config import EAConfig  # noqa: F401
from evo_tpu_torch.variational.state_init import EState, init_states  # noqa: F401
