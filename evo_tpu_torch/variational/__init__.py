"""The evolutionary E-step (counterpart: evo_tpu/variational/)."""

from evo_tpu_torch.variational.config import EAConfig  # noqa: F401
from evo_tpu_torch.variational.evolve import evolve_states  # noqa: F401
from evo_tpu_torch.variational.mutation import (  # noqa: F401
    cross,
    cross_randflip,
    cross_sparseflip,
    randflip,
    sparseflip,
)
from evo_tpu_torch.variational.selection import fitparents, randparents  # noqa: F401
from evo_tpu_torch.variational.state_init import (  # noqa: F401
    EState, full_state_matrix, init_states)
from evo_tpu_torch.variational.varykn import vary_Kn, vary_Kn_whole_set  # noqa: F401
