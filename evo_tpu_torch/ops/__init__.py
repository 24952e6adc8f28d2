"""Numerical building blocks and the CUDA kernels' wrappers
(counterpart: evo_tpu/ops/)."""

from evo_tpu_torch.ops.bitpack import dup_against, dup_within, eq_matrix, pack_states  # noqa: F401
from evo_tpu_torch.ops.numerics import (  # noqa: F401
    B_MAX,
    eps_lpj,
    free_energy_from_lpj,
    posterior_weights,
    reset_lpj,
    shifted_logsumexp,
)
