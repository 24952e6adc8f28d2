"""Device policy of the port (no counterpart in evo_tpu, where JAX picks
the backend).

Entry points run on the CUDA card unless the caller asks for the CPU: a
``device`` of None means ``"cuda"``, and asking for CUDA where there is no
card raises instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
