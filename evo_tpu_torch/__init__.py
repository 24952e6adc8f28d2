"""evo_tpu_torch — the PyTorch/CUDA port of evo_tpu for NVIDIA Hopper.

A second package beside ``evo_tpu`` (which stays the reference): truncated
variational EM with evolutionary E-steps, written as eager PyTorch around
hand-written CUDA kernels for the hot paths.  Importing it imports neither
JAX nor ``evo_tpu``.

Entry points (``make_data``, ``init_states``, ``BSC``, ``SSSC``) run on the
CUDA card unless the caller passes ``device="cpu"``; the bars app
(``python -m evo_tpu_torch.apps.bars``) runs on the card unless
``EVO_PLATFORM=cpu`` is set.  TF32 is switched off
for the whole process: the Gram products feed cancellation-sensitive
quadratic forms and must be true f32 (evo_tpu/models/base.py:134-137 forces the
highest matmul precision for the same reason).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from evo_tpu_torch.models import (  # noqa: E402,F401
    BSC, SSSC, BSCParams, Data, SSSCParams, make_data)
from evo_tpu_torch.variational import EAConfig, EState, init_states  # noqa: E402,F401

__version__ = "0.1.0"
