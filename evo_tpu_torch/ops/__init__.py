"""Numerical building blocks and the CUDA kernels' wrappers
(counterpart: evo_tpu/ops/)."""
