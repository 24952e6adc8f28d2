"""The arithmetic the reference runs in.

``Prec()`` is the reference: float64 everywhere.  ``Prec(torch.float32,
tf32=True)`` is the control of the check: the same reference in the
nearest precision below the program's (float32 with TF32 off), that is
float32 with every matrix product's operands rounded to TF32 (10 stored
mantissa bits, round to nearest even) and accumulated in float32, as the
H100's TF32 tensor cores compute.  The rounding is explicit so that the
control reads the same on the card and on the CPU.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (the low 13 mantissa bits cleared,
    ties to even), still stored as float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class Prec:
    def __init__(self, dtype=torch.float64, tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 rounds float32 operands")
        self.dtype, self.tf32 = dtype, tf32

    def t(self, x) -> torch.Tensor:
        return x.to(self.dtype) if isinstance(x, torch.Tensor) else torch.as_tensor(
            x, dtype=self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b (batched as torch.matmul)."""
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return torch.matmul(a, b)

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            ops = tuple(round_tf32(o) for o in ops)
        return torch.einsum(eq, *ops)
