"""Inverse of the M-step's symmetric PSD matrix.

Counterpart: evo_tpu/ops/linalg.py:114 ``equilibrated_pd_inverse`` (used by
the W update, evo_tpu/models/bsc.py:511-519).  evo_tpu inverts by a
lane-major Schur recursion because XLA's batched inverses are slow on a TPU;
here the matrix is a single [H, H] and ``torch.linalg.inv`` does the job.
The ridge and the Jacobi equilibration, which make the f32 solve safe, are
kept as they are.
"""

from __future__ import annotations

import torch


def equilibrated_pd_inverse(A: torch.Tensor, rel_ridge: float = 0.0) -> torch.Tensor:
    """Inverse of a symmetric PSD matrix [..., H, H]: an optional relative
    Tikhonov ridge (rel_ridge * mean diagonal), then Jacobi equilibration
    D A D with D = diag(A)^(-1/2) before the inverse."""
    H = A.shape[-1]
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    if rel_ridge:
        ridge = rel_ridge * diag.mean(dim=-1, keepdim=True)
        A = A + ridge[..., None] * torch.eye(H, dtype=A.dtype, device=A.device)
        diag = diag + ridge
    d = 1.0 / torch.sqrt(torch.clamp(diag, min=torch.finfo(A.dtype).tiny))
    An = A * d[..., :, None] * d[..., None, :]
    return torch.linalg.inv(An) * d[..., :, None] * d[..., None, :]
