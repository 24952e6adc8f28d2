"""Inverses of symmetric PD matrices.

Counterpart: evo_tpu/ops/linalg.py:88 ``pd_inverse_logdet`` and :114
``equilibrated_pd_inverse`` (the W and Psi updates, evo_tpu/models/bsc.py:
511-519 and evo_tpu/models/sssc.py:659-704).  evo_tpu inverts by a
lane-major Schur recursion because XLA's batched inverses are slow on a
TPU.  Here ``equilibrated_pd_inverse`` uses ``torch.linalg``, with the ridge
and the Jacobi equilibration that make the f32 solve safe kept as they
are, and ``pd_inverse_logdet`` is the elimination of the SSSC suffstat
kernel, so that the kernel's plain version fails where the kernel does.
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


def pd_inverse_logdet(A: torch.Tensor):
    """(inverse, log|det|) of batched symmetric PD matrices [..., H, H], by
    unpivoted Gauss-Jordan elimination, step for step as the SSSC
    suffstat kernel (csrc/sssc_suffstat.cu) inverts; log|det| is the sum of
    log|pivot| of the same elimination.

    The sign of the determinant is ignored, as in evo_tpu.  A zero pivot (a
    singular input, or a singular leading block of an indefinite one)
    gives non-finite values; it never raises.  evo_tpu's Schur recursion
    pairs the units in 2 x 2 blocks, so it also inverts an indefinite input
    whose first entry is zero but whose leading 2 x 2 block is regular;
    this elimination does not."""
    A = A.clone()
    n = A.shape[-1]
    piv = torch.empty(A.shape[:-1], dtype=A.dtype, device=A.device)
    for k in range(n):
        piv[..., k] = A[..., k, k]
        ip = 1.0 / piv[..., k]
        row = A[..., k, :] * ip[..., None]
        col = A[..., :, k].clone()
        A -= col[..., :, None] * row[..., None, :]
        A[..., k, :] = row
        A[..., :, k] = -col * ip[..., None]
        A[..., k, k] = ip
    return A, torch.log(piv.abs()).sum(-1)
