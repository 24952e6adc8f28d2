"""Carry parameters, states and data between evo_tpu and the port.

No counterpart in evo_tpu.  The JAX side is reached only through NumPy:
anything with the right attributes (evo_tpu's ``BSCParams``,
``SSSCParams``, ``EState`` and ``Data``, or any object holding NumPy arrays
under those names) comes in, and plain dictionaries of NumPy arrays go out,
which evo_tpu's constructors take as keyword arguments after
``jnp.asarray``.  This module imports neither JAX nor evo_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from evo_tpu_torch._device import resolve_device
from evo_tpu_torch.models.base import Data
from evo_tpu_torch.models.bsc import BSCParams
from evo_tpu_torch.models.sssc import SSSCParams
from evo_tpu_torch.variational.state_init import EState


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def params_from_numpy(p, device=None) -> BSCParams:
    """BSC parameters (attributes W, pi, sigma, pies) -> port tensors."""
    dev = resolve_device(device)
    return BSCParams(W=_t(p.W, dev), pi=_t(p.pi, dev), sigma=_t(p.sigma, dev),
                     pies=_t(p.pies, dev))


def params_to_numpy(p: BSCParams) -> dict:
    return dict(W=_np(p.W), pi=_np(p.pi), sigma=_np(p.sigma), pies=_np(p.pies))


def sssc_params_from_numpy(p, device=None) -> SSSCParams:
    """SSSC parameters (attributes W, pies, mus, Psi, sigma2) -> port tensors."""
    dev = resolve_device(device)
    return SSSCParams(W=_t(p.W, dev), pies=_t(p.pies, dev), mus=_t(p.mus, dev),
                      Psi=_t(p.Psi, dev), sigma2=_t(p.sigma2, dev))


def sssc_params_to_numpy(p: SSSCParams) -> dict:
    return dict(W=_np(p.W), pies=_np(p.pies), mus=_np(p.mus), Psi=_np(p.Psi),
                sigma2=_np(p.sigma2))


def estate_from_numpy(e, device=None) -> EState:
    """State sets (attributes ss as 0/1 [nb, B, S, H], lpj) -> port tensors;
    the states become int8, and lane-major packed uint8 states stay so."""
    dev = resolve_device(device)
    ss = np.asarray(e.ss)
    return EState(ss=_t(ss if ss.dtype == np.uint8 else ss.astype(np.int8), dev),
                  lpj=_t(e.lpj, dev))


def estate_to_numpy(e: EState) -> dict:
    return dict(ss=_np(e.ss), lpj=_np(e.lpj))


def data_from_numpy(d, device=None) -> Data:
    """Blocked data (attributes y, x_infr, x, row_valid, incomplete)."""
    dev = resolve_device(device)
    return Data(y=_t(d.y, dev), x_infr=_t(d.x_infr, dev), x=_t(d.x, dev),
                row_valid=_t(d.row_valid, dev), incomplete=bool(d.incomplete))


def data_to_numpy(d: Data) -> dict:
    """Arrays of ``d``; ``incomplete`` is a keyword of evo_tpu's Data too."""
    return dict(y=_np(d.y), x_infr=_np(d.x_infr), x=_np(d.x),
                row_valid=_np(d.row_valid), incomplete=d.incomplete)
