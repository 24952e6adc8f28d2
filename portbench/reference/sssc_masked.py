"""Plain reference of one ES3C EM epoch on incomplete data where whole
patches can be flat: ``portbench/reference/sssc.py`` with each state's
lpj magnitude kept above zero.

A patch whose observed entries are all exactly 0 after DC centring (a
patch inside a flat region of an image) has the empty-state lpj
-||m y||^2 / (2 sigma2) = 0, and the only term it adds is 0, so the
magnitude that the comparison divides by is 0 as well.  Here that
magnitude is raised to the smallest normal float of its precision: a
state whose program and reference lpj agree exactly reads 0, and one that
differs by any amount reads far above every limit.  Every other number
(the lpj itself, the sums, Theta_{t+1}, F, the reconstruction, Theta^0,
the work counts) is the plain reference's own.
"""

from __future__ import annotations

import torch

from portbench.reference import sssc
from portbench.reference.sssc import (PARAMS, checked, epoch_work, finish,  # noqa: F401
                                      theta0, zero_sums)


def _floored(mag: torch.Tensor) -> torch.Tensor:
    return mag.clamp(min=torch.finfo(mag.dtype).tiny)


def lpj(y, m, ss, th, prec):
    lp, mag = sssc.lpj(y, m, ss, th, prec)
    return lp, _floored(mag)


def block(sums: dict, y, m, x, valid, ss, th, prec, incomplete: bool):
    lp, mag, y_rec = sssc.block(sums, y, m, x, valid, ss, th, prec, incomplete)
    return lp, _floored(mag), y_rec
