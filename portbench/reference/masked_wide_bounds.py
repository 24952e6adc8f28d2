"""The yardstick of ES3C's wide path on incomplete data: the least time of
the spans ``wide.gram`` (each datapoint's Gram G_n = W^T diag(m_n) W for
the block), ``wide.lpj`` and ``wide.suffstat``.

- ``wide.gram``: the bytes that every implementation has to read, each
  datapoint's observed values and its mask, 4 + 1 bytes a data entry,
  from the counter ``wide.gram_cells`` (the entries read, B D).  No Gram
  operations and no bytes of G_n are counted: an implementation that
  never forms G_n (each state's G_AA from W_A and the mask) does far
  fewer of both, and W, read once a call, is not counted either.
- ``wide.lpj`` and ``wide.suffstat``: the solves, as
  ``portbench/reference/wide_bounds.py`` counts them (imported, not
  changed).  Their gathers of G_AA out of G_n are not counted, for the
  same reason as the Gram.

The count depends only on the shapes and the states solved, never on the
code that solves them.
"""

from __future__ import annotations

from portbench.reference import bounds, wide_bounds

BYTES_PER_CELL = 5  # an f32 observed value and a one-byte mask


def gram(cells) -> dict:
    """Work of the wide.gram spans over ``cells`` data entries: {f32, int, bytes}."""
    return dict(f32=0.0, int=0, bytes=float(BYTES_PER_CELL * cells))


SPANS = ("wide.gram",) + tuple(wide_bounds.WORK)


def least_seconds(span: str, counts: dict, peaks) -> float:
    """Least time on a card with ``peaks`` (``bounds.PEAKS``' entry) of the
    spans ``span`` whose counters sum to ``counts``."""
    if span == "wide.gram":
        return bounds.seconds(gram(counts.get("wide.gram_cells", 0)), peaks)
    return wide_bounds.least_seconds(span, counts, peaks)
