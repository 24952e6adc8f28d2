"""The yardstick of EBSC's lpj on incomplete data: the least time of the
work in the spans ``bsc.masked_lpj`` (each state's lpj under its own
datapoint's observed entries), from their counters.

What every exact implementation has to do, whatever way it takes:

- read each datapoint's data entries, an f32 value and a one-byte mask,
  5 bytes an entry, for every ``bsc.masked_lpj`` row (the counter
  ``bsc.masked_lpj_cells``, B D a call);
- read each state, one byte a unit, and write its lpj, H + 4 bytes a state
  (``bsc.masked_lpj_units``, B K H, and ``bsc.masked_lpj_states``, B K);
- form each state's residual over the datapoint's entries, 2 D f32
  operations a state (D is ``masked_lpj_cells`` over ``masked_lpj_rows``).

No operation or byte of the per-datapoint Gram G_n = W^T diag(m_n) W is
counted, nor its build in the spans ``bsc.gram``: an implementation that
takes ||m (y - W_A s)||^2 from the state's active columns never forms it.
W, read once a call, is not counted either.  The time of the spans
``bsc.gram`` is measured beside the lpj's (``SPANS``), so such an
implementation is held to the same work.

The count depends only on the shapes and the states evaluated, never on
the code that evaluates them.
"""

from __future__ import annotations

from portbench.reference import bounds

BYTES_PER_CELL = 5  # an f32 observed value and a one-byte mask
LPJ_BYTES = 4  # the f32 lpj written for each state

# the spans whose device time the work is held against
SPANS = ("bsc.gram", "bsc.masked_lpj")


def work(counts: dict) -> dict:
    """{f32, int, bytes} of the bsc.masked_lpj spans whose counters sum to
    ``counts``."""
    rows = counts.get("bsc.masked_lpj_rows", 0)
    states = counts.get("bsc.masked_lpj_states", 0)
    cells = counts.get("bsc.masked_lpj_cells", 0)
    units = counts.get("bsc.masked_lpj_units", 0)
    D = cells / rows if rows else 0.0
    return dict(f32=2.0 * D * states, int=0,
                bytes=float(BYTES_PER_CELL * cells + units + LPJ_BYTES * states))


def least_seconds(counts: dict, peaks) -> float:
    """Least time on a card with ``peaks`` (``bounds.PEAKS``' entry) of the
    bsc.masked_lpj spans whose counters sum to ``counts``."""
    return bounds.seconds(work(counts), peaks)
