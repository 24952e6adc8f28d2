"""wide_roofline: the least time that the wide path's solves need (per
span kind, the larger of their bytes over the peak bandwidth and their
operations over the peak rate, from the counters of the window's wide.lpj
and wide.suffstat spans through portbench/reference/wide_bounds.py) over
the card's time in those spans, in %.  None without a card's peaks or
where the program has no such span."""

from portbench.programspans import window_spans
from portbench.reference import wide_bounds


def read(ctx):
    spans = window_spans(ctx)
    if not spans or ctx.peaks is None:
        return None
    least = device_ms = 0.0
    for name in wide_bounds.WORK:
        mine = [s for s in spans if s.name == name]
        counts = {}
        for s in mine:
            for k, v in (s.counts or {}).items():
                counts[k] = counts.get(k, 0) + v
        ms = [s.device_ms for s in mine if s.device_ms is not None]
        if counts and ms:
            least += wide_bounds.least_seconds(name, counts, ctx.peaks)
            device_ms += sum(ms)
    return 100.0 * least / (1e-3 * device_ms) if device_ms else None
