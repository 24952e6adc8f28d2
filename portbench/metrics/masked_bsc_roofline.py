"""masked_bsc_roofline: the least time of EBSC's lpj work on incomplete
data (the bsc.masked_lpj spans' data entries, states and residuals, from
their counters through portbench/reference/masked_bsc_bounds.py) over the
card's time in the bsc.gram and bsc.masked_lpj spans, in %.  None without
a card's peaks or where the program has no bsc.masked_lpj span."""

from portbench.programspans import window_spans
from portbench.reference import masked_bsc_bounds


def read(ctx):
    spans = window_spans(ctx)
    if not spans or ctx.peaks is None:
        return None
    mine = [s for s in spans if s.name in masked_bsc_bounds.SPANS]
    counts = {}
    for s in mine:
        if s.name == "bsc.masked_lpj":
            for k, v in (s.counts or {}).items():
                counts[k] = counts.get(k, 0) + v
    device_ms = sum(s.device_ms for s in mine if s.device_ms is not None)
    if not counts or not device_ms:
        return None
    return 100.0 * masked_bsc_bounds.least_seconds(counts, ctx.peaks) / (1e-3 * device_ms)
