"""masked_wide_roofline: the least time of ES3C's wide work on incomplete
data (the bytes of the wide.gram spans and the solves of the wide.lpj and
wide.suffstat spans, from their counters through
portbench/reference/masked_wide_bounds.py) over the card's time in those
spans, in %.  None without a card's peaks or where the program has no
wide.gram span."""

from portbench.programspans import window_spans
from portbench.reference import masked_wide_bounds


def read(ctx):
    spans = window_spans(ctx)
    if not spans or ctx.peaks is None or not any(s.name == "wide.gram" for s in spans):
        return None
    least = device_ms = 0.0
    for name in masked_wide_bounds.SPANS:
        mine = [s for s in spans if s.name == name]
        counts = {}
        for s in mine:
            for k, v in (s.counts or {}).items():
                counts[k] = counts.get(k, 0) + v
        ms = [s.device_ms for s in mine if s.device_ms is not None]
        if counts and ms:
            least += masked_wide_bounds.least_seconds(name, counts, ctx.peaks)
            device_ms += sum(ms)
    return 100.0 * least / (1e-3 * device_ms) if device_ms else None
