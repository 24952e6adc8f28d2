"""The program's own spans and counters in the traced window, for the
per-layer readers.

``evo_tpu_torch.utils.tracing`` keeps a session's spans (name, begin and
end on the Unix clock in ns, host self time, device time and device self
time from CUDA events, counters) and markers in memory after the harness
closes it; the window is what lies between the harness's
``portbench.window:begin`` and ``:end`` markers.  A ctx may carry the
records itself (``ctx.records``).  A program without such records, a
window that holds none of a span, or device times on the CPU give None.
"""

from __future__ import annotations


def _records(ctx):
    recs = getattr(ctx, "records", None)
    if recs is not None:
        return recs
    try:
        from evo_tpu_torch.utils import tracing
    except ImportError:
        return None
    get = getattr(tracing, "records", None)
    return get() if get is not None else None


def window_spans(ctx):
    """The closed spans that lie wholly inside the window, or None."""
    recs = _records(ctx)
    if recs is None:
        return None
    marks = {}
    for t, name in recs.markers:
        marks.setdefault(name, t)
    lo, hi = marks.get("portbench.window:begin"), marks.get("portbench.window:end")
    if lo is None or hi is None:
        return None
    return [s for s in recs.spans if s.end_ns is not None and lo <= s.begin_ns and s.end_ns <= hi]


def self_ms(ctx, name: str, device: bool):
    """The self time (host, or device with ``device``) of the window's
    spans called ``name``, ms per epoch of the window."""
    spans = window_spans(ctx)
    if not spans or not ctx.epochs:
        return None
    if device:
        vals = [s.device_self_ms for s in spans if s.name == name]
    else:
        vals = [1e-6 * s.host_self_ns for s in spans if s.name == name]
    vals = [v for v in vals if v is not None]
    return sum(vals) / ctx.epochs if vals else None


def counter(ctx, name: str):
    """The sum of counter ``name`` over the window's spans, or None."""
    spans = window_spans(ctx)
    if not spans:
        return None
    vals = [s.counts[name] for s in spans if s.counts and name in s.counts]
    return sum(vals) if vals else None
