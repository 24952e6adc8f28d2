"""The traced run's short stretch under torch.profiler, reduced to numbers.

The stretch is recorded with host and device activity and exported as a
Chrome trace; this module reads that file.  Device time is the union of
the intervals of the kernels, copies and sets on the card (one stream, so
they do not overlap, but the union is taken all the same); the stretch's
wall time is that of the ``portbench.stretch`` annotation.  Idle gaps are
the stretch's intervals with nothing on the card, each labelled by the
harness's host span it falls in (``em_step``, ``log``, ``epoch_callback``,
else the trainer's loop) and the innermost host op running then.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

from portbench.reference.bounds import is_port_kernel, kernel_name

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
STRETCH = "portbench.stretch"
SPANS = ("em_step", "log", "epoch_callback")


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _containing(events, starts, t, limit=4000):
    """The innermost event of ``events`` (sorted by start, nested) holding
    t: the latest-starting one whose interval holds it."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - limit), -1):
        a, b, name = events[j]
        if b >= t:
            return name
    return None


def summarize(path: str) -> dict:
    """{stretch_s, busy_s, port_kernel_s, other_device_s, device_ops,
    idle_gaps} of the Chrome trace at ``path`` (seconds)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dev, spans, ops, stretch = [], [], [], None
    for e in events:
        cat = str(e.get("cat", "")).lower()
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((a, b, e["name"]))
        elif cat == "user_annotation" and e["name"] == STRETCH:
            stretch = (a, b)
        elif cat == "user_annotation" and e["name"] in SPANS:
            spans.append((a, b, e["name"]))
        elif cat == "cpu_op":
            ops.append((a, b, e["name"]))
    if not dev:
        return {}
    if stretch is None:
        stretch = (min(a for a, _, _ in dev), max(b for _, b, _ in dev))
    lo, hi = stretch
    dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev if b > lo and a < hi]
    busy = _union([(a, b) for a, b, _ in dev])
    by_name = defaultdict(float)
    port = other = 0.0
    for a, b, name in dev:
        d = (b - a) * 1e-6
        by_name[kernel_name(name)[:80]] += d
        if is_port_kernel(name):
            port += d
        else:
            other += d
    spans.sort()
    ops.sort()
    span_starts, op_starts = [a for a, _, _ in spans], [a for a, _, _ in ops]
    gaps = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = ((_containing(spans, span_starts, mid) or "trainer loop") + ": "
                 + (_containing(ops, op_starts, mid) or "-"))
        gaps[label] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return dict(stretch_s=(hi - lo) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
                port_kernel_s=port, other_device_s=other, device_ops=top(by_name),
                idle_gaps=top(gaps))
