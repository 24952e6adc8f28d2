"""window.epoch_ms_p95: the 95th percentile of the traced run's epoch
times in its window, in ms: epoch_ms_p95, read per layer where epoch_ms is
(see window.epoch_ms)."""

import statistics


def read(ctx):
    d = ctx.durations
    if not d:
        return None
    return 1e3 * (statistics.quantiles(d, n=20)[-1] if len(d) > 1 else d[0])
