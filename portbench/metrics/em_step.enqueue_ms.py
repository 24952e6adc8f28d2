"""em_step.enqueue_ms: the host's time in each em_step call of the window,
from the call to its return (before the stats transfer waits for the
card), mean in ms: the host's launch cost of an epoch."""


def read(ctx):
    return 1e3 * sum(ctx.enqueue) / len(ctx.enqueue) if ctx.enqueue else None
