"""window.epoch_ms: the traced run's window over the EM epochs it
completed, in ms: epoch_ms, read per layer in cells whose host-bound epoch
spreads too widely from run to run to hold a bound end to end."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.epochs if ctx.epochs else None
