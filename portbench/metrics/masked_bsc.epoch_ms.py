"""masked_bsc.epoch_ms: the traced run's window over the EM epochs it
completed, in ms, as masked_wide.epoch_ms reads it: the epoch of the cell
that runs EBSC on incomplete data, read per layer until a benchmark change
adds the cell to epoch_ms."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.epochs if ctx.epochs else None
