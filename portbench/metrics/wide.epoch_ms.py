"""wide.epoch_ms: the traced run's window over the EM epochs it completed,
in ms, as window.epoch_ms reads it: the epoch of the cell that runs ES3C
on the wide path, read per layer until its spread is known."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.epochs if ctx.epochs else None
