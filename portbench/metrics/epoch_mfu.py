"""epoch_mfu: an epoch's counted f32 operations (the port kernels' work
from the states evaluated, plus the dense products from the shapes) over
the card's peak f32 rate times the traced window's seconds per epoch,
in %."""


def read(ctx):
    if ctx.peaks is None or not ctx.epochs:
        return None
    return 100.0 * ctx.f32_per_epoch / (ctx.peaks[0] * ctx.window_s / ctx.epochs)
