"""wide.gram_device_ms: the card's time in the wide.gram spans (each
datapoint's Gram G_n built for the block on incomplete data on the wide
path, nested in em_step.lpj), ms per epoch of the traced window; None
where the program has no such span."""

from portbench.programspans import self_ms


def read(ctx):
    return self_ms(ctx, "wide.gram", device=True)
