"""masked_bsc.gram_device_ms: the card's time in the bsc.gram spans (each
datapoint's Gram G_n built for the block on EBSC's incomplete data, nested
in em_step.lpj), ms per epoch of the traced window; None where the program
has no such span."""

from portbench.programspans import self_ms


def read(ctx):
    return self_ms(ctx, "bsc.gram", device=True)
