"""masked_bsc.lpj_device_ms: the card's time in the bsc.masked_lpj spans
(the lpj of K^(n) and of the children under each datapoint's observed
entries, nested in em_step.lpj), ms per epoch of the traced window; None
where the program has no such span."""

from portbench.programspans import self_ms


def read(ctx):
    return self_ms(ctx, "bsc.masked_lpj", device=True)
