"""wide.lpj_device_ms: the card's time in the wide.lpj spans (each
sssc_lpj_wide call: the |s| groups and their chunks of batched solves,
nested in em_step.lpj), ms per epoch of the traced window; None where the
program has no such span."""

from portbench.programspans import self_ms


def read(ctx):
    return self_ms(ctx, "wide.lpj", device=True)
