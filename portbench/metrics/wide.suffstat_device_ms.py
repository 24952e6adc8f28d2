"""wide.suffstat_device_ms: the card's time in the wide.suffstat spans
(each sssc_suffstat_wide call: the merged states re-solved and their
moments, nested in em_step.suffstat), ms per epoch of the traced window;
None where the program has no such span."""

from portbench.programspans import self_ms


def read(ctx):
    return self_ms(ctx, "wide.suffstat", device=True)
