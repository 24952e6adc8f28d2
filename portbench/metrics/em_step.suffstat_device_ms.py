"""em_step.suffstat_device_ms: the card's self time (stream time between the
span's CUDA events, less its children's) in the em_step.suffstat spans
(each block's F term, responsibilities, suffstat kernel, reconstruction
and M-step sums), ms per epoch of the traced window."""

from portbench.programspans import self_ms


def read(ctx):
    return self_ms(ctx, "em_step.suffstat", device=True)
