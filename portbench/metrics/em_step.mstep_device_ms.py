"""em_step.mstep_device_ms: the card's self time (stream time between the
span's CUDA events, less its children's) in the em_step.mstep spans
(sum_over_ranks, the closed-form M-step and the epoch's statistics), ms
per epoch of the traced window."""

from portbench.programspans import self_ms


def read(ctx):
    return self_ms(ctx, "em_step.mstep", device=True)
