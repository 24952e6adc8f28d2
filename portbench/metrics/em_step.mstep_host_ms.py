"""em_step.mstep_host_ms: the host's self time in the em_step.mstep spans
(sum_over_ranks, the closed-form M-step and the epoch's statistics), ms
per epoch of the traced window."""

from portbench.programspans import self_ms


def read(ctx):
    return self_ms(ctx, "em_step.mstep", device=False)
