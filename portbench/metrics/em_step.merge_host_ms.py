"""em_step.merge_host_ms: the host's self time in the em_step.merge spans
(merge_states: the children merged into K^(n)), ms per epoch of the traced
window."""

from portbench.programspans import self_ms


def read(ctx):
    return self_ms(ctx, "em_step.merge", device=False)
