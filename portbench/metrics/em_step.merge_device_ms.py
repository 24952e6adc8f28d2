"""em_step.merge_device_ms: the card's self time (stream time between the
span's CUDA events, less its children's) in the em_step.merge spans
(merge_states: the children merged into K^(n)), ms per epoch of the traced
window."""

from portbench.programspans import self_ms


def read(ctx):
    return self_ms(ctx, "em_step.merge", device=True)
