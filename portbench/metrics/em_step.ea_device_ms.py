"""em_step.ea_device_ms: the card's self time in the em_step.ea spans
(evolve_states_block: selection, mutation and the dedup keys; the
children's lpj is an em_step.lpj span inside): stream time between each
span's CUDA events less its children's, ms per epoch of the traced window."""

from portbench.programspans import self_ms


def read(ctx):
    return self_ms(ctx, "em_step.ea", device=True)
