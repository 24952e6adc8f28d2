"""em_step.suffstat_host_ms: the host's self time in the em_step.suffstat
spans (each block's F term, responsibilities, suffstat kernel,
reconstruction and M-step sums), ms per epoch of the traced window."""

from portbench.programspans import self_ms


def read(ctx):
    return self_ms(ctx, "em_step.suffstat", device=False)
