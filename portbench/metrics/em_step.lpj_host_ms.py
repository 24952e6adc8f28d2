"""em_step.lpj_host_ms: the host's self time in the em_step.lpj spans
(block_gram and every lpj_block call: the lpj of K^(n) and, nested in the
EA, of its children, with the kernel call and reset_lpj), ms per epoch of
the traced window."""

from portbench.programspans import self_ms


def read(ctx):
    return self_ms(ctx, "em_step.lpj", device=False)
