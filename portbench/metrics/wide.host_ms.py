"""wide.host_ms: the host's self time in the wide.lpj and wide.suffstat
spans (the launch stream of the groups' solves and the waits of their
group syncs), ms per epoch of the traced window; None where the program
has neither span."""

from portbench.programspans import self_ms


def read(ctx):
    vals = [v for v in (self_ms(ctx, name, device=False) for name in ("wide.lpj", "wide.suffstat"))
            if v is not None]
    return sum(vals) if vals else None
