"""masked_wide.host_ms: the host's self time in the wide.gram, wide.lpj
and wide.suffstat spans (the Gram's launches, the launch stream of the
groups' solves and the waits of their group syncs), ms per epoch of the
traced window; None where the program has no wide.gram span."""

from portbench.programspans import self_ms

SPANS = ("wide.gram", "wide.lpj", "wide.suffstat")


def read(ctx):
    if self_ms(ctx, "wide.gram", device=False) is None:
        return None
    return sum(v for v in (self_ms(ctx, name, device=False) for name in SPANS) if v is not None)
