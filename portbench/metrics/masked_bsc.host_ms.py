"""masked_bsc.host_ms: the host's self time in the bsc.gram and
bsc.masked_lpj spans (the launches of the Gram's build and of the masked
lpj, run eagerly block by block), ms per epoch of the traced window; None
where the program has neither span."""

from portbench.programspans import self_ms

SPANS = ("bsc.gram", "bsc.masked_lpj")


def read(ctx):
    vals = [v for v in (self_ms(ctx, name, device=False) for name in SPANS) if v is not None]
    return sum(vals) if vals else None
