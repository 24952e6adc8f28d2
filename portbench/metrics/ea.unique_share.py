"""ea.unique_share: the EA's new unique children over the children it
evaluated (the trainer's ea.unique and ea.children counters) in the traced
window, in %.  The seed and the EA fix it; its complement is the children's
lpj work that is thrown away."""

from portbench.programspans import counter


def read(ctx):
    children, unique = counter(ctx, "ea.children"), counter(ctx, "ea.unique")
    if not children or unique is None:
        return None
    return 100.0 * unique / children
