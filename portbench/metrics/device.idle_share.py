"""device.idle_share: the share of the profiled stretch's wall time in
which nothing ran on the card, in %."""


def read(ctx):
    p = ctx.profile
    if not p or not p["stretch_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["stretch_s"])
