"""trainer.stats_wait_ms: the host's time blocked in the trainer's stats
transfer, waiting for the card to drain the epoch (its stats_wait:begin ->
:end span lines), ms per epoch of the window."""


def read(ctx):
    spans = ctx.spans.get("stats_wait")
    return 1e3 * sum(spans) / ctx.epochs if spans and ctx.epochs else None
