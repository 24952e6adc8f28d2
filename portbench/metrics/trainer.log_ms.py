"""trainer.log_ms: the trainer's DataLog line, ms per epoch of the window
(its log:begin -> log:end tracepoints)."""


def read(ctx):
    spans = ctx.spans.get("log")
    return 1e3 * sum(spans) / ctx.epochs if spans else None
