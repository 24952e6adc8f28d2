"""trainer.callback_ms: the epoch callback (the image apps' merge on the
card, its read-back and log), ms per epoch of the window
(epoch_callback:begin -> :end)."""


def read(ctx):
    spans = ctx.spans.get("epoch_callback")
    return 1e3 * sum(spans) / ctx.epochs if spans else None
