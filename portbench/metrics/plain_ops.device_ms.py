"""plain_ops.device_ms: device time of every operation on the card that is
not one of the port's kernels (gathers, sorts, reductions, cuBLAS, copies),
ms per epoch of the profiled stretch."""


def read(ctx):
    p = ctx.profile
    return 1e3 * p["other_device_s"] / ctx.profile_epochs if p else None
