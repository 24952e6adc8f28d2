"""kernels_roofline: the least time the port's kernels' work needs (the
larger of its bytes over the peak bandwidth and its operations over the
peak rates, per call, from the states evaluated) over the device time the
port's kernels took in the profiled stretch, in %."""


def read(ctx):
    p = ctx.profile
    if not p or not p["port_kernel_s"] or ctx.kernel_bound_s is None:
        return None
    return 100.0 * ctx.kernel_bound_s * ctx.profile_epochs / p["port_kernel_s"]
