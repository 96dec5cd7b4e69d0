"""k5_roofline.train: K5's share of its roofline over the traced steps: the
least time for each view's SSIM forward and backward (the images' bytes
and the forward's operations) over the profiler's device time of K5's
three kernels."""
from gsbench.common import counts, trace


def read(ctx):
    work = ctx.counts.get("k5")
    t = trace.kernel_s(ctx.trace, counts.KERNELS["K5"])
    if not work or t <= 0:
        return None
    return 100.0 * sum(counts.bound_s(f, b) for view in work
                       for f, b in view) / t
