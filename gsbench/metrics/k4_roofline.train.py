"""k4_roofline.train: K4's share of its roofline over the traced steps: the
least time for each plane's scatter of the field's gradient over the live
rows (bytes of the taps' inputs and of the pyramid) over the profiler's
device time of K4's kernels."""
from gsbench.common import counts, trace


def read(ctx):
    work = ctx.counts.get("k4")
    t = trace.kernel_s(ctx.trace, counts.KERNELS["K4"])
    if not work or t <= 0:
        return None
    return 100.0 * sum(counts.bound_s(f, b) for step in work
                       for f, b in step) / t
