"""k1_roofline.render: K1's share of its roofline over the traced frames:
the least time the card could take for the pairs these frames need
(counted on the reference's path) over the profiler's device time of K1's
kernel."""
from gsbench.common import counts, trace


def read(ctx):
    work = ctx.counts.get("k1")
    t = trace.kernel_s(ctx.trace, counts.KERNELS["K1"])
    if not work or t <= 0:
        return None
    return 100.0 * sum(counts.bound_s(f, b) for f, b in work) / t
