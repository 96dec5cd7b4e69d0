"""k3_roofline.train: K3's share of its roofline over the traced steps:
the least time for the replayed and contributing pairs these views need
(counted on the reference's path) over the profiler's device time of K3's
kernel."""
from gsbench.common import counts, trace


def read(ctx):
    work = ctx.counts.get("k3")
    t = trace.kernel_s(ctx.trace, counts.KERNELS["K3"])
    if not work or t <= 0:
        return None
    return 100.0 * sum(counts.bound_s(f, b) for f, b in work) / t
