"""busy_ms.render: ms a frame in which an operation runs on the device: the
union of the device operations' intervals on the profiled segment's
timeline, over its frames.  Steadier than the host-clock rates, which
move with the host's speed."""
from gsbench.common import trace


def read(ctx):
    if not ctx.trace["device"] or not ctx.units:
        return None
    return 1e3 * trace.busy_s(ctx.trace) / ctx.units
