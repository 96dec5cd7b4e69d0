"""idle_share.train: the share of a step in which no device operation runs: the
device's busy time a step (the union of the operations' intervals on the
profiled segment's timeline, over its steps) against the time a step
of the timed window (the profiler's own overhead slows the host, so the
profiled segment's length would overstate the idle time)."""
from gsbench.common import trace


def read(ctx):
    if not ctx.trace["device"] or not ctx.window["units"]:
        return None
    busy = trace.busy_s(ctx.trace) / ctx.units
    return 100.0 * (1.0 - busy * ctx.window["units"] / ctx.window["seconds"])
