"""mfu.render: a frame's operations (the heads and the preprocess over the
live rows, K1's pairs; counted by the benchmark) at the window's frame
rate, against the card's float32 peak."""
from gsbench.common import counts


def read(ctx):
    flops = ctx.counts.get("flops_per_unit")
    if not flops or ctx.window["seconds"] <= 0:
        return None
    rate = ctx.window["units"] / ctx.window["seconds"]
    return 100.0 * (sum(flops) / len(flops)) * rate / counts.PEAK_F32
