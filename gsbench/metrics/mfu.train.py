"""mfu.train: a step's operations (heads forward and backward over the
live rows and views, the preprocess, the field's taps and K4's scatter,
K1's and K3's pairs, SSIM, Adam; counted by the benchmark) at the
window's step rate, against the card's float32 peak."""
from gsbench.common import counts


def read(ctx):
    flops = ctx.counts.get("flops_per_unit")
    if not flops or ctx.window["seconds"] <= 0:
        return None
    rate = ctx.window["units"] / ctx.window["seconds"]
    return 100.0 * (sum(flops) / len(flops)) * rate / counts.PEAK_F32
