"""backward_idle_ms.train: ms a step in which no device operation runs
within the port's ``saro/backward`` ranges (each view's
``torch.autograd.grad``: K3, the reduce, the preprocess chain's and the
heads' backward) on the profiled segment's timeline."""
from gsbench.common import spans


def read(ctx):
    return spans.idle_ms(ctx, spans.ranges(ctx.trace, "backward"))
