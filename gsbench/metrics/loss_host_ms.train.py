"""loss_host_ms.train: host ms a step of the port's "loss" and
"loss_backward" stages: the host's side of ``loss_ms.train`` (the same
marks' host clock)."""
from gsbench.common import spans


def read(ctx):
    return spans.host_ms(ctx, ("loss", "loss_backward"))
