"""deform_host_ms.train: host ms a step of the port's "deform" and
"deform_backward" stages: the host's side of ``deform_ms.train`` (the same
marks' host clock)."""
from gsbench.common import spans


def read(ctx):
    return spans.host_ms(ctx, ("deform", "deform_backward"))
