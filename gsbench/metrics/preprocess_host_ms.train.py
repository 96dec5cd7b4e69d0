"""preprocess_host_ms.train: host ms a step of the port's "preprocess" and
"reduce_preprocess_backward" stages: the host's side of
``preprocess_ms.train`` (the same marks' host clock)."""
from gsbench.common import spans


def read(ctx):
    return spans.host_ms(ctx, ("preprocess", "reduce_preprocess_backward"))
