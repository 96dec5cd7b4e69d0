"""binning_idle_ms.render: ms a frame in which no device operation runs
within the "binning" stage, from ``saro/preprocess/end`` to
``saro/binning/end`` on the profiled segment's timeline (K2, the sort and
the binning's host read of the instance total)."""
from gsbench.common import spans


def read(ctx):
    return spans.idle_ms(ctx, spans.between(ctx.trace, "preprocess",
                                            "binning"))
