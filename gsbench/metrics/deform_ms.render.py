"""deform_ms.render: ms a frame of the port's "deform" span in
``test_render`` (the heads at the frame's time and the active mask;
stream time between CUDA events)."""
from gsbench.common import spans


def read(ctx):
    return spans.span_ms(ctx, "deform")
