"""deform_preprocess_host_ms.render: host ms a frame from the benchmark's
"frame" mark before ``test_render`` to the port's "preprocess" mark: the
host's side of ``deform_preprocess_ms.render`` (the same marks' host
clock)."""
from gsbench.common import spans


def read(ctx):
    return spans.host_ms(ctx, ("preprocess",))
