"""device_allocs_per_frame.render: device allocations (``cudaMalloc``s of
the caching allocator) a ``test_render`` unit, the port's counter
``device_allocs`` (a count)."""
from gsbench.common import spans


def read(ctx):
    return spans.per_unit(ctx, "device_allocs")
