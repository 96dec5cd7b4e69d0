"""device_allocs_per_step.train: device allocations (``cudaMalloc``s of the
caching allocator) a ``train_step`` unit, the port's counter
``device_allocs`` (a count)."""
from gsbench.common import spans


def read(ctx):
    return spans.per_unit(ctx, "device_allocs")
