"""instances_per_step.train: instances a step over its views, the port's
counter ``instances`` (each view's ``num_instances``, which K3 replays;
a count)."""
from gsbench.common import spans


def read(ctx):
    return spans.per_unit(ctx, "instances")
