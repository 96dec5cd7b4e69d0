"""instances_per_frame.render: the mean of the port's ``num_instances``
over the traced frames (a count)."""


def read(ctx):
    inst = ctx.counts.get("instances")
    return sum(inst) / len(inst) if inst else None
