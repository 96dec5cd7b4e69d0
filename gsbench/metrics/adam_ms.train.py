"""adam_ms.train: ms a step of the port's "adam_guard" stage (the LRs,
Adam, the scale cap and the non-finite guard's one read)."""


def read(ctx):
    ms = ctx.stages.get("adam_guard")
    return None if ms is None else ms / ctx.units
