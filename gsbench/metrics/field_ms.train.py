"""field_ms.train: ms a step of the port's "field_features" stage (the mip
HexPlane field sampled once a step; stream time between CUDA events)."""


def read(ctx):
    ms = ctx.stages.get("field_features")
    return None if ms is None else ms / ctx.units
