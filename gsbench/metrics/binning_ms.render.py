"""binning_ms.render: ms a frame of the port's "binning" stage (K2, the
sort, the tile ranges; stream time between CUDA events)."""


def read(ctx):
    ms = ctx.stages.get("binning")
    return None if ms is None else ms / ctx.units
