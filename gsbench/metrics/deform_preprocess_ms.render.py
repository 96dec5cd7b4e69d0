"""deform_preprocess_ms.render: ms a frame from the benchmark's mark before
``test_render`` to the port's "preprocess" mark (the deform heads and the
preprocess; stream time between CUDA events, idle gaps included)."""


def read(ctx):
    ms = ctx.stages.get("preprocess")
    return None if ms is None else ms / ctx.units
