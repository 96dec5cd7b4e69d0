"""deform_ms.train: ms a step of the port's "deform" and "deform_backward"
stages (the heads forward, and autograd through them)."""


def read(ctx):
    parts = [ctx.stages.get(k) for k in ("deform", "deform_backward")]
    return None if None in parts else sum(parts) / ctx.units
