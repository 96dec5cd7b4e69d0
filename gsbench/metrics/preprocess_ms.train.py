"""preprocess_ms.train: ms a step of the port's "preprocess" and
"reduce_preprocess_backward" stages (the preprocess, the per-Gaussian
reduce of K3's rows and the preprocess chain's backward)."""


def read(ctx):
    parts = [ctx.stages.get(k)
             for k in ("preprocess", "reduce_preprocess_backward")]
    return None if None in parts else sum(parts) / ctx.units
