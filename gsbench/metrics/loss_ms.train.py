"""loss_ms.train: ms a step of the port's "loss" and "loss_backward" stages
(L1, SSIM and the regularizers, and their backward)."""


def read(ctx):
    parts = [ctx.stages.get(k) for k in ("loss", "loss_backward")]
    return None if None in parts else sum(parts) / ctx.units
