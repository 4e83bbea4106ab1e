"""rmsprop_ms: device ms a step of the kernels launched inside torch's own
``Optimizer.step#RMSprop.step`` range, as ``adamw_ms`` reads AdamW's."""

SPAN = "Optimizer.step#RMSprop.step"


def read(ctx):
    events = ctx.launched_in(SPAN)
    if not events:
        return None
    return sum(e.dur for e in events) * 1e-3 / ctx.steps
