"""adamw_ms: device ms a step of the kernels launched inside torch's own
``Optimizer.step#AdamW.step`` range."""

SPAN = "Optimizer.step#AdamW.step"


def read(ctx):
    events = ctx.launched_in(SPAN)
    if not events:
        return None
    return sum(e.dur for e in events) * 1e-3 / ctx.steps
