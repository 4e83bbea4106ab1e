"""step_busy_ms: the device's busy ms a step, the union of the intervals of
the kernels, copies and sets the stretch's steps launched, over the steps."""


def read(ctx):
    if not ctx.events:
        return None
    return ctx.busy_us * 1e-3 / ctx.steps
