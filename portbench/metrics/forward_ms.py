"""forward_ms: device ms a step in which the kernels launched inside the
program's ``speedplus.forward`` span ran (the model's forward under autocast
and the loss): the union of their intervals, as ``step_busy_ms`` takes it,
so that kernels a library runs side by side on its own streams count once."""

from portbench import trace as tr

SPAN = "speedplus.forward"


def busy_ms(ctx, name: str):
    """Device ms a step in which the kernels launched inside the spans
    ``name`` ran; None where there are none."""
    events = ctx.launched_in(name)
    if not events:
        return None
    return tr.union_us(events) * 1e-3 / ctx.steps


def read(ctx):
    return busy_ms(ctx, SPAN)
