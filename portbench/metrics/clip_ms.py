"""clip_ms: device ms a step in which the kernels launched inside the
program's ``speedplus.clip`` span ran (the model's gradient clip): the union
of their intervals, as ``forward_ms`` takes it."""

from portbench.metrics.forward_ms import busy_ms

SPAN = "speedplus.clip"


def read(ctx):
    return busy_ms(ctx, SPAN)
