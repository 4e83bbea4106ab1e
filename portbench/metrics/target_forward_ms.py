"""target_forward_ms: device ms a step in which the kernels launched inside
the program's ``speedplus.target`` span ran (DANN's target-stream forward,
its domain head included): the union of their intervals, as ``forward_ms``
takes it. Reads nothing where the program has no such span."""

from portbench.metrics.forward_ms import busy_ms

SPAN = "speedplus.target"


def read(ctx):
    return busy_ms(ctx, SPAN)
