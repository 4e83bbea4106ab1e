"""augment_ms: device ms a step in which the kernels launched inside the
program's ``speedplus.augment`` spans ran (a KRN step's photometric draws
and style normals, and ``apply_augment``): the union of their intervals,
as ``forward_ms`` takes it."""

from portbench.metrics.forward_ms import busy_ms

SPAN = "speedplus.augment"


def read(ctx):
    return busy_ms(ctx, SPAN)
