"""domain_head_ms: device ms a step in which the kernels launched inside the
program's ``speedplus.domain`` spans ran (DANN's gradient reversal and
domain head, once a stream), the union of their intervals, as
``forward_ms`` takes it. The forward only: autograd launches the head's
backward from its own thread, outside every span. Reads nothing where the
program has no such span."""

from portbench.metrics.forward_ms import busy_ms

SPAN = "speedplus.domain"


def read(ctx):
    return busy_ms(ctx, SPAN)
