"""backward_ms: device ms a step in which the kernels launched inside the
program's ``speedplus.backward`` span ran (``zero_grad`` and
``loss.backward()``), the union of their intervals: cuDNN runs a weight
gradient's kernels side by side on streams of its own, which a sum would
count twice. Autograd launches these kernels from its own thread while the
loop's thread waits in the span, so they are tied to it by launch time
alone."""

from portbench.metrics.forward_ms import busy_ms

SPAN = "speedplus.backward"


def read(ctx):
    return busy_ms(ctx, SPAN)
