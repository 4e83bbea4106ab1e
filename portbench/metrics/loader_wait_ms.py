"""loader_wait_ms: host ms the loop waits in the program's
``speedplus.loader_wait`` span for its next batch, mean over the spans on
the loop's thread that begin before the stretch's last ``speedplus.step``
does (the one after it holds the profiler's stop: see
``readback_wait_ms``)."""

from portbench.metrics.readback_wait_ms import host_ms

SPAN = "speedplus.loader_wait"


def read(ctx):
    return host_ms(ctx, SPAN)
