"""dispatch_ms: the host's enqueue ms a step (``train_epoch``'s own ``ms``:
from the end of the last readback to the step's return), mean over the
window's steps outside the profiled stretch."""


def read(ctx):
    if not ctx.dispatch_ms:
        return None
    return sum(ctx.dispatch_ms) / len(ctx.dispatch_ms)
