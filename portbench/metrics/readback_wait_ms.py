"""readback_wait_ms: host ms the loop blocks in the program's
``speedplus.readback`` span, on the losses of the step before, mean over the
spans on the loop's thread that begin before the stretch's last
``speedplus.step`` does. The profiler stops inside the loader's request
that follows the stretch, after a synchronize; the spans after the last
step are left out, so that none holds the device's drain or the stop. A
stretch in which no device ran reads nothing: the loop then waits on no
device, and its host spans measure no card."""

SPAN = "speedplus.readback"
STEP = "speedplus.step"


def host_ms(ctx, name: str):
    """Mean host ms of the spans ``name`` on the loop's thread that begin
    before its last ``speedplus.step``; None where there are none, or
    where the stretch has no device events."""
    if not ctx.events:
        return None
    steps = [s for s in ctx.trace.spans(STEP) if s.tid == ctx.tid]
    spans = [s for s in ctx.trace.spans(name)
             if s.tid == ctx.tid and steps and s.ts < steps[-1].ts]
    if not spans:
        return None
    return sum(s.dur for s in spans) * 1e-3 / len(spans)


def read(ctx):
    return host_ms(ctx, SPAN)
