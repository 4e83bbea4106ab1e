"""idle_in_step_ms: device-idle ms a step inside the host's enqueue: the
gaps between the stretch's device events whose middle falls inside a
``speedplus.step`` span on the loop's thread (the rule by which the
breakdown's ``idle_gaps`` names a gap), summed over the stretch."""

import bisect

from portbench import trace as tr

STEP = "speedplus.step"


def read(ctx):
    steps = [s for s in ctx.trace.spans(STEP) if s.tid == ctx.tid]
    if not steps or not ctx.events:
        return None
    starts = [s.ts for s in steps]
    idle = 0.0
    for lo, hi in tr.gaps(ctx.events):
        mid = 0.5 * (lo + hi)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= steps[i].end:
            idle += hi - lo
    return idle * 1e-3 / ctx.steps
