"""restyle_ms: device ms a restyled step of the kernels launched inside the
harness's span around the style augmentor."""

from portbench.trace import RESTYLE_SPAN


def read(ctx):
    styled = sum(ctx.styled)
    events = ctx.launched_in(RESTYLE_SPAN)
    if not styled or not events:
        return None
    return sum(e.dur for e in events) * 1e-3 / styled
