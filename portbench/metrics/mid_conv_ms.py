"""mid_conv_ms: the mid-conv kernel (the generator's layers 1, 2, 8 and 9,
reflect pad 1 + 3x3 conv with the stride 2 or the nearest 2x upsample folded
in, ``ops/midconv.py`` -> ``csrc/midconv.cu``): device ms a restyled step of
its kernels, known by name. Four calls a restyle; nothing to read unless it
ran exactly that often, so a reading says the kernel carried all four
layers of every restyle in the stretch."""

from portbench import trace as tr

KERNEL = "mid_conv3x3_kernel"
CALLS_PER_RESTYLE = 4


def read(ctx):
    events = [e for e in ctx.events if tr.ident(e.name) == KERNEL]
    styled = sum(ctx.styled)
    if not styled or len(events) != CALLS_PER_RESTYLE * styled:
        return None
    return sum(e.dur for e in events) * 1e-3 / styled
