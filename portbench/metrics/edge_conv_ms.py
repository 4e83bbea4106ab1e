"""edge_conv_ms: the edge-conv kernel (the generator's layer0 and layer10,
reflect pad 4 + 9x9 conv, ``ops/edgeconv.py`` -> ``csrc/edgeconv.cu``):
device ms a restyled step of its kernels, known by name. Two calls a
restyle; nothing to read unless it ran exactly that often, so a reading
says the kernel carried both layers of every restyle in the stretch."""

from portbench import trace as tr

KERNEL = "edge_conv9x9_kernel"
CALLS_PER_RESTYLE = 2


def read(ctx):
    events = [e for e in ctx.events if tr.ident(e.name) == KERNEL]
    styled = sum(ctx.styled)
    if not styled or len(events) != CALLS_PER_RESTYLE * styled:
        return None
    return sum(e.dur for e in events) * 1e-3 / styled
