"""batchnorm_ms: device ms a step in the model's BatchNorm kernels, forward
and backward: the union of the intervals of the stretch's kernels whose
names hold one of ``NAMES``, leaving out those launched inside the restyle.
They are known by name because autograd launches the backward's from its
own thread, outside the program's spans. The running-variance update's few
elementwise kernels a layer (``models/layers.py::BatchNorm``) are named as
any elementwise kernel and are not counted. Reads nothing where no kernel's
name matches, so that a renamed kernel shows."""

from portbench import trace as tr

#: Fragments of the names of ATen's batch norm kernels (``batch_norm_*``,
#: which torch runs for channels-last bf16 on the H100) and of cuDNN's
#: (``bn_fw_*``, ``bn_bw_*``), which other builds may choose.
NAMES = ("batch_norm", "bn_fw", "bn_bw")


def matches(name: str) -> bool:
    return any(frag in name for frag in NAMES)


def read(ctx):
    restyle = {id(e) for e in ctx.launched_in(tr.RESTYLE_SPAN)}
    events = [e for e in ctx.events if id(e) not in restyle and matches(e.name)]
    if not events:
        return None
    return tr.union_us(events) * 1e-3 / ctx.steps
