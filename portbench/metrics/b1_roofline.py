"""b1_roofline: kernel B1 (the Ghiasi residual block, ``ops/resblock.py``
-> ``csrc/resblock.cu``): the least time its calls' work needs at the card's
peaks (``work.b1_flops`` and ``work.b1_bytes``: two 3x3 128 -> 128 convs at
the generator's quarter side, at 2 FLOPs a multiply-add; compute-bound)
over the time of its kernels, known by name. One call is one weight split,
two convs each followed by the shared statistics finalize, and one residual
pass; five calls a restyle."""

from portbench import trace as tr
from portbench import work

OWN = ("split_weights_kernel", "conv3x3_tc_kernel", "residual_kernel")
CALLS_PER_RESTYLE = 5


def read(ctx):
    events = tr.chain(ctx.events, OWN, "in_finalize_kernel", "conv3x3_tc_kernel")
    calls = sum(1 for e in events if tr.ident(e.name) == "split_weights_kernel")
    if ctx.peak is None or not calls or calls != CALLS_PER_RESTYLE * sum(ctx.styled):
        return None
    side, elem = ctx.config["input_side"], 2 if ctx.config["fp16"] else 4
    least = work.least_seconds(work.b1_flops(ctx.batch, side),
                               work.b1_bytes(ctx.batch, side, elem), ctx.peak)
    return 100.0 * calls * least / (sum(e.dur for e in events) * 1e-6)
