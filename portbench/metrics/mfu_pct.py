"""mfu_pct: the FLOPs the stretch's steps require (``work.step_flops``: the
model's forward and backward as 3 forwards, the generator's forward on a
restyled step, nothing recomputed) over the stretch's span times the card's
bf16 peak."""

from portbench import work


def read(ctx):
    if not ctx.events or ctx.peak is None or ctx.window_us <= 0:
        return None
    flops = sum(work.step_flops(ctx.config, ctx.batch, s) for s in ctx.styled)
    return 100.0 * flops / (ctx.window_us * 1e-6 * ctx.peak["bf16_flops"])
