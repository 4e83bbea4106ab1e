"""device_idle_pct: the share of the stretch, from its first device event to
its last, in which nothing ran on the device."""


def read(ctx):
    if not ctx.events or ctx.window_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_us / ctx.window_us)
