"""The device's idle share of the window: one minus the union of its
activity intervals (kernels, copies, memsets; overlaps count once) over
the window."""

from cellbench.trace import busy_seconds


def read(ctx):
    if ctx.events is None or not ctx.window_s:
        return None
    return 100.0 * (1.0 - busy_seconds(ctx.events, ctx.t0, ctx.t1) / ctx.window_s)
