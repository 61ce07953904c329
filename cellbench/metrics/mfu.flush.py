"""The whole flush's share of the chip's peak: the window's summed flush
bounds (``reference/work.py``: bytes at the HBM rate or operations at the
integer rate, whichever binds; for these flushes HBM binds) over the
window."""

from cellbench.reference.work import least_seconds


def read(ctx):
    if ctx.work is None or ctx.peak is None or not ctx.window_s:
        return None
    return 100.0 * sum(least_seconds(w, ctx.peak) for w in ctx.work) / ctx.window_s
