"""Device kernels per flush: every kernel the profiler saw in the window
(copies and memsets left out), over the window's flushes."""

from cellbench.trace import is_kernel


def read(ctx):
    if ctx.events is None or not ctx.flushes:
        return None
    kernels = sum(1 for a, b, n in ctx.events if ctx.t0 <= a <= ctx.t1 and is_kernel(n))
    return kernels / ctx.flushes if kernels else None
