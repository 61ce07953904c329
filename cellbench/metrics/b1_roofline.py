"""B1 (the multi-wordline gather-reduce, ``csrc/mws.cu``) as a share of
its roofline: the least bytes of the window's sensing (``reference/work.py``:
every day page the flushes' windows need read once, the valid page, every
distinct result written once) at the HBM rate, over the profiler's time in
the kernels named here.

What moves it besides B1's own speed: B1 reading a day page once for every
window that holds it (the five windows share their newest days) rather
than once a flush; and sensing that moves out of these kernels, which the
numerator still counts.  The planner's materialisation, which answers a
hot predicate from a stored page, would be such a move; this
configuration turns it off.  A kernel that takes over part of the
sensing is added to ``KERNELS`` by a later benchmark change."""

from cellbench.trace import kernel_seconds

KERNELS = ("mws_gather_kernel", "mws_staged_kernel")


def read(ctx):
    if ctx.events is None or ctx.work is None or ctx.peak is None:
        return None
    spent = kernel_seconds(ctx.events, KERNELS)
    if not spent:
        return None
    bound = sum(w["sense_bytes"] for w in ctx.work) / ctx.peak["hbm_bytes_per_s"]
    return 100.0 * bound / spent
