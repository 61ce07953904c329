"""B2 (the popcount reduce, ``csrc/popcount.cu``) as a share of its
roofline: the least bytes of the window's counts (``reference/work.py``:
every distinct COUNT's result read once) at the HBM rate, over the
profiler's time in the kernels named here."""

from cellbench.trace import kernel_seconds

KERNELS = ("popcount_kernel",)


def read(ctx):
    if ctx.events is None or ctx.work is None or ctx.peak is None:
        return None
    spent = kernel_seconds(ctx.events, KERNELS)
    bound = sum(w["reduce_bytes"] for w in ctx.work) / ctx.peak["hbm_bytes_per_s"]
    if not spent or not bound:
        return None
    return 100.0 * bound / spent
