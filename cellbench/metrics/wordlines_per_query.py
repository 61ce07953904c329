"""Wordlines sensed per query served in the window (program counters):
what the planner and optimizer make each query cost."""


def read(ctx):
    served = ctx.counters.get("queries_served", 0)
    if not served:
        return None
    return ctx.counters.get("wordlines_sensed", 0) / served
