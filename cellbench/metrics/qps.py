"""Queries answered in the window over the window's time: the flush in
flight at the close is finished and counted, and the time runs to its
end."""


def read(ctx):
    if not ctx.window_s:
        return None
    return ctx.answered / ctx.window_s
