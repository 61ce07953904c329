"""Process start to the window's start: imports, the day bitmaps, the
store and its programming, kernel load (and, in a fresh checkout, their
build), warm-up."""


def read(ctx):
    return ctx.setup_s
