"""Host milliseconds per flush in the program's ``dispatch`` spans
(telemetry): launching the flush's device program, B1's launches among
them, from the end of the compile to the payload's copy."""


def read(ctx):
    spans = [b - a for name, _, _, a, b in ctx.spans if name == "dispatch"]
    if not ctx.flushes or not spans:
        return None
    return sum(spans) * 1e3 / ctx.flushes
