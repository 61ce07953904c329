"""Host milliseconds per flush in the program's ``compile`` spans
(telemetry): lowering and planning the batch's queries, and the flush
program's cache lookups."""


def read(ctx):
    spans = [b - a for name, _, _, a, b in ctx.spans if name == "compile"]
    if not ctx.flushes or not spans:
        return None
    return sum(spans) * 1e3 / ctx.flushes
