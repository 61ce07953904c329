"""One reader per metric: ``read(ctx)`` returns the value, or None where the window has nothing to read."""
