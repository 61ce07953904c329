"""LM stack of the port: config schema, layers, the dense transformer,
the family registry and the parameter carry-across (``state``)."""
