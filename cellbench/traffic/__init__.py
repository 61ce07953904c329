"""Traffic: the generator, one module per loop kind, and the mix files."""
