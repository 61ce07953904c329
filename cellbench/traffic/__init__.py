"""Traffic: one module per loop kind, the BMI windows' generator, and the mix files."""
