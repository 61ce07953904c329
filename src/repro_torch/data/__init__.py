"""Training data: the synthetic corpus behind a bitmap-index filter."""
