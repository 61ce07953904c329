"""Training: optimizers, loss and steps, checkpoints, the trainer."""
