"""Training: optimizers, the train step, checkpoints, elastic planning."""
