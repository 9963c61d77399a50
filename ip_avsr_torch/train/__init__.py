"""Training of the port: optimizers and the training step."""
