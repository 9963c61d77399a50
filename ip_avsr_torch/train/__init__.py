"""Training of the port: INI configs, optimizers, the step, the trainer,
evaluation and checkpoints."""
