"""The training step (``train_step``)."""
