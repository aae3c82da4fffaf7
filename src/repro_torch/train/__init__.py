"""Training substrate: optimizers, checkpointing, data pipeline, trainer."""
