"""Training: the LoRA train step (trainer.py), checkpoints
(checkpoints.py), meters and loggers (metrics.py) and the training entry
point (cli.py)."""
