"""Training: the LoRA train step (trainer.py)."""
