"""Inference: greedy generation and evaluate()."""
