"""Composite model and multimodal splice."""
