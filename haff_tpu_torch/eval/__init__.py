"""Evaluation of the port: metrics, annotation extraction, the
benchmark evaluator and the overlay tool."""
