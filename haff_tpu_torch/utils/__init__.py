"""Tracing, FLOP accounting and the bench-leg cache (port of
haff_tpu/utils)."""
