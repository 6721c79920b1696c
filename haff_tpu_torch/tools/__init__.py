"""Weight tools: the JAX-parameter bridge."""
