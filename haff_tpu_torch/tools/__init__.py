"""Weight tools: the JAX-parameter bridge and the PyTorch state-dict
conversions; the kernel audit and benchmarks."""
