"""haff_tpu_torch: the PyTorch/CUDA port of haff_tpu for NVIDIA Hopper.

Mirrors haff_tpu's module layout (core, nn, kernels, model, infer, tools)
so every port file has one reference file. Imports torch and numpy only;
the Pallas kernels of the reference become hand-written CUDA C++ kernels
under kernels/csrc, each with a plain PyTorch version beside its wrapper.
"""
