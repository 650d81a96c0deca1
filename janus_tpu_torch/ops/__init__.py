"""Kernels of the port (CUDA C++ in csrc/, each beside its plain PyTorch version) and plain tensor ops."""
