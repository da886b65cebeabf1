"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each ``ops`` module holds the wrapper (launches the kernel for CUDA
tensors, runs the plain PyTorch version for CPU tensors, counts its
launches in ``<wrapper>.launches``) and the plain version beside it.
CUDA C++ sources live in ``csrc/`` and are built by ``_build``.
"""
