"""PyTorch + CUDA port of ``repro``'s serve and train paths for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports nothing
from it.  Plain tensor code is PyTorch; every Pallas kernel on the ported
path has a hand-written Hopper kernel under ``repro_torch.kernels``, with a
plain PyTorch version beside it that runs only for CPU tensors.  The
kernels are forward only, as the reference's are: training runs the plain
paths under autograd.
"""
