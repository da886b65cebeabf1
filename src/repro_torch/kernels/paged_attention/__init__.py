"""Paged decode and speculative-verify attention (CUDA kernels + plain versions)."""
