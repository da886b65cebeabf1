"""Grouped per-expert matmul (CUDA kernel + plain version)."""
