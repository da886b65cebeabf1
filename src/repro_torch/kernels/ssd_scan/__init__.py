"""Mamba-2 SSD chunked scan (CUDA kernel + plain version)."""
