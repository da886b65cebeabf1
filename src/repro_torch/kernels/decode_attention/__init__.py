"""Dense flash-decode attention (CUDA kernel + plain version)."""
