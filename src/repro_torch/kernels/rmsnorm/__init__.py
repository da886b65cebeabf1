"""Fused residual-add + RMSNorm (CUDA kernel + plain version)."""
