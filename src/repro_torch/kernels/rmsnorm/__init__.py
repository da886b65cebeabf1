"""Fused residual-add + RMSNorm (Triton kernel + plain version)."""
