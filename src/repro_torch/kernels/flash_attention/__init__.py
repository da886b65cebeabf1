"""Flash prefill attention (CUDA kernel + plain version)."""
