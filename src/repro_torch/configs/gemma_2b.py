"""gemma-2b — dense, GeGLU, head_dim=256, MQA (kv=1).  [arXiv:2403.08295; hf]

18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000, tied embeddings.
"""

from repro_torch.configs.base import ArchConfig, register, register_smoke

NAME = "gemma-2b"


@register(NAME)
def config() -> ArchConfig:
    return ArchConfig(
        name=NAME,
        family="dense",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        mlp_gated=True,
        activation="gelu",      # GeGLU
        tie_embeddings=True,
        norm="rmsnorm",
    )


@register_smoke(NAME)
def smoke() -> ArchConfig:
    return ArchConfig(
        name=NAME + "-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        activation="gelu",
        tie_embeddings=True,
        attn_chunk=64,
    )
