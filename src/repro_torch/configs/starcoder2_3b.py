"""starcoder2-3b — dense, GQA kv=2, RoPE, plain-GELU MLP, LayerNorm.

[arXiv:2402.19173; hf]  30L d_model=3072 24H (kv=2) d_ff=12288 vocab=49152.
"""

from repro_torch.configs.base import ArchConfig, register, register_smoke

NAME = "starcoder2-3b"


@register(NAME)
def config() -> ArchConfig:
    return ArchConfig(
        name=NAME,
        family="dense",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        mlp_gated=False,        # classic c_fc -> gelu -> c_proj
        activation="gelu",
        norm="layernorm",
        rope_theta=999_999.0,   # starcoder2 uses a large rope base
    )


@register_smoke(NAME)
def smoke() -> ArchConfig:
    return ArchConfig(
        name=NAME + "-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        mlp_gated=False,
        activation="gelu",
        norm="layernorm",
        attn_chunk=64,
    )
