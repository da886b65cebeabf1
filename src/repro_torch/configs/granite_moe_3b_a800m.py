"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8.

[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]
32L d_model=1536 24H (GQA kv=8) d_ff=512-per-expert vocab=49155, MoE every layer.
"""

from repro_torch.configs.base import ArchConfig, MoESpec, register, register_smoke

NAME = "granite-moe-3b-a800m"


@register(NAME)
def config() -> ArchConfig:
    return ArchConfig(
        name=NAME,
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=0,                 # all-MoE FFN
        vocab_size=49155,
        mlp_gated=True,
        activation="silu",
        moe=MoESpec(num_experts=40, top_k=8, d_ff_expert=512),
        moe_period=1,
        norm="rmsnorm",
        tie_embeddings=True,
    )


@register_smoke(NAME)
def smoke() -> ArchConfig:
    return ArchConfig(
        name=NAME + "-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=0,
        vocab_size=512,
        moe=MoESpec(num_experts=8, top_k=4, d_ff_expert=32),
        moe_period=1,
        tie_embeddings=True,
        attn_chunk=64,
    )
