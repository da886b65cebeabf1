"""mixtral-8x7b — MoE 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
SWA window 4096 -> sub-quadratic decode; long_500k runs with a rolling KV cache.
"""

from repro_torch.configs.base import ArchConfig, MoESpec, register, register_smoke

NAME = "mixtral-8x7b"


@register(NAME)
def config() -> ArchConfig:
    return ArchConfig(
        name=NAME,
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=0,
        vocab_size=32000,
        sliding_window=4096,
        mlp_gated=True,
        activation="silu",
        moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=14336),
        moe_period=1,
        norm="rmsnorm",
        rope_theta=1_000_000.0,
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
        sliding_window=64,
        moe=MoESpec(num_experts=4, top_k=2, d_ff_expert=128),
        moe_period=1,
        attn_chunk=64,
    )
