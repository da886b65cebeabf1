"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Real Jamba: attention every 8th layer, MoE every other layer, 16 experts top-2.
Jamba uses Mamba-1 mixers; we implement the Mamba-2 SSD formulation instead —
the SSD dual form is the MXU-friendly TPU adaptation of the same selective-SSM
recurrence (documented in DESIGN.md §2: hardware-adaptation notes).
"""

from repro_torch.configs.base import ArchConfig, MoESpec, SSMSpec, register, register_smoke

NAME = "jamba-v0.1-52b"


@register(NAME)
def config() -> ArchConfig:
    return ArchConfig(
        name=NAME,
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        mlp_gated=True,
        activation="silu",
        moe=MoESpec(num_experts=16, top_k=2, d_ff_expert=14336),
        moe_period=2,
        ssm=SSMSpec(state_dim=16, head_dim=64, expand=2, conv_width=4, chunk_size=256),
        attn_period=8,
        norm="rmsnorm",
    )


@register_smoke(NAME)
def smoke() -> ArchConfig:
    return ArchConfig(
        name=NAME + "-smoke",
        family="hybrid",
        num_layers=8,           # one full period: 7 mamba + 1 attn, 4 MoE
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        moe=MoESpec(num_experts=4, top_k=2, d_ff_expert=128),
        moe_period=2,
        ssm=SSMSpec(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk_size=32),
        attn_period=8,
        attn_chunk=64,
    )
