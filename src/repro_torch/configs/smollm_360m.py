"""smollm-360m — llama-arch small dense model.  [hf:HuggingFaceTB/SmolLM; hf]

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152, SwiGLU, RMSNorm, tied.
"""

from repro_torch.configs.base import ArchConfig, register, register_smoke

NAME = "smollm-360m"


@register(NAME)
def config() -> ArchConfig:
    return ArchConfig(
        name=NAME,
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        d_ff=2560,
        vocab_size=49152,
        mlp_gated=True,
        activation="silu",
        tie_embeddings=True,
        norm="rmsnorm",
    )


@register_smoke(NAME)
def smoke() -> ArchConfig:
    return ArchConfig(
        name=NAME + "-smoke",
        family="dense",
        num_layers=2,
        d_model=60,             # keeps the odd 15-head flavour: 4 heads x 15
        num_heads=3,
        num_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        tie_embeddings=True,
        attn_chunk=64,
    )
