"""llava-next-mistral-7b — VLM: mistral-7b backbone + anyres patch frontend.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
Backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, SwiGLU.
Per the assignment the modality frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings (anyres base tile = 576 patches of CLIP-ViT-L/14
@336px); the backbone prepends them to the token embeddings.
Full attention (llava-1.6 disables mistral's sliding window) -> long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig, register, register_smoke

NAME = "llava-next-mistral-7b"


@register(NAME)
def config() -> ArchConfig:
    return ArchConfig(
        name=NAME,
        family="vlm",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        mlp_gated=True,
        activation="silu",
        norm="rmsnorm",
        frontend_tokens=576,    # one base anyres tile, precomputed (stub)
        rope_theta=1_000_000.0,
    )


@register_smoke(NAME)
def smoke() -> ArchConfig:
    return ArchConfig(
        name=NAME + "-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        frontend_tokens=16,
        attn_chunk=64,
    )
