"""minicpm3-4b — dense with MLA (multi-head latent attention).

[hf:openbmb/MiniCPM3-4B; hf]  62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA dims from the HF config: q_lora_rank=768, kv_lora_rank=256,
qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64.
Decode caches the compressed latent (kv_lora + k_rope) — the MLA win.
"""

from repro_torch.configs.base import ArchConfig, MLASpec, register, register_smoke

NAME = "minicpm3-4b"


@register(NAME)
def config() -> ArchConfig:
    return ArchConfig(
        name=NAME,
        family="dense",
        num_layers=62,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,
        d_ff=6400,
        vocab_size=73448,
        mla=MLASpec(
            q_lora_rank=768,
            kv_lora_rank=256,
            qk_nope_head_dim=64,
            qk_rope_head_dim=32,
            v_head_dim=64,
        ),
        mlp_gated=True,
        activation="silu",
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
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        mla=MLASpec(
            q_lora_rank=32,
            kv_lora_rank=16,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        ),
        attn_chunk=64,
    )
