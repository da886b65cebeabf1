"""mamba2-370m — pure SSM (state-space duality / SSD).  [arXiv:2405.21060]

[hf:state-spaces/mamba2-370m]

48L d_model=1024, attention-free, vocab=50280, ssm_state=128.
d_inner = 2*1024 = 2048, head_dim 64 -> 32 SSD heads.  O(1) decode state.
"""

from repro_torch.configs.base import ArchConfig, SSMSpec, register, register_smoke

NAME = "mamba2-370m"


@register(NAME)
def config() -> ArchConfig:
    return ArchConfig(
        name=NAME,
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,            # attention-free
        num_kv_heads=0,
        d_ff=0,                 # mamba2 blocks have no separate FFN
        vocab_size=50280,
        ssm=SSMSpec(state_dim=128, head_dim=64, expand=2, conv_width=4,
                    chunk_size=256),
        attn_period=10**9,      # no attention layers at all
        norm="rmsnorm",
        tie_embeddings=True,
    )


@register_smoke(NAME)
def smoke() -> ArchConfig:
    return ArchConfig(
        name=NAME + "-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=512,
        ssm=SSMSpec(state_dim=16, head_dim=16, expand=2, conv_width=4,
                    chunk_size=32),
        attn_period=10**9,
        tie_embeddings=True,
    )
