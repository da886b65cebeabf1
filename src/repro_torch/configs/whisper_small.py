"""whisper-small — encoder-decoder with conv audio frontend (STUB).

[arXiv:2212.04356; unverified]  12L enc + 12L dec, d_model=768 12H d_ff=3072
vocab=51865, LayerNorm, plain-GELU MLP.  Per the assignment the conv frontend
is a STUB: ``input_specs()`` provides precomputed frame embeddings
(1500 frames = 30 s of audio after the 2x conv downsampling).
Full attention -> long_500k skipped.  Decode shapes lower the DECODER step
(self-attn KV cache at seq_len + fixed cross-attn to the encoder output).
"""

from repro_torch.configs.base import ArchConfig, register, register_smoke

NAME = "whisper-small"


@register(NAME)
def config() -> ArchConfig:
    return ArchConfig(
        name=NAME,
        family="audio",
        num_layers=12,          # decoder layers
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        mlp_gated=False,
        activation="gelu",
        norm="layernorm",
        encoder_layers=12,
        frontend_tokens=1500,   # precomputed mel->conv frame embeddings (stub)
        tie_embeddings=True,
    )


@register_smoke(NAME)
def smoke() -> ArchConfig:
    return ArchConfig(
        name=NAME + "-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        mlp_gated=False,
        activation="gelu",
        norm="layernorm",
        encoder_layers=2,
        frontend_tokens=32,
        tie_embeddings=True,
        attn_chunk=64,
    )
