"""Architecture + input-shape configuration system (the port's own copy).

Field names and defaults are those of ``repro.configs.base``, so
``dataclasses.asdict`` of a config matches the reference's, and every
architecture the reference registers is registered here.

Every assigned architecture is described by an :class:`ArchConfig`; every
assigned input shape by a :class:`ShapeSpec`.  A ``(ArchConfig, ShapeSpec)``
pair is exactly what the paper calls a *payload*: the pilot system late-binds
it onto an already-provisioned slice (see ``repro.core.images.PayloadImage``).

Configs are plain frozen dataclasses, hashable and free of device state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

# --------------------------------------------------------------------------
# Sub-specs for the model families that need extra structure
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """Mixture-of-experts FFN block."""

    num_experts: int
    top_k: int
    d_ff_expert: int          # hidden width of ONE expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # "tp": expert hidden dim sharded over the model axis (tokens stay put).
    # "ep": experts sharded over the model axis (tokens all-to-all).
    partition: str = "tp"


@dataclasses.dataclass(frozen=True)
class MLASpec:
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3 style)."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    """Mamba-2 SSD mixer."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    n_groups: int = 1          # B/C groups shared across heads


# --------------------------------------------------------------------------
# The architecture config
# --------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int                    # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int                         # dense FFN hidden width (0 if all-MoE)
    vocab_size: int

    head_dim: int = 0                 # 0 -> d_model // num_heads
    # ---- attention flavour ----
    sliding_window: int | None = None   # SWA width (mixtral)
    rope_theta: float = 10_000.0
    mla: MLASpec | None = None
    # ---- FFN flavour ----
    mlp_gated: bool = True            # SwiGLU/GeGLU vs plain MLP
    activation: str = "silu"          # silu | gelu
    moe: MoESpec | None = None
    moe_period: int = 1               # MoE FFN every `period` layers (jamba: 2)
    # ---- SSM / hybrid ----
    ssm: SSMSpec | None = None
    attn_period: int = 1              # hybrid: 1 attention layer per period
                                      # (jamba: 8 -> 7 mamba + 1 attn)
    # ---- encoder-decoder / frontend stubs ----
    encoder_layers: int = 0           # whisper: 12 encoder layers
    frontend_tokens: int = 0          # stub tokens (llava patches / whisper frames)
    # ---- misc ----
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float | None = None
    # remat policy for the layer scan: "full" | "dots" | "none"
    remat: str = "full"
    # attention implementation: "chunked" (pure-JAX flash-style, default),
    # "causal_blocked" (static triangular block skipping — beyond-paper opt),
    # "pallas" (TPU kernel path)
    attn_impl: str = "chunked"
    attn_chunk: int = 1024
    # sequence-chunked fused CE loss (logits never fully materialized)
    loss_chunk: int = 1024
    # SSM mixer implementation: "chunked" (pure-JAX SSD) | "pallas"
    ssm_impl: str = "chunked"
    # MoE expert matmul: "einsum" (capacity buckets) | "gmm" (Pallas kernel)
    moe_impl: str = "einsum"
    # norm implementation: "jnp" | "pallas" (fused kernel)
    norm_impl: str = "jnp"

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived quantities -------------------------------------------------

    @property
    def is_attention_free(self) -> bool:
        return self.num_heads == 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def subquadratic(self) -> bool:
        """True if long-context decode is feasible (assignment: run long_500k
        only for SSM / hybrid / sliding-window archs)."""
        if self.ssm is not None:
            return True
        return self.sliding_window is not None

    def attn_layer_indices(self) -> tuple[int, ...]:
        """Decoder layers that are attention (hybrid archs interleave)."""
        if self.is_attention_free:
            return ()
        if self.ssm is None:
            return tuple(range(self.num_layers))
        # hybrid: 1 attention layer per attn_period, at the end of each period
        # (jamba: layer 7, 15, 23, 31 in a 1:7 interleave)
        return tuple(
            i for i in range(self.num_layers)
            if (i % self.attn_period) == self.attn_period - 1
        )

    def moe_layer_indices(self) -> tuple[int, ...]:
        if self.moe is None:
            return ()
        return tuple(
            i for i in range(self.num_layers) if (i % self.moe_period) == self.moe_period - 1
        )

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and memory checks)."""
        D, V = self.d_model, self.vocab_size
        total = V * D                      # embedding
        if not self.tie_embeddings:
            total += V * D                 # lm head
        attn_set = set(self.attn_layer_indices())
        moe_set = set(self.moe_layer_indices())
        for i in range(self.num_layers):
            total += self._mixer_params(i in attn_set)
            total += self._ffn_params(i in moe_set)
            total += 2 * D                 # two norms per layer
        total += D                         # final norm
        if self.is_encdec:
            # encoder layers: self-attn + ffn; decoder adds cross-attn
            enc = self.encoder_layers * (
                self._attn_params() + self._dense_ffn_params() + 2 * D
            )
            dec_cross = self.num_layers * (self._attn_params() + D)
            total += enc + dec_cross + D
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        per_expert = 3 * self.d_model * m.d_ff_expert if self.mlp_gated else 2 * self.d_model * m.d_ff_expert
        inactive = (m.num_experts - m.top_k) * per_expert * len(self.moe_layer_indices())
        return self.param_count() - inactive

    # -- helpers --

    def _attn_params(self) -> int:
        D = self.d_model
        if self.mla is not None:
            s = self.mla
            H = self.num_heads
            return (
                D * s.q_lora_rank
                + s.q_lora_rank * H * s.qk_head_dim
                + D * (s.kv_lora_rank + s.qk_rope_head_dim)
                + s.kv_lora_rank * H * (s.qk_nope_head_dim + s.v_head_dim)
                + H * s.v_head_dim * D
            )
        Dh = self.head_dim
        return D * self.num_heads * Dh + 2 * D * self.num_kv_heads * Dh + self.num_heads * Dh * D

    def _ssm_params(self) -> int:
        s = self.ssm
        D = self.d_model
        d_inner = s.expand * D
        nheads = d_inner // s.head_dim
        conv_dim = d_inner + 2 * s.n_groups * s.state_dim
        return (
            D * (2 * d_inner + 2 * s.n_groups * s.state_dim + nheads)  # in_proj
            + conv_dim * s.conv_width                                   # conv1d
            + nheads * 2                                                # A_log, D
            + nheads                                                    # dt_bias
            + d_inner                                                   # gated norm
            + d_inner * D                                               # out_proj
        )

    def _mixer_params(self, is_attn: bool) -> int:
        return self._attn_params() if is_attn else self._ssm_params()

    def _dense_ffn_params(self) -> int:
        mult = 3 if self.mlp_gated else 2
        return mult * self.d_model * self.d_ff

    def _ffn_params(self, is_moe: bool) -> int:
        if not is_moe:
            return self._dense_ffn_params()
        m = self.moe
        mult = 3 if self.mlp_gated else 2
        return self.d_model * m.num_experts + m.num_experts * mult * self.d_model * m.d_ff_expert


# --------------------------------------------------------------------------
# Input shapes (assigned: 4 per LM arch)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str                  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Mapping[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> tuple[str, ...]:
    """Which assigned shapes run for this arch (skips recorded in DESIGN.md)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return tuple(out)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}
_SMOKE_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def register_smoke(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _SMOKE_REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def get_smoke_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _SMOKE_REGISTRY:
        raise KeyError(f"no smoke config for {name!r}")
    return _SMOKE_REGISTRY[name]()


def list_archs() -> tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from repro_torch.configs import gemma_2b  # noqa: F401
    from repro_torch.configs import granite_moe_3b_a800m  # noqa: F401
    from repro_torch.configs import jamba_v01_52b  # noqa: F401
    from repro_torch.configs import llava_next_mistral_7b  # noqa: F401
    from repro_torch.configs import mamba2_370m  # noqa: F401
    from repro_torch.configs import minicpm3_4b  # noqa: F401
    from repro_torch.configs import mixtral_8x7b  # noqa: F401
    from repro_torch.configs import smollm_360m  # noqa: F401
    from repro_torch.configs import starcoder2_3b  # noqa: F401
    from repro_torch.configs import whisper_small  # noqa: F401
