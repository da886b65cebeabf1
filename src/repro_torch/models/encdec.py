"""Whisper-style encoder-decoder: parameters, the train loss, caches,
prefill and decode.

Port of ``repro.models.encdec``.  The audio frontend is the reference's
stub: a batch carries precomputed frame embeddings ``frontend`` (B, F, D),
the output of whisper's two conv layers.  The encoder runs non-causal
self-attention over the frames with sinusoidal positions and no RoPE; the
decoder is a causal LM (RoPE at ``head_dim``) with a cross-attention
sub-layer after each self-attention.  Layer parameters are stacked
``(L, ...)`` as the reference's ``vmap``-ed init stacks them, so the
parameter bridge maps leaf to leaf; the reference's ``lax.scan`` over
layers is a Python loop here, and its ``constrain`` calls are dropped.

On the kernel flags the encoder and the prefill's cross-attention run
flash at ``causal=False`` (S != T for the cross-attention), the decoder's
self-attention flash at admission and the dense decode kernel per step.
Decode's cross-attention is the plain `attention.decode_attend` against
the cached encoder K/V, as in the reference, which launches no kernel
there.  The train path runs each layer under `transformer._remat`.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    COMPUTE, apply_mlp, apply_norm, embed_init, embed_lookup, init_mlp,
    init_norm, lm_logits, rope_table, softmax_cross_entropy_fused,
)
from repro_torch.models.transformer import _remat, _to_module, head_matrix


def _sinusoidal(S: int, D: int, device):
    """(S, D) f32 positions: sin of the first D/2 frequencies, then cos."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


class EncDecParams(nn.Module):
    """The encoder-decoder's parameters in the reference's pytree layout:
    ``embed`` (V,D), ``enc_layers`` and ``dec_layers`` whose leaves are
    stacked ``(L, ...)``, ``enc_norm`` and ``final_norm``.  Embeddings are
    tied (whisper): there is no ``head``.  Dtypes as `LMParams`'s: bf16
    matrices to serve, f32 norms; a train state holds every leaf in f32.

    The serve paths read `layers` (views of ``.data``, built once); the
    train path reads `live_layers`, through which autograd reaches the
    parameters."""

    head = None

    def __init__(self, tree: dict):
        super().__init__()
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        self.enc_layers = _to_module(tree["enc_layers"])
        self.enc_norm = _to_module(tree["enc_norm"])
        self.dec_layers = _to_module(tree["dec_layers"])
        self.final_norm = _to_module(tree["final_norm"])
        self._views = None

    def _walk(self, leaf):
        def walk(m):
            if isinstance(m, nn.Parameter):
                return leaf(m)
            return {k: walk(v) for k, v in m.items()}
        return {"embed": leaf(self.embed),
                "enc_layers": walk(self.enc_layers),
                "enc_norm": walk(self.enc_norm),
                "dec_layers": walk(self.dec_layers),
                "final_norm": walk(self.final_norm)}

    def tree(self) -> dict:
        """The parameters as a nested dict of tensors."""
        return self._walk(lambda p: p.data)

    def live(self) -> dict:
        """The parameters as a nested dict of the live ``nn.Parameter``s."""
        return self._walk(lambda p: p)

    @staticmethod
    def _per_layer(stacked: dict, split) -> list[dict]:
        """``stacked``'s (L, ...) leaves cut by ``split`` into L per-layer
        dicts."""
        parts = {k: {kk: split(v) for kk, v in sub.items()}
                 for k, sub in stacked.items()}
        n = len(next(iter(parts["ffn"].values())))
        return [{k: {kk: v[i] for kk, v in sub.items()}
                 for k, sub in parts.items()} for i in range(n)]

    def layers(self, which: str) -> list[dict]:
        """``which`` ("enc" or "dec"): each layer's parameter views (built
        once)."""
        if self._views is None:
            t = self.tree()
            self._views = {w: self._per_layer(t[f"{w}_layers"], list)
                           for w in ("enc", "dec")}
        return self._views[which]

    def live_layers(self, which: str) -> list[dict]:
        """Each layer's slices of the live parameters, taken afresh (one
        ``unbind`` per stacked parameter, as `LMParams.live_groups`)."""
        return self._per_layer(self.live()[f"{which}_layers"],
                               lambda p: p.unbind(0))

    def _apply(self, fn, *args, **kwargs):
        self._views = None              # .to()/.cuda() replace the tensors
        return super()._apply(fn, *args, **kwargs)


def init_encdec_params(cfg, gen: torch.Generator, device="cpu",
                       dtype=COMPUTE) -> EncDecParams:
    """Seeded random parameters (``gen`` lives on ``device``)."""
    def norm():
        return init_norm(cfg, device=device)

    def enc_layer():
        return {"attn_norm": norm(),
                "attn": attn.init_attention(gen, cfg, dtype, device),
                "ffn_norm": norm(),
                "ffn": init_mlp(gen, cfg, dtype, device)}

    def dec_layer():
        return {"self_norm": norm(),
                "self_attn": attn.init_attention(gen, cfg, dtype, device),
                "cross_norm": norm(),
                "cross_attn": attn.init_attention(gen, cfg, dtype, device),
                "ffn_norm": norm(),
                "ffn": init_mlp(gen, cfg, dtype, device)}

    return EncDecParams({
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                            device),
        "enc_layers": _stack([enc_layer()
                              for _ in range(cfg.encoder_layers)]),
        "enc_norm": norm(),
        "dec_layers": _stack([dec_layer() for _ in range(cfg.num_layers)]),
        "final_norm": norm()})


def _layer_params(params: EncDecParams, which: str, live: bool):
    return params.live_layers(which) if live else params.layers(which)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def encode(params: EncDecParams, cfg, frames, *, compute=COMPUTE,
           live: bool = False):
    """frames: (B, F, D) stub embeddings -> (B, F, D) encoder output.
    ``live``: the train path (live parameters, each layer under
    `_remat`)."""
    F, D = frames.shape[1], cfg.d_model
    x = frames.to(compute) + _sinusoidal(F, D, frames.device).to(compute)

    def body(x, p):
        h = apply_norm(x, p["attn_norm"], cfg)
        h = attn.attention_forward(h, p["attn"], cfg, rope_cos=None,
                                   rope_sin=None, causal=False,
                                   compute=compute)
        x = x + h
        h = apply_norm(x, p["ffn_norm"], cfg)
        return x + apply_mlp(h, p["ffn"], cfg, compute)

    step = _remat(body, cfg) if live else body
    for p in _layer_params(params, "enc", live):
        x = step(x, p)
    return apply_norm(x, params.enc_norm, cfg)


def _decoder_stack(params: EncDecParams, cfg, x, enc_out, compute,
                   live: bool):
    S = x.shape[1]
    cos, sin = rope_table(torch.arange(S, device=x.device), cfg.head_dim,
                          cfg.rope_theta)

    def body(x, enc_out, p):
        h = apply_norm(x, p["self_norm"], cfg)
        h = attn.attention_forward(h, p["self_attn"], cfg, rope_cos=cos,
                                   rope_sin=sin, causal=True,
                                   compute=compute)
        x = x + h
        h = apply_norm(x, p["cross_norm"], cfg)
        h = attn.attention_forward(h, p["cross_attn"], cfg, rope_cos=None,
                                   rope_sin=None, causal=False, kv=enc_out,
                                   compute=compute)
        x = x + h
        h = apply_norm(x, p["ffn_norm"], cfg)
        return x + apply_mlp(h, p["ffn"], cfg, compute)

    step = _remat(body, cfg) if live else body
    for p in _layer_params(params, "dec", live):
        x = step(x, enc_out, p)
    return apply_norm(x, params.final_norm, cfg)


def encdec_loss(params: EncDecParams, cfg, frames, tokens, targets, *,
                compute=COMPUTE):
    """Next-token CE of the decoder over the encoded frames: (ce, {"ce",
    "aux"}) with ``aux`` 0, as the reference's."""
    enc_out = encode(params, cfg, frames, compute=compute, live=True)
    x = embed_lookup(tokens, params.embed, compute)
    h = _decoder_stack(params, cfg, x, enc_out, compute, live=True)
    ce = softmax_cross_entropy_fused(h, head_matrix(params, cfg), targets,
                                     softcap=cfg.logit_softcap,
                                     chunk=cfg.loss_chunk)
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------------
# Caches, prefill, decode
# --------------------------------------------------------------------------

def init_encdec_cache(cfg, batch: int, max_len: int, dtype=COMPUTE,
                      device="cpu"):
    """Per-decoder-layer self-attention cache ``{"k","v"}`` (L, B, max_len,
    K, Dh) and the fixed cross-attention K/V ``{"k","v"}`` (L, B, F, K, Dh)
    of the encoder's output."""
    L, K, Dh, F = (cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                   cfg.frontend_tokens)

    def z(T):
        return torch.zeros((L, batch, T, K, Dh), dtype=dtype, device=device)
    return {"self": {"k": z(max_len), "v": z(max_len)},
            "cross": {"k": z(F), "v": z(F)}}


def encdec_prefill(params: EncDecParams, cfg, frames, tokens, cache, *,
                   compute=COMPUTE):
    """The encoder pass and the decoder's prefill over ``tokens`` (B,S):
    returns (last-position logits (B,1,V) f32, the filled caches).  The
    cross K/V are their own projections of the encoder output, as in the
    reference."""
    enc_out = encode(params, cfg, frames, compute=compute)
    x = embed_lookup(tokens, params.embed, compute)
    rope = rope_table(torch.arange(x.shape[1], device=x.device),
                      cfg.head_dim, cfg.rope_theta)
    new = {"self": {"k": [], "v": []}, "cross": {"k": [], "v": []}}
    for i, p in enumerate(params.layers("dec")):
        h = apply_norm(x, p["self_norm"], cfg)
        old = {k: v[i] for k, v in cache["self"].items()}
        out, self_c = attn.attention_prefill(h, p["self_attn"], cfg, rope,
                                             old, compute=compute)
        x = x + out
        h = apply_norm(x, p["cross_norm"], cfg)
        ck = attn._project(enc_out, p["cross_attn"]["wk"], compute)
        cv = attn._project(enc_out, p["cross_attn"]["wv"], compute)
        h = attn.attention_forward(h, p["cross_attn"], cfg, rope_cos=None,
                                   rope_sin=None, causal=False, kv=enc_out,
                                   compute=compute)
        x = x + h
        h = apply_norm(x, p["ffn_norm"], cfg)
        x = x + apply_mlp(h, p["ffn"], cfg, compute)
        for k in ("k", "v"):
            new["self"][k].append(self_c[k])
        new["cross"]["k"].append(ck.to(cache["cross"]["k"].dtype))
        new["cross"]["v"].append(cv.to(cache["cross"]["v"].dtype))
    x = apply_norm(x, params.final_norm, cfg)
    logits = lm_logits(x[:, -1:], head_matrix(params, cfg), cfg.logit_softcap)
    return logits, {w: {k: torch.stack(v) for k, v in c.items()}
                    for w, c in new.items()}


def encdec_decode(params: EncDecParams, cfg, token, cache, pos, *,
                  compute=COMPUTE):
    """One decoder step against the self and cross caches.  token (B,1);
    pos: scalar or (B,) absolute position of the new token.  The self
    cache is written in place (dense rows, as the decoder LM's dense
    decode); the cross K/V are read.  Returns (logits (B,1,V) f32,
    cache)."""
    x = embed_lookup(token, params.embed, compute)
    ctx = attn.decode_context(
        cfg, attn._row_positions(pos, x.shape[0], x.device), cache["self"])
    ck, cv = cache["cross"]["k"], cache["cross"]["v"]
    F = ck.shape[2]
    for i, p in enumerate(params.layers("dec")):
        h = apply_norm(x, p["self_norm"], cfg)
        layer_cache = {k: v[i] for k, v in cache["self"].items()}
        h, _ = attn.attention_decode(h, p["self_attn"], cfg, layer_cache, pos,
                                     ctx=ctx, compute=compute)
        x = x + h
        h = apply_norm(x, p["cross_norm"], cfg)
        q = attn._project(h, p["cross_attn"]["wq"], compute)
        out = attn.decode_attend(q, ck[i], cv[i], F)
        x = x + attn._out_project(out, p["cross_attn"]["wo"], compute)
        h = apply_norm(x, p["ffn_norm"], cfg)
        x = x + apply_mlp(h, p["ffn"], cfg, compute)
    x = apply_norm(x, params.final_norm, cfg)
    return lm_logits(x, head_matrix(params, cfg), cfg.logit_softcap), cache
