"""Decoder-only LM (GQA or MLA attention with a dense or MoE FFN, Mamba-2
SSM mixers, or both in one stack): parameters, the train loss, caches,
prefill, decode.

Port of ``repro.models.transformer``.  Layers are
organised into groups of ``period`` layers exactly as in the reference,
and the layer parameters keep its stacked ``(n_groups, ...)`` leaves, so
the parameter bridge maps leaf to leaf.  The reference's ``lax.scan`` over
groups is a Python loop here.  Its ``constrain*`` calls are identity
without a mesh; under one the serve paths take
`repro_torch.runtime.sharding.ShardedParams`, whose split leaves run each
rank's slice, and gather before each product that contracts a split dim.
Each slot of a group reads its own leaves, so a hybrid group's attention
slot runs its heads per rank, its MoE slot its columns per rank, and its
SSM slots (replicated leaves) once on the lead device.
Caches are stacked the same way: one pool per slot with a leading
``n_groups`` dim.  An MoE slot runs the capacity
dispatch (``moe.apply_moe``) in prefill and the dense-gated MoE
(``moe.apply_moe_dense``) in decode and verify, as in the reference.  An
SSM slot (attention-free archs such as mamba2-370m) runs the SSD mixer
(``ssm.ssm_forward_with_cache`` in prefill, ``ssm.ssm_decode`` in decode)
over per-row ``{"conv", "ssd"}`` state, and a slot with ``ffn == "none"``
has no FFN.  A hybrid stack (jamba) mixes the two in one group: seven SSM
slots and one attention slot, which need not be slot 0, so the decode
step's context is built from the first attention slot's cache.  A VLM
(llava) prepends its frontend's stub embeddings in `lm_prefill` and
`lm_loss`.  ``lm_prefill_chunk`` runs one chunk of a chunked admission
into one row of the engine's cache (paged pools, dense rings or SSM rows),
with the dense-gated MoE as in the reference's chunk path.

The train path (``lm_backbone``, ``lm_loss``) runs under autograd on the
live parameters: each group's slices are taken afresh from the
``nn.Parameter``s on every forward (`LMParams.live_groups`), never from
the cached views of ``.data`` that the serve paths read (`LMParams.group`),
which no gradient reaches.  Each group is checkpointed as the
reference's ``_remat`` wraps its scan body.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.layers import (
    COMPUTE, apply_mlp, apply_norm, embed_init, embed_lookup, init_mlp,
    init_norm, lm_logits, rope_table, softmax_cross_entropy_fused,
)
from repro_torch.runtime.sharding import stack


# --------------------------------------------------------------------------
# Layer-slot layout
# --------------------------------------------------------------------------

def group_period(cfg) -> int:
    p = 1
    if cfg.ssm is not None and not cfg.is_attention_free:
        p = math.lcm(p, cfg.attn_period)
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe_period)
    return p


def layer_slots(cfg) -> list[dict]:
    """Static per-slot structure within one group."""
    period = group_period(cfg)
    assert cfg.num_layers % period == 0, (cfg.name, cfg.num_layers, period)
    attn_set = set(i % period for i in cfg.attn_layer_indices() if i < period)
    moe_set = set(i % period for i in cfg.moe_layer_indices() if i < period)
    slots = []
    for i in range(period):
        if cfg.is_attention_free:
            mixer = "ssm"
        else:
            mixer = "attn" if (cfg.ssm is None or i in attn_set) else "ssm"
        if cfg.moe is not None and i in moe_set:
            ffn = "moe"
        elif cfg.d_ff > 0:
            ffn = "dense"
        else:
            ffn = "none"
        slots.append({"mixer": mixer, "ffn": ffn})
    return slots


def _attn_slot(slots) -> int | None:
    """Index of the first attention slot (None for an SSM-only stack)."""
    return next((i for i, s in enumerate(slots) if s["mixer"] == "attn"),
                None)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def _to_module(tree):
    """Nested dict of tensors -> nn.ModuleDict/ParameterDict of frozen
    parameters (same keys, same nesting)."""
    if isinstance(tree, torch.Tensor):
        return nn.Parameter(tree, requires_grad=False)
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: _to_module(v) for k, v in tree.items()})
    return nn.ModuleDict({k: _to_module(v) for k, v in tree.items()})


class LMParams(nn.Module):
    """The decoder's parameters, laid out as the reference's pytree:
    ``embed`` (V,D), ``final_norm["scale"]`` (D,), optional ``head`` (D,V),
    and ``layers[slot]`` whose leaves are stacked ``(n_groups, ...)``.
    For serving, matrices are bf16 (the reference casts them to bf16 at
    use); norm scales and LayerNorm biases (applied in f32), MLA's
    ``q_norm`` and ``kv_norm`` scales, MoE routers (f32 logits) and the SSM
    mixer's ``A_log``, ``dt_bias``, ``D_skip`` and ``norm_scale`` stay f32.
    A train state holds every leaf in f32 (the master weights; the layers
    cast at use) and turns ``requires_grad`` on; every parameter is made
    frozen.

    The serve paths read `group` (views of ``.data``, built once, which
    a captured CUDA graph replays); the train path reads `live_groups`,
    through which autograd reaches the parameters."""

    def __init__(self, tree: dict):
        super().__init__()
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        self.final_norm = _to_module(tree["final_norm"])
        self.head = (nn.Parameter(tree["head"], requires_grad=False)
                     if "head" in tree else None)
        self.layers = nn.ModuleList(_to_module(s) for s in tree["layers"])
        self._views = None

    def tree(self) -> dict:
        """The parameters as a nested dict of tensors."""
        def walk(m):
            if isinstance(m, nn.Parameter):
                return m.data
            return {k: walk(v) for k, v in m.items()}
        out = {"embed": self.embed.data,
               "layers": [walk(s) for s in self.layers],
               "final_norm": walk(self.final_norm)}
        if self.head is not None:
            out["head"] = self.head.data
        return out

    def live(self) -> dict:
        """The parameters as a nested dict of the live ``nn.Parameter``s,
        in the reference's pytree layout (its leaf order: `repro_torch.tree`)."""
        def walk(m):
            if isinstance(m, nn.Parameter):
                return m
            return {k: walk(v) for k, v in m.items()}
        out = {"embed": self.embed,
               "layers": [walk(s) for s in self.layers],
               "final_norm": walk(self.final_norm)}
        if self.head is not None:
            out["head"] = self.head
        return out

    def live_groups(self) -> list[list[dict]]:
        """Every group's per-slot slices of the live parameters, taken
        afresh on every call so that autograd reaches the parameters: one
        ``unbind`` per stacked parameter, whose backward stacks the
        groups' gradients once (slicing each group apart would add a
        zero-filled gradient of the whole stack per group)."""
        def split(m):
            if isinstance(m, nn.Parameter):
                return m.unbind(0)
            return {k: split(v) for k, v in m.items()}

        def take(t, g):
            if isinstance(t, dict):
                return {k: take(v, g) for k, v in t.items()}
            return t[g]
        slots = [split(s) for s in self.layers]
        return [[take(s, g) for s in slots] for g in range(self.n_groups)]

    def group(self, g: int) -> list[dict]:
        """Group ``g``'s per-slot parameter views (built once)."""
        if self._views is None:
            def take(t, i):
                if isinstance(t, dict):
                    return {k: take(v, i) for k, v in t.items()}
                return t[i]
            layers = self.tree()["layers"]
            n_groups = next(iter(layers[0]["mixer"].values())).shape[0]
            self._views = [[take(s, i) for s in layers]
                           for i in range(n_groups)]
        return self._views[g]

    def _apply(self, fn, *args, **kwargs):
        self._views = None              # .to()/.cuda() replace the tensors
        return super()._apply(fn, *args, **kwargs)

    @property
    def n_groups(self) -> int:
        return next(iter(self.layers[0]["mixer"].values())).shape[0]


def init_lm_params(cfg, gen: torch.Generator, device="cpu",
                   dtype=COMPUTE) -> LMParams:
    """Seeded random parameters (``gen`` lives on ``device``).  torch's
    generator gives other numbers than jax.random, so tests bridge the
    reference's parameters instead of comparing inits."""
    n_groups = cfg.num_layers // group_period(cfg)

    def slot(s):
        groups = []
        for _g in range(n_groups):
            gp = {"mixer_norm": init_norm(cfg, device=device),
                  "mixer": (attn.init_attention(gen, cfg, dtype, device)
                            if s["mixer"] == "attn"
                            else ssm.init_ssm(gen, cfg, dtype, device))}
            if s["ffn"] != "none":
                gp["ffn_norm"] = init_norm(cfg, device=device)
                gp["ffn"] = (moe.init_moe(gen, cfg, dtype, device)
                             if s["ffn"] == "moe"
                             else init_mlp(gen, cfg, dtype, device))
            groups.append(gp)
        return {k: {kk: torch.stack([gp[k][kk] for gp in groups])
                    for kk in groups[0][k]} for k in groups[0]}

    tree = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device),
        "layers": [slot(s) for s in layer_slots(cfg)],
        "final_norm": init_norm(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        tree["head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size), dtype,
                                  device)
    return LMParams(tree)


def head_matrix(params: LMParams, cfg):
    return params.embed.T if cfg.tie_embeddings else params.head


# --------------------------------------------------------------------------
# Forward (train)
# --------------------------------------------------------------------------

def _save_matmuls(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of products without batch dims (a projection's ``mm``),
    recompute everything else."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg):
    """``cfg.remat`` on a group's forward: "full" recomputes it in backward
    (``torch.utils.checkpoint``), "dots" keeps its matmul outputs and
    recomputes the rest (selective checkpoint), "none" keeps everything.
    The train forward draws no random numbers, so the recompute need not
    save and restore the generators' state (``preserve_rng_state=False``,
    exact): a captured CUDA graph of the step then holds no generator
    state."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False, **kw)


def _apply_slot(x, p, cfg, slot, rope, compute):
    """One layer of the train forward: (x, the MoE aux loss or 0)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(x, p["mixer_norm"], cfg)
    if slot["mixer"] == "attn":
        h = attn.attention_forward(
            h, p["mixer"], cfg, rope_cos=rope[0], rope_sin=rope[1],
            causal=True, window=cfg.sliding_window, compute=compute)
    else:
        h = ssm.ssm_forward(h, p["mixer"], cfg, compute=compute)
    x = x + h
    if slot["ffn"] != "none":
        h = apply_norm(x, p["ffn_norm"], cfg)
        if slot["ffn"] == "dense":
            h = apply_mlp(h, p["ffn"], cfg, compute)
        else:
            h, aux = moe.apply_moe(h, p["ffn"], cfg, compute)
        x = x + h
    return x, aux


def lm_backbone(params: LMParams, cfg, x, *, compute=COMPUTE):
    """Run the layer stack over embeddings x: (B,S,D) -> (hidden, aux
    loss), each group under `_remat`."""
    slots = layer_slots(cfg)
    rope = ((None, None) if _attn_slot(slots) is None else
            rope_table(torch.arange(x.shape[1], device=x.device),
                       attn.rope_dim(cfg), cfg.rope_theta))

    def group_body(x, gp):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, slot in enumerate(slots):
            x, a = _apply_slot(x, gp[i], cfg, slot, rope, compute)
            aux = aux + a
        return x, aux

    body = _remat(group_body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gp in params.live_groups():
        x, a = body(x, gp)
        aux = aux + a
    return apply_norm(x, params.final_norm, cfg), aux


def lm_loss(params: LMParams, cfg, tokens, targets, *, extra_embeds=None,
            loss_mask=None, compute=COMPUTE):
    """Next-token CE loss plus the MoE aux loss: (loss, {"ce", "aux"}).
    ``extra_embeds`` (B,F,D) (the VLM and audio frontends' stub
    embeddings) are prepended in the compute dtype; the loss covers the
    token positions only."""
    x = embed_lookup(tokens, params.embed, compute)
    n_extra = 0
    if extra_embeds is not None:
        n_extra = extra_embeds.shape[1]
        x = torch.cat([extra_embeds.to(compute), x], dim=1)
    h, aux = lm_backbone(params, cfg, x, compute=compute)
    ce = softmax_cross_entropy_fused(
        h[:, n_extra:], head_matrix(params, cfg), targets,
        softcap=cfg.logit_softcap, mask=loss_mask, chunk=cfg.loss_chunk)
    return ce + aux, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------------
# Caches
# --------------------------------------------------------------------------

def _stacked(c: dict, n_groups: int) -> dict:
    return {k: v[None].expand((n_groups,) + v.shape).contiguous()
            for k, v in c.items()}


def init_cache(cfg, batch: int, max_len: int, dtype=COMPUTE, device="cpu"):
    """Stacked dense cache: one dict per slot, leaves (n_groups, ...):
    rings ``{"k", "v"}`` (MLA: latent rings ``{"ckv", "krope"}``) for
    attention slots, per-row ``{"conv", "ssd"}`` state for SSM slots."""
    n_groups = cfg.num_layers // group_period(cfg)
    return [_stacked(attn.init_kv_cache(cfg, batch, max_len, dtype, device)
                     if s["mixer"] == "attn"
                     else ssm.init_ssm_cache(cfg, batch, dtype, device),
                     n_groups)
            for s in layer_slots(cfg)]


def init_cache_paged(cfg, batch: int, max_len: int, num_blocks: int,
                     block_size: int, dtype=COMPUTE, device="cpu"):
    """Stacked paged cache: per attention slot, pools (n_groups, nb, bs,
    ...) of K/V or of MLA's latent (`attention.init_kv_cache_paged`); SSM
    state stays per row (it is O(1) per row, nothing to page), and so do
    sliding-window rings (always fully live)."""
    n_groups = cfg.num_layers // group_period(cfg)
    return [_stacked(attn.init_kv_cache_paged(cfg, batch, max_len,
                                              num_blocks, block_size, dtype,
                                              device)
                     if s["mixer"] == "attn"
                     else ssm.init_ssm_cache(cfg, batch, dtype, device),
                     n_groups)
            for s in layer_slots(cfg)]


# --------------------------------------------------------------------------
# Prefill / decode
# --------------------------------------------------------------------------

def _ffn(x, p, cfg, slot, compute, *, prefill=False):
    """The slot's FFN with its residual (none for ``ffn == "none"``).  An
    MoE slot dispatches by capacity in prefill (its aux loss is dropped, as
    in the reference's prefill) and runs every expert on the tokens in
    decode and verify."""
    if slot["ffn"] == "none":
        return x
    h = apply_norm(x, p["ffn_norm"], cfg)
    if slot["ffn"] != "moe":
        return x + apply_mlp(h, p["ffn"], cfg, compute)
    moe_fn = moe.apply_moe if prefill else moe.apply_moe_dense
    return x + moe_fn(h, p["ffn"], cfg, compute)[0]


def lm_prefill(params: LMParams, cfg, tokens, cache, *, extra_embeds=None,
               compute=COMPUTE):
    """Full-sequence prefill: returns (last-position logits (B,1,V) f32,
    filled dense cache, stacked like ``cache``).  ``extra_embeds`` (B,F,D)
    (a VLM's stub patch embeddings) are prepended in the compute dtype, and
    RoPE and the cache cover all F + S positions."""
    slots = layer_slots(cfg)
    x = embed_lookup(tokens, params.embed, compute)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(compute), x], dim=1)
    S = x.shape[1]
    rope = (rope_table(torch.arange(S, device=x.device), attn.rope_dim(cfg),
                       cfg.rope_theta)
            if _attn_slot(slots) is not None else None)
    new = [{k: [] for k in c} for c in cache]
    for g in range(params.n_groups):
        gp = params.group(g)
        for i, slot in enumerate(slots):
            p = gp[i]
            h = apply_norm(x, p["mixer_norm"], cfg)
            if slot["mixer"] == "attn":
                old = {k: v[g] for k, v in cache[i].items()}
                out, nc = attn.attention_prefill(
                    h, p["mixer"], cfg, rope, old, window=cfg.sliding_window,
                    compute=compute)
            else:
                out, nc = ssm.ssm_forward_with_cache(h, p["mixer"], cfg,
                                                     compute=compute)
            for k, v in nc.items():
                new[i][k].append(v)
            x = _ffn(x + out, p, cfg, slot, compute, prefill=True)
    x = apply_norm(x, params.final_norm, cfg)
    logits = lm_logits(x[:, -1:], head_matrix(params, cfg), cfg.logit_softcap)
    return logits, [{k: stack(v) for k, v in c.items()} for c in new]


def lm_decode(params: LMParams, cfg, token, cache, pos, *, block_tables=None,
              compute=COMPUTE):
    """One decode step.  token: (B,1) int; pos: (B,) int32 absolute
    position of the new token; ``block_tables`` (B, mb) serves every layer
    of a paged cache (None for a dense cache).  The caches in ``cache`` are
    updated in place (SSM slots advance their per-row state; ``pos`` only
    positions attention).  Returns (logits (B,1,V) f32, cache)."""
    slots = layer_slots(cfg)
    x = embed_lookup(token, params.embed, compute)
    a = _attn_slot(slots)
    ctx = (attn.decode_context(
        cfg, attn._row_positions(pos, x.shape[0], x.device), cache[a],
        block_tables) if a is not None else None)
    for g in range(params.n_groups):
        gp = params.group(g)
        for i, slot in enumerate(slots):
            p = gp[i]
            h = apply_norm(x, p["mixer_norm"], cfg)
            layer_cache = {k: v[g] for k, v in cache[i].items()}
            if slot["mixer"] == "attn":
                h, _ = attn.attention_decode(
                    h, p["mixer"], cfg, layer_cache, pos,
                    window=cfg.sliding_window, block_tables=block_tables,
                    ctx=ctx, compute=compute)
            else:
                h, _ = ssm.ssm_decode(h, p["mixer"], cfg, layer_cache,
                                      compute=compute)
            x = _ffn(x + h, p, cfg, slot, compute)
    x = apply_norm(x, params.final_norm, cfg)
    return lm_logits(x, head_matrix(params, cfg), cfg.logit_softcap), cache


def lm_verify(params: LMParams, cfg, tokens, cache, pos, *, block_tables,
              compute=COMPUTE):
    """Speculative-verify forward: score S = k+1 consecutive positions of
    every row in ONE pass.  tokens: (B,S) int — ``tokens[:,0]`` is the
    pending token at ``pos`` and ``tokens[:,1:]`` the draft proposals; pos:
    (B,) int32 absolute position of tokens[:,0].  Structurally `lm_decode`
    with an S-wide token axis: every position-wise op (embed, norms, MLP,
    logits) batches over S, while attention gives each query the exact
    single-token attend (`attention.attention_verify`), which keeps each
    position's logits those of the sequential decode steps it replaces.
    Paged attention-only archs.  Returns (logits (B,S,V) f32, cache)."""
    slots = layer_slots(cfg)
    for slot in slots:
        if slot["mixer"] != "attn":
            raise ValueError(
                f"{cfg.name}: speculative verify needs every mixer to be "
                "paged attention; SSM state rows advance one token at a time "
                "and cannot roll back a rejected suffix")
    x = embed_lookup(tokens, params.embed, compute)
    ctx = attn.verify_context(
        cfg, attn._row_positions(pos, x.shape[0], x.device), x.shape[1],
        cache[0], block_tables)
    for g in range(params.n_groups):
        gp = params.group(g)
        for i, slot in enumerate(slots):
            p = gp[i]
            h = apply_norm(x, p["mixer_norm"], cfg)
            layer_cache = {k: v[g] for k, v in cache[i].items()}
            h, _ = attn.attention_verify(h, p["mixer"], cfg, layer_cache, pos,
                                         block_tables=block_tables, ctx=ctx,
                                         compute=compute)
            x = _ffn(x + h, p, cfg, slot, compute)
    x = apply_norm(x, params.final_norm, cfg)
    return lm_logits(x, head_matrix(params, cfg), cfg.logit_softcap), cache


def lm_prefill_chunk(params: LMParams, cfg, tokens, cache, table_row,
                     slot, q_offset, *, compute=COMPUTE):
    """One CHUNK of an admission prefill into ONE batch row of the engine's
    decode cache.  tokens: (1,C) int; table_row: (mb,) int32 the admitted
    row's block ids (a dummy for a dense cache); slot: the batch row;
    q_offset: absolute position of tokens[:,0]; each of the two an int or
    a 0-d int32 device tensor (a captured chunk's static inputs, as the
    reference's are traced scalars).  Only row ``slot``'s state
    (its blocks, ring row or SSM row) is written, in place; the other rows
    keep decoding bitwise as before between chunks.  Returns
    (last-position logits (1,V) f32, cache)."""
    slots = layer_slots(cfg)
    x = embed_lookup(tokens, params.embed, compute)
    for g in range(params.n_groups):
        gp = params.group(g)
        for i, slot_s in enumerate(slots):
            p = gp[i]
            h = apply_norm(x, p["mixer_norm"], cfg)
            layer_cache = {k: v[g] for k, v in cache[i].items()}
            if slot_s["mixer"] == "attn":
                h, _ = attn.attention_prefill_chunk(
                    h, p["mixer"], cfg, layer_cache, table_row, slot,
                    q_offset, window=cfg.sliding_window, compute=compute)
            else:
                h, _ = ssm.ssm_prefill_chunk_row(h, p["mixer"], cfg,
                                                 layer_cache, slot,
                                                 compute=compute)
            x = _ffn(x + h, p, cfg, slot_s, compute)
    x = apply_norm(x, params.final_norm, cfg)
    logits = lm_logits(x[:, -1:], head_matrix(params, cfg), cfg.logit_softcap)
    return logits[:, 0], cache
