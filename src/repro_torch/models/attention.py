"""Attention (GQA): prefill and paged decode paths.

Port of the GQA part of ``repro.models.attention``.  ``cfg.attn_impl``
selects the attend step:

* ``"pallas"`` — the hand-written kernels: flash prefill
  (`repro_torch.kernels.flash_attention`) and paged decode
  (`repro_torch.kernels.paged_attention`).  For CPU tensors their wrappers
  run the kernels' plain versions.
* anything else — the plain PyTorch version of the reference's pure-JAX
  path: `chunked_attention` for prefill, `decode_attend` over `gather_kv`
  for decode.

Masks use ``NEG_INF = -1e30`` (a fully masked row is uniform, not NaN);
Q.K and P.V take bf16 operands and sum in f32.  MLA, sliding-window rings,
speculative verify and chunked prefill are later slices.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.ops import gather_kv
from repro_torch.models.layers import COMPUTE, apply_rope, dense_init, rope_table

NEG_INF = -1e30


def _check_gqa(cfg):
    if cfg.mla is not None or cfg.sliding_window is not None:
        raise NotImplementedError(
            f"{cfg.name}: MLA and sliding-window attention are later slices "
            "of the port; this one carries plain GQA")


# ==========================================================================
# Parameter init
# ==========================================================================

def init_attention(gen, cfg, dtype=COMPUTE, device="cpu"):
    _check_gqa(cfg)
    D, H, K, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (D, H, Dh), dtype=dtype, device=device),
        "wk": dense_init(gen, (D, K, Dh), dtype=dtype, device=device),
        "wv": dense_init(gen, (D, K, Dh), dtype=dtype, device=device),
        "wo": dense_init(gen, (H, Dh, D), in_axis=0, dtype=dtype, device=device),
    }


def _project(x, w, compute):
    """einsum("bsd,dhk->bshk") as one matmul."""
    D, n, k = w.shape
    return (x @ w.to(compute).reshape(D, n * k)).reshape(
        x.shape[:-1] + (n, k))


def _out_project(o, wo, compute):
    """einsum("bshk,hkd->bsd")."""
    H, Dh, D = wo.shape
    return o.reshape(o.shape[:-2] + (H * Dh,)) @ wo.to(compute).reshape(H * Dh, D)


# ==========================================================================
# Core attend
# ==========================================================================

def _mask_chunk(q_pos, t_pos, causal, window):
    m = torch.ones((q_pos.shape[0], t_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= t_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= t_pos[None, :] > (q_pos[:, None] - window)
    return m


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      chunk=1024):
    """Flash-style online-softmax attention over KV chunks (the reference's
    pure-JAX prefill path, its `lax.scan` as a loop).

    q: (B,S,H,Dh); k,v: (B,T,K,Dh).  Returns (B,S,H,Dh) in q's dtype."""
    B, S, H, Dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    chunk = min(chunk, T)
    scale = 1.0 / Dh ** 0.5
    dev = q.device
    qg = q.reshape(B, S, K, G, Dh).to(torch.bfloat16).float()
    q_pos = q_offset + torch.arange(S, device=dev)
    m = torch.full((B, K, G, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, K, G, S, Dh), dtype=torch.float32, device=dev)
    n_chunks = -(-T // chunk)
    for idx in range(n_chunks):
        lo = idx * chunk
        kb = k[:, lo:lo + chunk].to(torch.bfloat16).float()
        vb = v[:, lo:lo + chunk].to(torch.bfloat16).float()
        pad = chunk - kb.shape[1]
        if pad:                             # the reference pads T to chunks
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, pad))
        t_pos = lo + torch.arange(chunk, device=dev)
        s = torch.einsum("bskgd,btkd->bkgst", qg, kb) * scale
        valid = _mask_chunk(q_pos, t_pos, causal, window)
        valid &= t_pos[None, :] < T
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(torch.bfloat16).float(), vb)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype)


def attend(q, k, v, cfg, *, causal=True, window=None, q_offset=0):
    """Dispatch on cfg.attn_impl (self-attention, prefill)."""
    if cfg.attn_impl == "pallas":
        from repro_torch.kernels.flash_attention.ops import flash_attention
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window, q_offset=q_offset)
    if cfg.attn_impl == "causal_blocked":
        raise NotImplementedError("attn_impl='causal_blocked' is a later slice")
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, chunk=cfg.attn_chunk)


def decode_attend(q, k_cache, v_cache, cache_len):
    """Single-token attention against a KV cache (the reference's pure-JAX
    decode path).  q: (B,1,H,Dh); caches: (B,T,K,Dh); cache_len: (B,) valid
    entries per row.  f32 softmax; the normalised p is cast to bf16."""
    B, _, H, Dh = q.shape
    T, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, Dh).to(torch.bfloat16).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg,
                     k_cache.to(torch.bfloat16).float()) * (1.0 / Dh ** 0.5)
    cl = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device).expand(B)
    valid = torch.arange(T, device=q.device)[None, :] < cl[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(torch.bfloat16).float(),
                       v_cache.to(torch.bfloat16).float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


# ==========================================================================
# Prefill
# ==========================================================================

def _ring_write_full(k, v, cache):
    """Write a full prefill's k/v (B,S,K,Dh) into a cache (B,T,K,Dh) with
    T >= S (no sliding window in this slice): rows past S are zero."""
    S = k.shape[1]
    T = cache["k"].shape[1]
    if S > T:
        raise NotImplementedError("rolling (SWA) caches are a later slice")
    pad = (0, 0, 0, 0, 0, T - S)
    return {"k": torch.nn.functional.pad(k, pad).to(cache["k"].dtype),
            "v": torch.nn.functional.pad(v, pad).to(cache["v"].dtype)}


def attention_prefill(x, p, cfg, rope, cache, *, compute=COMPUTE):
    """Full-sequence causal self-attention that also fills the decode
    cache.  Returns (out (B,S,D), new_cache)."""
    _check_gqa(cfg)
    q = _project(x, p["wq"], compute)
    k = _project(x, p["wk"], compute)
    v = _project(x, p["wv"], compute)
    q = apply_rope(q, rope[0], rope[1])
    k = apply_rope(k, rope[0], rope[1])
    out = attend(q, k, v, cfg, causal=True)
    return _out_project(out, p["wo"], compute), _ring_write_full(k, v, cache)


# ==========================================================================
# Paged decode
# ==========================================================================
#
# The paged cache is a shared pool ``(num_blocks, block_size, K, Dh)`` plus
# a per-row block table ``(B, max_blocks)``: logical position ``p`` of row
# ``b`` lives at ``pool[table[b, p // bs], p % bs]``.  Block 0 is the
# scratch block: free slots keep decoding over it and their writes land
# there, never in a live request's blocks.

def _row_positions(pos, batch: int, device):
    """Scalar or (B,) decode position(s) -> (B,) int32."""
    return torch.as_tensor(pos, dtype=torch.int32, device=device).expand(batch)


def _paged_write_index(block_tables, pos, block_size: int):
    """Where row b's new entry lands: ``(table[b, (pos_b // bs) % mb],
    pos_b % bs)`` — the reference's `_paged_write_rows` wrap."""
    mb = block_tables.shape[1]
    pos = pos.long()
    blk = torch.gather(block_tables.long(), 1,
                       ((pos // block_size) % mb)[:, None])[:, 0]
    return blk, pos % block_size


def _paged_write_rows(pool, new, index):
    """Per-row paged write IN PLACE: pool (nb, bs, ...), new (B, 1, ...) at
    ``index`` from `_paged_write_index`.  The JAX reference returns a new
    pool (its engine donates the old one); writing in place is the
    counterpart and keeps one pool in memory."""
    pool.index_put_(index, new[:, 0].to(pool.dtype))
    return pool


def _paged_gather(pool, block_tables):
    """Each row's logical view (B, mb * bs, ...) for the plain path."""
    return gather_kv(pool, block_tables)


def decode_context(cfg, pos, block_tables, block_size: int) -> dict:
    """What every layer of one decode step shares: the RoPE tables of the
    rows' positions, the paged write slots and the valid lengths.  The
    reference computes them inside each layer; computing them once per
    step gives the same values with 32x fewer launches."""
    cos, sin = rope_table(pos[:, None], cfg.head_dim, cfg.rope_theta)
    T = block_tables.shape[1] * block_size
    return {"cos": cos, "sin": sin,
            "write": _paged_write_index(block_tables, pos, block_size),
            "cache_len": torch.clamp(pos + 1, max=T).to(torch.int32)}


def attention_decode(x, p, cfg, cache, pos, *, block_tables, ctx=None,
                     compute=COMPUTE):
    """One paged decode step.  x: (B,1,D); cache {"kp","vp"}: (nb,bs,K,Dh)
    pools, updated in place; block_tables (B,mb) int32; pos: scalar or (B,)
    absolute position of the new token; ``ctx`` the step's
    `decode_context` (computed here when None).  Returns
    (out (B,1,D), cache)."""
    _check_gqa(cfg)
    if "kp" not in cache:
        raise NotImplementedError("dense (kv='dense') decode is a later slice")
    B = x.shape[0]
    if ctx is None:
        ctx = decode_context(cfg, _row_positions(pos, B, x.device),
                             block_tables, cache["kp"].shape[1])
    q = _project(x, p["wq"], compute)
    k = _project(x, p["wk"], compute)
    v = _project(x, p["wv"], compute)
    q = apply_rope(q, ctx["cos"], ctx["sin"])
    k = apply_rope(k, ctx["cos"], ctx["sin"])
    k_pool = _paged_write_rows(cache["kp"], k, ctx["write"])
    v_pool = _paged_write_rows(cache["vp"], v, ctx["write"])
    if cfg.attn_impl == "pallas":
        from repro_torch.kernels.paged_attention.ops import (
            paged_decode_attention)
        out = paged_decode_attention(q[:, 0].contiguous(), k_pool, v_pool,
                                     block_tables, ctx["cache_len"])[:, None]
    else:
        out = decode_attend(q, _paged_gather(k_pool, block_tables),
                            _paged_gather(v_pool, block_tables),
                            ctx["cache_len"])
    return _out_project(out, p["wo"], compute), {"kp": k_pool, "vp": v_pool}


# ==========================================================================
# Caches
# ==========================================================================

def init_kv_cache(cfg, batch: int, max_len: int, dtype=COMPUTE, device="cpu"):
    """Per-attention-layer dense cache (the one-shot prefill's output)."""
    _check_gqa(cfg)
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_len, K, Dh), dtype=dtype, device=device),
            "v": torch.zeros((batch, max_len, K, Dh), dtype=dtype, device=device)}


def init_kv_cache_paged(cfg, batch: int, max_len: int, num_blocks: int,
                        block_size: int, dtype=COMPUTE, device="cpu"):
    """Per-attention-layer paged cache: a shared block pool (``batch`` and
    ``max_len`` size the reference's SWA rings, a later slice)."""
    _check_gqa(cfg)
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    shape = (num_blocks, block_size, K, Dh)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}
