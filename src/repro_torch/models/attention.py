"""Attention (GQA and MLA): prefill, decode (paged or dense KV) and
speculative verify paths.

Port of ``repro.models.attention``.  ``cfg.attn_impl`` selects the attend
step:

* ``"pallas"`` — the hand-written kernels: flash prefill
  (`repro_torch.kernels.flash_attention`), paged decode and paged verify
  (`repro_torch.kernels.paged_attention`) and dense decode
  (`repro_torch.kernels.decode_attention`).  For CPU tensors their
  wrappers run the kernels' plain versions.
* ``"causal_blocked"`` — `causal_blocked_attention` for prefill, the
  plain path otherwise.
* anything else — the plain PyTorch version of the reference's pure-JAX
  path: `chunked_attention` for prefill, `decode_attend` over the dense
  cache or the gathered pool for decode, one `decode_attend` per query for
  verify.

Chunked admission (`attention_prefill_chunk`) writes a chunk
into one row's blocks or ring row and attends it with `_chunk_attend`,
plain PyTorch as in the reference, which has no kernel for it.

Sliding-window attention (mixtral) keeps a dense rolling ring of
``min(max_len, window)`` positions per row in every layout: position ``p``
of a row lives at ring slot ``p mod T``, a prefill longer than the ring
keeps each slot's latest occupant, and decode attends the whole ring
(which holds only the window) with no window mask.  The prefill and chunk
paths mask keys at or before ``pos - window``.

Multi-head latent attention (MLA, minicpm3) caches one compressed latent
per token, ``ckv`` (kv_lora_rank wide) and the rotated ``krope``
(qk_rope_head_dim wide): dense rings ``{"ckv", "krope"}`` or paged pools
``{"ckvp", "kropep"}``.  The train path and the one-shot prefill expand
the latent into per-head keys and values and attend through `attend` (the
flash kernel on the kernel flags), V zero-padded to the q/k head width;
decode, verify and chunked admission score the queries against the latent
itself with the absorbed weights (`_mla_latent_attend`), in plain PyTorch
as in the reference, which has no kernel for it.  RoPE rotates only the
``qk_rope_head_dim`` channels (`rope_dim`).  Its inner ``q_norm`` and
``kv_norm`` are the plain `rmsnorm`, as in the reference.

Masks use ``NEG_INF = -1e30`` (a fully masked row is uniform, not NaN);
Q.K and P.V take bf16 operands and sum in f32.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.paged_attention.ops import gather_kv
from repro_torch.models.layers import (
    COMPUTE, apply_rope, dense_init, read_row, rmsnorm, rope_table,
    write_row)
from repro_torch.runtime.sharding import (
    Shards, gather, on_ranks, pairs, split)

NEG_INF = -1e30


def rope_dim(cfg) -> int:
    """The head sub-width RoPE rotates: MLA's ``qk_rope_head_dim``, else
    the whole head."""
    return cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.head_dim


# ==========================================================================
# Parameter init
# ==========================================================================

def init_attention(gen, cfg, dtype=COMPUTE, device="cpu"):
    if cfg.mla is not None:
        return _init_mla(gen, cfg, dtype, device)
    D, H, K, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (D, H, Dh), dtype=dtype, device=device),
        "wk": dense_init(gen, (D, K, Dh), dtype=dtype, device=device),
        "wv": dense_init(gen, (D, K, Dh), dtype=dtype, device=device),
        "wo": dense_init(gen, (H, Dh, D), in_axis=0, dtype=dtype, device=device),
    }


def _init_mla(gen, cfg, dtype, device):
    """MLA's parameters; the latent norms' scales are f32 zeros (RMSNorm
    stores ``scale - 1``), as in the reference."""
    s = cfg.mla
    D, H = cfg.d_model, cfg.num_heads

    def w(shape, in_axis=0):
        return dense_init(gen, shape, in_axis, dtype=dtype, device=device)
    return {
        "wq_a": w((D, s.q_lora_rank)),
        "q_norm": torch.zeros((s.q_lora_rank,), dtype=torch.float32,
                              device=device),
        "wq_b": w((s.q_lora_rank, H, s.qk_head_dim)),
        "wkv_a": w((D, s.kv_lora_rank + s.qk_rope_head_dim)),
        "kv_norm": torch.zeros((s.kv_lora_rank,), dtype=torch.float32,
                               device=device),
        "wkv_b": w((s.kv_lora_rank, H, s.qk_nope_head_dim + s.v_head_dim)),
        "wo": w((H, s.v_head_dim, D), in_axis=0),
    }


def _project(x, w, compute):
    """einsum("bsd,dhk->bshk") as one matmul; under a mesh each rank
    projects its own heads with its column slice, and the output stays
    split over the ranks on the head dim."""
    return on_ranks(functools.partial(_project_whole, compute=compute), x, w,
                    dim=-2)


def _project_whole(x, w, compute):
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
    return _chunked_attention_abs(q, k, v, q_offset=q_offset, kv_offset=0,
                                  window=window, chunk=chunk, causal=causal)


def causal_blocked_attention(q, k, v, *, window=None, chunk=1024,
                             block_q=2048):
    """Triangular block iteration (the reference's ``attn_impl=
    "causal_blocked"``): each block of ``block_q`` queries attends only to
    its causal (and windowed) KV prefix, which skips about half the work
    of `chunked_attention`.  Self-attention only (S == T); an S that is not
    a multiple of ``block_q`` takes `chunked_attention`."""
    S, T = q.shape[1], k.shape[1]
    if S != T:
        raise ValueError("causal_blocked_attention is for self-attention")
    block_q = min(block_q, S)
    if S % block_q:
        return chunked_attention(q, k, v, causal=True, window=window,
                                 chunk=chunk)
    outs = []
    for i in range(S // block_q):
        q_lo, q_hi = i * block_q, (i + 1) * block_q
        kv_lo = 0
        if window is not None:
            kv_lo = max(0, (q_lo - window + 1) // chunk * chunk)
        outs.append(_chunked_attention_abs(
            q[:, q_lo:q_hi], k[:, kv_lo:q_hi], v[:, kv_lo:q_hi],
            q_offset=q_lo, kv_offset=kv_lo, window=window, chunk=chunk))
    return torch.cat(outs, dim=1)


def _chunked_attention_abs(q, k, v, *, q_offset, kv_offset, window, chunk,
                           causal=True):
    """`chunked_attention` with keys at absolute positions ``kv_offset +
    0..T-1`` (the blocked iteration's KV slices)."""
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
        t_pos = kv_offset + lo + torch.arange(chunk, device=dev)
        s = torch.einsum("bskgd,btkd->bkgst", qg, kb) * scale
        valid = _mask_chunk(q_pos, t_pos, causal, window)
        valid &= t_pos[None, :] < kv_offset + T
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
    if cfg.attn_impl == "causal_blocked" and causal:
        return causal_blocked_attention(q, k, v, window=window,
                                        chunk=cfg.attn_chunk)
    if cfg.attn_impl == "pallas":
        from repro_torch.kernels.flash_attention.ops import flash_attention
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window, q_offset=q_offset)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, chunk=cfg.attn_chunk)


def decode_attend(q, k_cache, v_cache, cache_len, *, window=None):
    """Single-token attention against a KV cache (the reference's pure-JAX
    decode path).  q: (B,1,H,Dh); caches: (B,T,K,Dh); cache_len: (B,) valid
    entries per row.  f32 softmax; the normalised p is cast to bf16.
    ``window`` is taken and not applied, as in the reference: a rolling
    ring holds only the last ``window`` positions, so every valid slot is
    inside the window."""
    B, _, H, Dh = q.shape
    T, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, Dh).to(torch.bfloat16).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg,
                     k_cache.to(torch.bfloat16).float()) * (1.0 / Dh ** 0.5)
    cl = _row_positions(cache_len, B, q.device)
    valid = torch.arange(T, device=q.device)[None, :] < cl[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(torch.bfloat16).float(),
                       v_cache.to(torch.bfloat16).float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


# ==========================================================================
# Full layer forward (train): projection + rope + attend + out-projection
# ==========================================================================

def attention_forward(x, p, cfg, *, rope_cos, rope_sin, causal=True,
                      window=None, kv=None, compute=COMPUTE):
    """Self-attention (``kv`` None) or cross-attention over a full
    sequence.  x: (B,S,D); rope tables (S, rope_dim/2) match S, None for
    cross-attention.  Cross-attention projects K and V from ``kv``
    (B,T,D), the encoder's output, and attends every query to all T keys
    when ``causal`` is False (through `attend`: the flash kernel at S != T
    on the kernel flags)."""
    if cfg.mla is not None:
        return _mla_forward(x, p, cfg, rope_cos, rope_sin, compute)
    src = x if kv is None else kv
    q = _project(x, p["wq"], compute)
    k = _project(src, p["wk"], compute)
    v = _project(src, p["wv"], compute)
    if rope_cos is not None:
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
    out = attend(q, k, v, cfg, causal=causal, window=window)
    return _out_project(out, p["wo"], compute)


# ==========================================================================
# Prefill
# ==========================================================================

def _ring_write_full(k, v, cache):
    """Write a full prefill's k/v (B,S,K,Dh) into a (possibly rolling)
    cache (B,T,K,Dh), so that position p sits at slot ``p mod T``: with
    S <= T rows past S are zero; with S > T (a sliding-window ring) each
    slot keeps its latest occupant, ``pos = S-1 - ((S-1-slot) mod T)``."""
    S = k.shape[1]
    T = cache["k"].shape[1]
    if S <= T:
        pad = (0, 0, 0, 0, 0, T - S)
        return {"k": torch.nn.functional.pad(k, pad).to(cache["k"].dtype),
                "v": torch.nn.functional.pad(v, pad).to(cache["v"].dtype)}
    pos = (S - 1) - torch.remainder(
        (S - 1) - torch.arange(T, device=k.device), T)
    return {"k": k[:, pos].to(cache["k"].dtype),
            "v": v[:, pos].to(cache["v"].dtype)}


def attention_prefill(x, p, cfg, rope, cache, *, window=None,
                      compute=COMPUTE):
    """Full-sequence causal self-attention (keys within ``window`` of each
    query when it is set) that also fills the decode cache.  Returns (out
    (B,S,D), new_cache)."""
    if cfg.mla is not None:
        return _mla_prefill(x, p, cfg, rope, cache, compute)
    q, k, v = _split_heads(_project(x, p["wq"], compute),
                           _project(x, p["wk"], compute),
                           _project(x, p["wv"], compute))

    def heads(q, k, v, cos, sin):
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        out = attend(q, k, v, cfg, causal=True, window=window)
        ring = _ring_write_full(k, v, cache)     # reads cache's shapes only
        return out, ring["k"], ring["v"]
    out, k, v = on_ranks(heads, q, k, v, rope[0], rope[1], dim=-2)
    return _out_project(gather(out), p["wo"], compute), {"k": k, "v": v}


# ==========================================================================
# Decode (paged or dense) and speculative verify
# ==========================================================================
#
# The paged cache is a shared pool ``(num_blocks, block_size, K, Dh)`` plus
# a per-row block table ``(B, max_blocks)``: logical position ``p`` of row
# ``b`` lives at ``pool[table[b, p // bs], p % bs]``.  Block 0 is the
# scratch block: free slots keep decoding over it and their writes land
# there, never in a live request's blocks.  The dense cache (the kv="dense"
# ablation) is a per-row ring ``(B, T, K, Dh)``: position ``p`` of row ``b``
# lives at ``cache[b, p % T]``.  With ``T == max_blocks * block_size`` both
# layouts give the attend step the same shapes, so paged and dense decode
# agree bit for bit.

def _row_positions(pos, batch: int, device):
    """Scalar or (B,) decode position(s) (or count) -> (B,) int32.  An int
    is filled on the device: a copy from pageable host memory cannot be
    captured in a CUDA graph (whisper's decode step attends its frames'
    count, an int)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).expand(batch)
    return torch.full((batch,), pos, dtype=torch.int32, device=device)


def _paged_write_index(block_tables, pos, block_size: int):
    """Where row b's new entry lands: ``(table[b, (pos_b // bs) % mb],
    pos_b % bs)`` — the reference's `_paged_write_rows` wrap."""
    mb = block_tables.shape[1]
    pos = pos.long()
    blk = torch.gather(block_tables.long(), 1,
                       ((pos // block_size) % mb)[:, None])[:, 0]
    return blk, pos % block_size


def _ring_write_index(pos, T: int):
    """Where row b's new entry lands in a dense ring: ``(b, pos_b % T)`` —
    the reference's `_ring_write_rows` slot."""
    return (torch.arange(pos.shape[0], device=pos.device),
            pos.long() % T)


def _paged_write_seq_index(block_tables, positions, block_size: int):
    """Where entry ``s`` of row ``b`` lands for a verify burst at absolute
    ``positions`` (B, S) — the reference's `_paged_write_seq`.  Positions at
    or past the table's reach ``mb * bs`` go to the scratch block 0
    explicitly: a burst can run up to k positions past a row's end before
    acceptance clamps it, and those writes must never land in a live (or
    prefix-shared) block."""
    mb = block_tables.shape[1]
    positions = positions.long()
    inb = positions < mb * block_size
    blk = torch.where(inb, positions // block_size, 0)
    pb = torch.where(inb, torch.gather(block_tables.long(), 1, blk), 0)
    return pb, positions % block_size


def _write_rows(buf, new, index):
    """Write ``new`` (B, S, ...) IN PLACE at ``index`` (two (B, S) or (B,)
    index tensors into ``buf``'s first two dims: a pool's (block, offset)
    or a ring's (row, slot)).  The JAX reference returns a new buffer (its
    engine donates the old one); writing in place is the counterpart and
    keeps one copy in memory."""
    if index[0].dim() == 1:
        new = new[:, 0]
    buf.index_put_(index, new.to(buf.dtype))
    return buf


def _paged_gather(pool, block_tables):
    """Each row's logical view (B, mb * bs, ...) for the plain path."""
    return gather_kv(pool, block_tables)


def _cache_layout(cache) -> tuple[bool, int]:
    """(paged, the extent of the cache's position axis: a pool's block
    size or a ring's length).  GQA leaves end in (K, Dh), MLA's latent
    leaves in one width; stacked or not."""
    if "kp" in cache:
        return True, cache["kp"].shape[-3]
    if "ckvp" in cache:
        return True, cache["ckvp"].shape[-2]
    if "k" in cache:
        return False, cache["k"].shape[-3]
    return False, cache["ckv"].shape[-2]


def decode_context(cfg, pos, cache, block_tables=None) -> dict:
    """What every layer of one decode step shares: the RoPE tables of the
    rows' positions (at `rope_dim`), the write slots and the valid
    lengths.  ``cache`` is any attention layer's cache (stacked or not): a
    paged pool (then ``block_tables`` maps its rows) or a dense ring,
    rolling when it is shorter than the positions it serves
    (sliding-window attention, in either layout); K/V or MLA's latent.
    The reference computes these inside each layer; computing them once
    per step gives the same values with 32x fewer launches."""
    cos, sin = rope_table(pos[:, None], rope_dim(cfg), cfg.rope_theta)
    paged, n = _cache_layout(cache)
    if paged:
        T = block_tables.shape[1] * n
        write = _paged_write_index(block_tables, pos, n)
    else:
        T = n
        write = _ring_write_index(pos, T)
    return {"cos": cos, "sin": sin, "write": write,
            "cache_len": torch.clamp(pos + 1, max=T).to(torch.int32)}


def verify_context(cfg, pos, S: int, cache, block_tables) -> dict:
    """`decode_context` of a verify burst: S positions ``pos..pos+S-1`` per
    row, overflow writes routed to the scratch block."""
    positions = pos[:, None] + torch.arange(S, dtype=torch.int32,
                                            device=pos.device)
    cos, sin = rope_table(positions, rope_dim(cfg), cfg.rope_theta)
    paged, bs = _cache_layout(cache)
    if not paged:
        raise ValueError("speculative verify requires a paged cache")
    return {"cos": cos, "sin": sin, "pos": pos,
            "write": _paged_write_seq_index(block_tables, positions, bs)}


def _split_heads(q, k, v):
    """q, k and v as attention takes them under a mesh: split over the
    ranks on their heads when the model axis divides the KV heads (k is a
    `Shards`: each rank then holds whole kv-groups, query head h beside kv
    head h // G), else all three whole on the lead device, where attention
    runs whole (the reference's fallback when ``tp_heads`` is false).
    Without a mesh, as they are."""
    if isinstance(k, Shards):
        return split(q, k), k, split(v, k)
    return gather(q), k, gather(v)


def _rotate(x, cos, sin):
    """`apply_rope` on each rank's heads."""
    return on_ranks(apply_rope, x, cos, sin, dim=-2)


def _qkv(x, p, ctx, compute):
    """The new tokens' q, k (both rotated to their positions) and v, placed
    by `_split_heads`."""
    q, k, v = _split_heads(_project(x, p["wq"], compute),
                           _project(x, p["wk"], compute),
                           _project(x, p["wv"], compute))
    return (_rotate(q, ctx["cos"], ctx["sin"]),
            _rotate(k, ctx["cos"], ctx["sin"]), v)


def attention_decode(x, p, cfg, cache, pos, *, window=None,
                     block_tables=None, ctx=None, compute=COMPUTE):
    """One decode step.  x: (B,1,D); cache {"kp","vp"}: (nb,bs,K,Dh) pools
    (then ``block_tables`` (B,mb) int32 maps rows to blocks) or {"k","v"}:
    (B,T,K,Dh) dense rings, rolling at ``pos mod T`` when T is a sliding
    window, updated in place; pos: scalar or (B,) absolute position of the
    new token; ``ctx`` the step's `decode_context` (computed here when
    None).  The kernels attend the whole ring with no window (it holds
    only the window); ``window`` goes to the plain `decode_attend`, which
    does not apply it either, as in the reference.  Returns (out (B,1,D),
    cache).  An MLA layer runs `_mla_decode` over its latent cache."""
    if cfg.mla is not None:
        return _mla_decode(x, p, cfg, cache, pos, block_tables, ctx, compute)
    paged = "kp" in cache
    if paged and block_tables is None:
        raise ValueError("a paged cache needs block_tables")
    B = x.shape[0]
    if ctx is None:
        ctx = decode_context(cfg, _row_positions(pos, B, x.device), cache,
                             block_tables)
    q, k, v = _qkv(x, p, ctx, compute)
    kc, vc = (cache["kp"], cache["vp"]) if paged else (cache["k"], cache["v"])
    out = on_ranks(functools.partial(_decode_heads, cfg=cfg, window=window,
                                     paged=paged),
                   q, k, v, kc, vc, block_tables, ctx["write"],
                   ctx["cache_len"], dim=-2)
    return _out_project(gather(out), p["wo"], compute), cache


def _decode_heads(q, k, v, kc, vc, block_tables, write, cache_len, *, cfg,
                  window, paged):
    """One decode step's attention over one rank's heads (all of them
    without a mesh): the new K/V rows written into the rank's pools or
    rings in place, then the attend (a kernel on the kernel flags)."""
    _write_rows(kc, k, write)
    _write_rows(vc, v, write)
    if cfg.attn_impl == "pallas":
        if paged:
            from repro_torch.kernels.paged_attention.ops import (
                paged_decode_attention)
            out = paged_decode_attention(q[:, 0].contiguous(), kc, vc,
                                         block_tables, cache_len)
        else:
            from repro_torch.kernels.decode_attention.ops import (
                decode_attention)
            out = decode_attention(q[:, 0].contiguous(), kc, vc, cache_len)
        return out[:, None]
    if paged:
        return decode_attend(q, _paged_gather(kc, block_tables),
                             _paged_gather(vc, block_tables), cache_len,
                             window=window)
    return decode_attend(q, kc, vc, cache_len, window=window)


def attention_verify(x, p, cfg, cache, pos, *, block_tables, ctx=None,
                     compute=COMPUTE):
    """Speculative-verify attention: S = k+1 positions of every row in ONE
    forward.  x: (B,S,D); pos: (B,) absolute position of x[:,0]; paged
    cache only (the engine gates speculation to paged KV), updated in
    place; ``ctx`` the burst's `verify_context` (computed here when None).

    Writes the S new KV rows at ``pos..pos+S-1`` (overflow past the table's
    reach lands in the scratch block), then attends each query with its own
    causal frontier ``cache_len = pos+s+1``.  The plain path loops the S
    queries through `decode_attend`, the exact shapes, masks and reduction
    order of a decode step; the kernel runs the decode kernel's arithmetic
    per query.  Either way accepted speculative tokens are those of
    spec="off" greedy decode.  Returns (out (B,S,D), cache).  An MLA layer
    runs `_mla_verify` over its latent pools."""
    if cfg.mla is not None:
        return _mla_verify(x, p, cfg, cache, pos, block_tables, ctx, compute)
    if "kp" not in cache:
        raise ValueError("attention_verify requires a paged KV cache")
    B, S, _ = x.shape
    if ctx is None:
        ctx = verify_context(cfg, _row_positions(pos, B, x.device), S, cache,
                             block_tables)
    q, k, v = _qkv(x, p, ctx, compute)
    out = on_ranks(functools.partial(_verify_heads, cfg=cfg), q, k, v,
                   cache["kp"], cache["vp"], block_tables, ctx["write"],
                   ctx["pos"], dim=-2)
    return _out_project(gather(out), p["wo"], compute), cache


def _verify_heads(q, k, v, kc, vc, block_tables, write, pos, *, cfg):
    """A verify burst's attention over one rank's heads (all of them
    without a mesh): the S new rows written into the rank's pools, then
    each query at its own frontier."""
    _write_rows(kc, k, write)
    _write_rows(vc, v, write)
    if cfg.attn_impl == "pallas":
        from repro_torch.kernels.paged_attention.ops import (
            paged_verify_attention)
        return paged_verify_attention(q.contiguous(), kc, vc, block_tables,
                                      pos)
    T = block_tables.shape[1] * kc.shape[1]
    kg = _paged_gather(kc, block_tables)
    vg = _paged_gather(vc, block_tables)
    return torch.cat([decode_attend(q[:, s:s + 1], kg, vg,
                                    torch.clamp(pos + s + 1, max=T))
                      for s in range(q.shape[1])], dim=1)


# ==========================================================================
# Chunked prefill
# ==========================================================================
#
# An admission prefill split into chunks, so that running slots never wait
# on a whole prompt: each chunk writes its K/V into the admitted row's
# blocks (paged) or ring row (dense), then attends against everything
# cached so far with a causal mask on absolute positions.  One batch row at
# a time; the other rows' state is not touched.

def _paged_write_chunk(pool, new, table_row, positions):
    """Write a chunk's rows of ONE batch row IN PLACE: pool (nb, bs, ...),
    new (C, ...), table_row (mb,), positions (C,) absolute; position ``p``
    lands at ``pool[table_row[(p // bs) % mb], p % bs]``."""
    bs = pool.shape[1]
    mb = table_row.shape[0]
    positions = positions.long()
    blk = table_row.long()[(positions // bs) % mb]
    pool.index_put_((blk, positions % bs), new.to(pool.dtype))
    return pool


def _chunk_attend(q, k, v, q_pos, t_pos=None, window=None):
    """Causal attention of a prefill chunk against gathered cache K/V.

    q: (1,C,H,Dh); k,v: (1,T,K,Dh); q_pos: (C,) absolute query positions;
    t_pos: (T,) absolute key positions (default 0..T-1; negative ones are
    invalid: ring slots before position 0).  bf16 operands, f32 sums and
    softmax, masked scores at -1e30, as `decode_attend`."""
    B, C, H, Dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if t_pos is None:
        t_pos = torch.arange(T, device=q.device)
    qg = q.reshape(B, C, K, G, Dh).to(torch.bfloat16).float()
    s = torch.einsum("bckgd,btkd->bkgct", qg,
                     k.to(torch.bfloat16).float()) * (1.0 / Dh ** 0.5)
    valid = (t_pos[None, :] <= q_pos[:, None]) & (t_pos[None, :] >= 0)
    if window is not None:
        valid &= t_pos[None, :] > (q_pos[:, None] - window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgct,btkd->bckgd", p.to(torch.bfloat16).float(),
                       v.to(torch.bfloat16).float())
    return out.reshape(B, C, H, Dh).to(q.dtype)


def _ring_write_chunk_row(row, chunk, q_offset):
    """A ring row (W, ...) after writing a chunk (C, ...) at absolute
    positions ``q_offset..q_offset+C-1`` (``q_offset`` an int or a 0-d
    device tensor): each ring slot keeps the LATEST position <=
    q_offset+C-1 that maps to it (the gather form of the rolling write,
    right for any ratio of C to W).  Returns a new row."""
    W, C = row.shape[0], chunk.shape[0]
    r = torch.arange(W, device=row.device)
    last = q_offset + C - 1
    p = last - torch.remainder(last - r, W)      # latest pos = r (mod W)
    take = p >= q_offset
    src = chunk[torch.clamp(p - q_offset, 0, C - 1)]
    return torch.where(take.reshape((W,) + (1,) * (row.dim() - 1)),
                       src.to(row.dtype), row)


def attention_prefill_chunk(x, p, cfg, cache, table_row, slot, q_offset, *,
                            window=None, compute=COMPUTE):
    """One prefill chunk of ONE batch row.  x: (1,C,D); cache: the layer's
    engine cache, paged pools {"kp","vp"} (nb,bs,K,Dh) or dense rings
    {"k","v"} (B,T,K,Dh), written IN PLACE; table_row: (mb,) int32 block
    ids of the admitted row (passed explicitly: the engine installs the row
    into the shared block table only when the last chunk lands, so free-slot
    writes keep hitting the scratch block meanwhile); slot: the batch row;
    q_offset: absolute position of x[:,0].  ``slot`` and ``q_offset`` are
    ints, or 0-d int32 tensors on the device (a captured chunk's static
    inputs, the reference's traced scalars): nothing branches on their
    values.  Returns (out (1,C,D), cache).
    An MLA layer runs `_mla_prefill_chunk` (paged latent pools only)."""
    if cfg.mla is not None:
        return _mla_prefill_chunk(x, p, cfg, cache, table_row, q_offset,
                                  compute)
    C = x.shape[1]
    positions = q_offset + torch.arange(C, device=x.device)
    cos, sin = rope_table(positions[None], cfg.head_dim, cfg.rope_theta)
    ctx = {"cos": cos, "sin": sin}
    q, k, v = _qkv(x, p, ctx, compute)
    paged = "kp" in cache
    kc, vc = (cache["kp"], cache["vp"]) if paged else (cache["k"], cache["v"])
    out = on_ranks(functools.partial(_chunk_heads, paged=paged, slot=slot,
                                     q_offset=q_offset, window=window),
                   q, k, v, kc, vc, table_row, positions, dim=-2)
    return _out_project(gather(out), p["wo"], compute), cache


def _chunk_heads(q, k, v, kc, vc, table_row, positions, *, paged, slot,
                 q_offset, window):
    """A prefill chunk's attention over one rank's heads (all of them
    without a mesh): the chunk's K/V written into the rank's blocks or
    ring row in place, then the causal attend against everything cached."""
    if paged:
        _paged_write_chunk(kc, k[0], table_row, positions)
        _paged_write_chunk(vc, v[0], table_row, positions)
        kg = _paged_gather(kc, table_row[None])              # (1,T,K,Dh)
        vg = _paged_gather(vc, table_row[None])
        return _chunk_attend(q, kg, vg, positions)
    # dense ring row of W slots (a copy, written back)
    k_row, v_row = read_row(kc, slot)[0], read_row(vc, slot)[0]
    W = k_row.shape[0]
    # the last W cached positions in order, read BEFORE the chunk writes
    # over them (ring slot of position p is p mod W)
    p_prev = q_offset - W + torch.arange(W, device=q.device)
    slots_prev = torch.remainder(p_prev, W)
    k_all = torch.cat([k_row[slots_prev][None], k], dim=1)
    v_all = torch.cat([v_row[slots_prev][None], v], dim=1)
    out = _chunk_attend(q, k_all, v_all, positions,
                        t_pos=torch.cat([p_prev, positions]), window=window)
    write_row(kc, slot, _ring_write_chunk_row(k_row, k[0], q_offset)[None])
    write_row(vc, slot, _ring_write_chunk_row(v_row, v[0], q_offset)[None])
    return out


# ==========================================================================
# Caches
# ==========================================================================

def init_kv_cache(cfg, batch: int, max_len: int, dtype=COMPUTE, device="cpu"):
    """Per-attention-layer dense cache (the one-shot prefill's output):
    rings of ``min(max_len, sliding_window)`` positions (all of
    ``max_len`` without a window).  MLA: latent rings ``{"ckv",
    "krope"}`` of ``max_len`` positions."""
    if cfg.mla is not None:
        s = cfg.mla
        return {"ckv": torch.zeros((batch, max_len, s.kv_lora_rank),
                                   dtype=dtype, device=device),
                "krope": torch.zeros((batch, max_len, s.qk_rope_head_dim),
                                     dtype=dtype, device=device)}
    T = (max_len if cfg.sliding_window is None
         else min(max_len, cfg.sliding_window))
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, T, K, Dh), dtype=dtype, device=device),
            "v": torch.zeros((batch, T, K, Dh), dtype=dtype, device=device)}


def init_kv_cache_paged(cfg, batch: int, max_len: int, num_blocks: int,
                        block_size: int, dtype=COMPUTE, device="cpu"):
    """Per-attention-layer paged cache: shared block pools, ``{"kp",
    "vp"}`` (nb, bs, K, Dh) or MLA's latent ``{"ckvp", "kropep"}`` (nb, bs,
    kv_lora_rank / qk_rope_head_dim).  A GQA sliding-window layer keeps its
    dense rolling ring instead (``batch`` x ``min(max_len, window)``), as
    in the reference: the ring is always fully live, so paging it saves
    nothing, and it keeps decode bitwise the dense path's."""
    if cfg.mla is not None:                  # the latent pools
        s = cfg.mla
        shapes = {"ckvp": (num_blocks, block_size, s.kv_lora_rank),
                  "kropep": (num_blocks, block_size, s.qk_rope_head_dim)}
    elif cfg.sliding_window is not None:
        return init_kv_cache(cfg, batch, max_len, dtype, device)
    else:
        shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
        shapes = {"kp": shape, "vp": shape}
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, shape in shapes.items()}


# ==========================================================================
# MLA (multi-head latent attention)
# ==========================================================================
#
# Expanded (train, one-shot prefill): every head's key is [k_nope, k_rope]
# (k_nope from the latent through ``wkv_b``, k_rope one rotated key shared
# by the heads) and its value, zero-padded to the key's width, goes through
# `attend`.  Absorbed (decode, verify, chunks): ``wkv_b``'s key half folds
# into the query, so each query scores the cached latent directly,
#     score = (q_nope W_k) . ckv + q_rope . krope,
# and its value half maps the attended latent back to each head.


def _mla_q(x, p, cfg, compute):
    """The heads' queries (B,S,H,qk_head_dim) from the normed q latent
    (``wq_a`` and ``q_norm`` whole on the lead device; under a mesh
    ``wq_b`` splits the heads over the ranks), not rotated."""
    ql = rmsnorm(x @ p["wq_a"].to(compute), p["q_norm"], cfg.norm_eps)
    return _project(ql, p["wq_b"], compute)


def _mla_split_q(q, cos, sin, *, nope: int):
    """(q_nope, q_rope rotated) of one rank's heads."""
    return q[..., :nope], apply_rope(q[..., nope:], cos, sin)


def _mla_latent(x, p, cfg, cos, sin, compute):
    """The new tokens' cache rows: the normed latent ckv (B,S,r) and the
    rotated shared key krope (B,S,rope), whole on the lead device."""
    r = cfg.mla.kv_lora_rank
    kv_a = x @ p["wkv_a"].to(compute)
    ckv = rmsnorm(kv_a[..., :r], p["kv_norm"], cfg.norm_eps)
    return ckv, apply_rope(kv_a[:, :, None, r:], cos, sin)[:, :, 0]


def _mla_expanded(x, p, cfg, cos, sin, compute):
    """The expanded attention of a full sequence: (out (B,S,D), ckv,
    krope), ``attend`` run on q/k of width ``qk_head_dim`` and V padded to
    it, over each rank's heads under a mesh."""
    q = _mla_q(x, p, cfg, compute)
    ckv, krope = _mla_latent(x, p, cfg, cos, sin, compute)
    out = on_ranks(functools.partial(_mla_expanded_heads, cfg=cfg,
                                     compute=compute),
                   q, ckv, krope, p["wkv_b"], cos, sin, dim=-2)
    return _out_project(gather(out), p["wo"], compute), ckv, krope


def _mla_expanded_heads(q, ckv, krope, wkv_b, cos, sin, *, cfg, compute):
    """The expanded attention of one rank's heads (all of them without a
    mesh): per-head keys and values from the latent through the rank's
    ``wkv_b`` columns."""
    s = cfg.mla
    B, S, H = q.shape[:3]
    q_nope, q_rope = _mla_split_q(q, cos, sin, nope=s.qk_nope_head_dim)
    kv = _project_whole(ckv, wkv_b, compute)             # (B,S,H,nope+v)
    k_nope, v = kv[..., :s.qk_nope_head_dim], kv[..., s.qk_nope_head_dim:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, krope[:, :, None].expand(
        B, S, H, s.qk_rope_head_dim)], dim=-1)
    v_pad = torch.nn.functional.pad(v, (0, s.qk_head_dim - s.v_head_dim))
    return attend(q, k, v_pad, cfg, causal=True)[..., :s.v_head_dim]


def _mla_forward(x, p, cfg, rope_cos, rope_sin, compute):
    """The train path's MLA layer (full expansion)."""
    return _mla_expanded(x, p, cfg, rope_cos, rope_sin, compute)[0]


def _mla_prefill(x, p, cfg, rope, cache, compute):
    """MLA prefill: the expanded attention, and the latent rows written
    into the ring ``cache`` {"ckv", "krope"} (B,T,*): padded past S, or
    the last T positions when S > T."""
    out, ckv, krope = _mla_expanded(x, p, cfg, rope[0], rope[1], compute)
    S, T = x.shape[1], cache["ckv"].shape[1]

    def fit(t, like):
        t = (torch.nn.functional.pad(t, (0, 0, 0, T - S)) if S <= T
             else t[:, -T:])
        return t.to(like.dtype)
    return out, {"ckv": fit(ckv, cache["ckv"]),
                 "krope": fit(krope, cache["krope"])}


def _mla_latent_attend(q_nope, q_rope, ckv, krope, valid, wkv_b, *, cfg,
                       compute):
    """The absorbed-weight score over a latent view, the reference's
    `_mla_decode` math with a query axis: q_nope (B,C,H,nope) and q_rope
    (B,C,H,rope) rotated; ckv (B,T,r), krope (B,T,rope); valid (B,C,T);
    ``wkv_b`` (r,H,nope+v), the heads' columns.  The score and value sums
    take bf16 operands and sum in f32; f32 softmax.  Returns the heads'
    outputs (B,C,H,v) in ``compute``."""
    s = cfg.mla
    wkv_b = wkv_b.to(compute)
    wk = wkv_b[..., :s.qk_nope_head_dim]
    wv = wkv_b[..., s.qk_nope_head_dim:]
    q_lat = torch.einsum("bchn,rhn->bchr", q_nope, wk)   # absorb, bf16
    ckv_f = ckv.to(compute).float()
    scores = (torch.einsum("bchr,btr->bhct", q_lat.float(), ckv_f)
              + torch.einsum("bchk,btk->bhct", q_rope.to(compute).float(),
                             krope.to(compute).float())
              ) * (1.0 / s.qk_head_dim ** 0.5)
    scores = torch.where(valid[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhct,btr->bchr", probs.to(compute).float(), ckv_f)
    return torch.einsum("bchr,rhv->bchv", out_lat.to(compute), wv)


def _mla_attend(q_nope, q_rope, ckv, krope, valid, p, cfg, compute):
    """`_mla_latent_attend` over each rank's heads, gathered: the latent
    view is whole on every rank (the reference gathers it before the
    score), the heads and their ``wkv_b`` columns split."""
    return gather(on_ranks(functools.partial(_mla_latent_attend, cfg=cfg,
                                             compute=compute),
                           q_nope, q_rope, ckv, krope, valid, p["wkv_b"],
                           dim=-2))


def _write_split(buf, new, write):
    """`_write_rows` of ``new`` into ``buf`` in place, each rank its
    part of a latent pool or ring split over the ranks."""
    for dst, src in pairs(buf, new):
        _write_rows(dst, src, tuple(i.to(dst.device) for i in write))
    return buf


def _latent_view(pool, block_tables):
    """A paged latent pool's per-row view (B, mb * bs, *), whole on the
    lead device: each rank's view of its latent columns, gathered."""
    return gather(on_ranks(_paged_gather, pool, block_tables, dim=-1))


def _mla_queries(x, p, cfg, cos, sin, compute):
    s = cfg.mla
    return on_ranks(functools.partial(_mla_split_q, nope=s.qk_nope_head_dim),
                    _mla_q(x, p, cfg, compute), cos, sin, dim=-2)


def _mla_decode(x, p, cfg, cache, pos, block_tables, ctx, compute):
    """One MLA decode step over the latent cache: paged pools {"ckvp",
    "kropep"} (nb,bs,*) read through ``block_tables``, or dense rings
    {"ckv", "krope"} (B,T,*); the new rows written in place at the
    step context's slots."""
    paged = "ckvp" in cache
    if paged and block_tables is None:
        raise ValueError("a paged cache needs block_tables")
    B = x.shape[0]
    if ctx is None:
        ctx = decode_context(cfg, _row_positions(pos, B, x.device), cache,
                             block_tables)
    q_nope, q_rope = _mla_queries(x, p, cfg, ctx["cos"], ctx["sin"], compute)
    ckv_new, kr_new = _mla_latent(x, p, cfg, ctx["cos"], ctx["sin"], compute)
    if paged:
        _write_split(cache["ckvp"], ckv_new, ctx["write"])
        _write_split(cache["kropep"], kr_new, ctx["write"])
        ckv = _latent_view(cache["ckvp"], block_tables)
        krope = _latent_view(cache["kropep"], block_tables)
    else:
        ckv = gather(_write_split(cache["ckv"], ckv_new, ctx["write"]))
        krope = gather(_write_split(cache["krope"], kr_new, ctx["write"]))
    T = ckv.shape[1]
    valid = (torch.arange(T, device=x.device)[None]
             < ctx["cache_len"][:, None])[:, None]          # (B,1,T)
    out = _mla_attend(q_nope, q_rope, ckv, krope, valid, p, cfg, compute)
    return _out_project(out, p["wo"], compute), cache


def _mla_verify(x, p, cfg, cache, pos, block_tables, ctx, compute):
    """MLA speculative verify over the paged latent pools: the S new rows
    written at ``pos..pos+S-1``, then each query through `_mla_decode`'s
    math at its own frontier (the same shapes and reduction order: the
    bitwise-parity contract)."""
    if "ckvp" not in cache:
        raise ValueError("MLA verify requires the paged latent pools")
    B, S, _ = x.shape
    if ctx is None:
        ctx = verify_context(cfg, _row_positions(pos, B, x.device), S, cache,
                             block_tables)
    q_nope, q_rope = _mla_queries(x, p, cfg, ctx["cos"], ctx["sin"], compute)
    ckv_new, kr_new = _mla_latent(x, p, cfg, ctx["cos"], ctx["sin"], compute)
    _write_split(cache["ckvp"], ckv_new, ctx["write"])
    _write_split(cache["kropep"], kr_new, ctx["write"])
    ckv = _latent_view(cache["ckvp"], block_tables)
    krope = _latent_view(cache["kropep"], block_tables)
    T = ckv.shape[1]
    t = torch.arange(T, device=x.device)[None]
    outs = []
    for sq in range(S):
        valid = (t < torch.clamp(ctx["pos"] + sq + 1, max=T)[:, None])[:, None]
        out = _mla_attend(q_nope[:, sq:sq + 1], q_rope[:, sq:sq + 1], ckv,
                          krope, valid, p, cfg, compute)
        outs.append(_out_project(out, p["wo"], compute))
    return torch.cat(outs, dim=1), cache


def _mla_prefill_chunk(x, p, cfg, cache, table_row, q_offset, compute):
    """One chunk of an MLA admission into the paged latent pools: its rows
    written at ``q_offset..``, then its C queries scored against the
    row's latent view by the absorbed math, causally.  A dense MLA engine
    admits one-shot (the reference's chunk path speaks only the pools)."""
    if "ckvp" not in cache:
        raise ValueError("MLA chunked admission requires the paged latent "
                         "pools; a dense MLA engine admits one-shot")
    C = x.shape[1]
    positions = q_offset + torch.arange(C, device=x.device)
    cos, sin = rope_table(positions[None], rope_dim(cfg), cfg.rope_theta)
    q_nope, q_rope = _mla_queries(x, p, cfg, cos, sin, compute)
    ckv_new, kr_new = _mla_latent(x, p, cfg, cos, sin, compute)
    for pool, new in ((cache["ckvp"], ckv_new[0]), (cache["kropep"],
                                                    kr_new[0])):
        for dst, src in pairs(pool, new):
            _paged_write_chunk(dst, src, table_row.to(dst.device),
                               positions.to(dst.device))
    ckv = _latent_view(cache["ckvp"], table_row[None])           # (1,T,r)
    krope = _latent_view(cache["kropep"], table_row[None])
    T = ckv.shape[1]
    valid = (torch.arange(T, device=x.device)[None, :]
             <= positions[:, None])[None]                        # (1,C,T)
    out = _mla_attend(q_nope, q_rope, ckv, krope, valid, p, cfg, compute)
    return _out_project(out, p["wo"], compute), cache
