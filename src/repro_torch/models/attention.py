"""Attention (GQA): prefill, decode (paged or dense KV) and speculative
verify paths.

Port of the GQA part of ``repro.models.attention``.  ``cfg.attn_impl``
selects the attend step:

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

Masks use ``NEG_INF = -1e30`` (a fully masked row is uniform, not NaN);
Q.K and P.V take bf16 operands and sum in f32.  MLA is a later slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.ops import gather_kv
from repro_torch.models.layers import COMPUTE, apply_rope, dense_init, rope_table

NEG_INF = -1e30


def _check_gqa(cfg):
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MLA is a later slice of the port (ROADMAP.md "
            "Queue 1 item 6, MLA); this one carries GQA, with or without a "
            "sliding window")


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
    cl = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device).expand(B)
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
    """Self-attention over a full sequence, the train path's layer.
    x: (B,S,D); rope tables (S, Dh/2) match S.  Cross-attention (``kv``)
    and MLA are ROADMAP.md Queue 1 item 6 (the encoder-decoder and MLA
    archs)."""
    if kv is not None or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: cross-attention and MLA come with their archs, "
            "ROADMAP.md Queue 1 item 6")
    _check_gqa(cfg)
    q = _project(x, p["wq"], compute)
    k = _project(x, p["wk"], compute)
    v = _project(x, p["wv"], compute)
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
    _check_gqa(cfg)
    q = _project(x, p["wq"], compute)
    k = _project(x, p["wk"], compute)
    v = _project(x, p["wv"], compute)
    q = apply_rope(q, rope[0], rope[1])
    k = apply_rope(k, rope[0], rope[1])
    out = attend(q, k, v, cfg, causal=True, window=window)
    return _out_project(out, p["wo"], compute), _ring_write_full(k, v, cache)


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


def decode_context(cfg, pos, cache, block_tables=None) -> dict:
    """What every layer of one decode step shares: the RoPE tables of the
    rows' positions, the write slots and the valid lengths.  ``cache`` is
    any attention layer's cache (stacked or not): a paged pool (then
    ``block_tables`` maps its rows) or a dense ring, rolling when it is
    shorter than the positions it serves (sliding-window attention, in
    either layout).  The reference computes these inside each layer;
    computing them once per step gives the same values with 32x fewer
    launches."""
    cos, sin = rope_table(pos[:, None], cfg.head_dim, cfg.rope_theta)
    if "kp" not in cache:
        T = cache["k"].shape[-3]
        write = _ring_write_index(pos, T)
    else:
        bs = cache["kp"].shape[-3]
        T = block_tables.shape[1] * bs
        write = _paged_write_index(block_tables, pos, bs)
    return {"cos": cos, "sin": sin, "write": write,
            "cache_len": torch.clamp(pos + 1, max=T).to(torch.int32)}


def verify_context(cfg, pos, S: int, cache, block_tables) -> dict:
    """`decode_context` of a verify burst: S positions ``pos..pos+S-1`` per
    row, overflow writes routed to the scratch block."""
    positions = pos[:, None] + torch.arange(S, dtype=torch.int32,
                                            device=pos.device)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    return {"cos": cos, "sin": sin, "pos": pos,
            "write": _paged_write_seq_index(block_tables, positions,
                                            cache["kp"].shape[-3])}


def _qkv(x, p, ctx, compute):
    """The new tokens' q, k (both rotated to their positions) and v."""
    q = apply_rope(_project(x, p["wq"], compute), ctx["cos"], ctx["sin"])
    k = apply_rope(_project(x, p["wk"], compute), ctx["cos"], ctx["sin"])
    return q, k, _project(x, p["wv"], compute)


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
    cache)."""
    _check_gqa(cfg)
    paged = "kp" in cache
    if paged and block_tables is None:
        raise ValueError("a paged cache needs block_tables")
    B = x.shape[0]
    if ctx is None:
        ctx = decode_context(cfg, _row_positions(pos, B, x.device), cache,
                             block_tables)
    q, k, v = _qkv(x, p, ctx, compute)
    kc, vc = (cache["kp"], cache["vp"]) if paged else (cache["k"], cache["v"])
    _write_rows(kc, k, ctx["write"])
    _write_rows(vc, v, ctx["write"])
    if cfg.attn_impl == "pallas":
        if paged:
            from repro_torch.kernels.paged_attention.ops import (
                paged_decode_attention)
            out = paged_decode_attention(q[:, 0].contiguous(), kc, vc,
                                         block_tables, ctx["cache_len"])
        else:
            from repro_torch.kernels.decode_attention.ops import (
                decode_attention)
            out = decode_attention(q[:, 0].contiguous(), kc, vc,
                                   ctx["cache_len"])
        out = out[:, None]
    elif paged:
        out = decode_attend(q, _paged_gather(kc, block_tables),
                            _paged_gather(vc, block_tables), ctx["cache_len"],
                            window=window)
    else:
        out = decode_attend(q, kc, vc, ctx["cache_len"], window=window)
    return _out_project(out, p["wo"], compute), cache


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
    spec="off" greedy decode.  Returns (out (B,S,D), cache)."""
    _check_gqa(cfg)
    if "kp" not in cache:
        raise ValueError("attention_verify requires a paged KV cache")
    B, S, _ = x.shape
    if ctx is None:
        ctx = verify_context(cfg, _row_positions(pos, B, x.device), S, cache,
                             block_tables)
    q, k, v = _qkv(x, p, ctx, compute)
    kc = _write_rows(cache["kp"], k, ctx["write"])
    vc = _write_rows(cache["vp"], v, ctx["write"])
    if cfg.attn_impl == "pallas":
        from repro_torch.kernels.paged_attention.ops import (
            paged_verify_attention)
        out = paged_verify_attention(q.contiguous(), kc, vc, block_tables,
                                     ctx["pos"])
    else:
        T = block_tables.shape[1] * kc.shape[1]
        kg = _paged_gather(kc, block_tables)
        vg = _paged_gather(vc, block_tables)
        out = torch.cat([decode_attend(q[:, s:s + 1], kg, vg,
                                       torch.clamp(ctx["pos"] + s + 1, max=T))
                         for s in range(S)], dim=1)
    return _out_project(out, p["wo"], compute), cache


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


def _ring_write_chunk_row(row, chunk, q_offset: int):
    """A ring row (W, ...) after writing a chunk (C, ...) at absolute
    positions ``q_offset..q_offset+C-1``: each ring slot keeps the LATEST
    position <= q_offset+C-1 that maps to it (the gather form of the
    rolling write, right for any ratio of C to W).  Returns a new row."""
    W, C = row.shape[0], chunk.shape[0]
    r = torch.arange(W, device=row.device)
    last = q_offset + C - 1
    p = last - torch.remainder(last - r, W)      # latest pos = r (mod W)
    take = p >= q_offset
    src = chunk[torch.clamp(p - q_offset, 0, C - 1)]
    return torch.where(take.reshape((W,) + (1,) * (row.dim() - 1)),
                       src.to(row.dtype), row)


def attention_prefill_chunk(x, p, cfg, cache, table_row, slot: int,
                            q_offset: int, *, window=None, compute=COMPUTE):
    """One prefill chunk of ONE batch row.  x: (1,C,D); cache: the layer's
    engine cache, paged pools {"kp","vp"} (nb,bs,K,Dh) or dense rings
    {"k","v"} (B,T,K,Dh), written IN PLACE; table_row: (mb,) int32 block
    ids of the admitted row (passed explicitly: the engine installs the row
    into the shared block table only when the last chunk lands, so free-slot
    writes keep hitting the scratch block meanwhile); slot: the batch row;
    q_offset: absolute position of x[:,0].  Returns (out (1,C,D), cache)."""
    _check_gqa(cfg)
    C = x.shape[1]
    positions = q_offset + torch.arange(C, device=x.device)
    cos, sin = rope_table(positions[None], cfg.head_dim, cfg.rope_theta)
    q = apply_rope(_project(x, p["wq"], compute), cos, sin)
    k = apply_rope(_project(x, p["wk"], compute), cos, sin)
    v = _project(x, p["wv"], compute)
    if "kp" in cache:                        # paged pools
        _paged_write_chunk(cache["kp"], k[0], table_row, positions)
        _paged_write_chunk(cache["vp"], v[0], table_row, positions)
        kg = _paged_gather(cache["kp"], table_row[None])      # (1,T,K,Dh)
        vg = _paged_gather(cache["vp"], table_row[None])
        out = _chunk_attend(q, kg, vg, positions)
    else:                                    # dense ring row of W slots
        k_row, v_row = cache["k"][slot], cache["v"][slot]
        W = k_row.shape[0]
        # the last W cached positions in order, read BEFORE the chunk
        # writes over them (ring slot of position p is p mod W)
        p_prev = q_offset - W + torch.arange(W, device=x.device)
        slots_prev = torch.remainder(p_prev, W)
        k_all = torch.cat([k_row[slots_prev][None], k], dim=1)
        v_all = torch.cat([v_row[slots_prev][None], v], dim=1)
        out = _chunk_attend(q, k_all, v_all, positions,
                            t_pos=torch.cat([p_prev, positions]),
                            window=window)
        k_row.copy_(_ring_write_chunk_row(k_row, k[0], q_offset))
        v_row.copy_(_ring_write_chunk_row(v_row, v[0], q_offset))
    return _out_project(out, p["wo"], compute), cache


# ==========================================================================
# Caches
# ==========================================================================

def init_kv_cache(cfg, batch: int, max_len: int, dtype=COMPUTE, device="cpu"):
    """Per-attention-layer dense cache (the one-shot prefill's output):
    rings of ``min(max_len, sliding_window)`` positions (all of
    ``max_len`` without a window)."""
    _check_gqa(cfg)
    T = (max_len if cfg.sliding_window is None
         else min(max_len, cfg.sliding_window))
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, T, K, Dh), dtype=dtype, device=device),
            "v": torch.zeros((batch, T, K, Dh), dtype=dtype, device=device)}


def init_kv_cache_paged(cfg, batch: int, max_len: int, num_blocks: int,
                        block_size: int, dtype=COMPUTE, device="cpu"):
    """Per-attention-layer paged cache: a shared block pool.  A
    sliding-window layer keeps its dense rolling ring instead (`batch` x
    ``min(max_len, window)``), as in the reference: the ring is always
    fully live, so paging it saves nothing, and it keeps decode bitwise
    the dense path's."""
    _check_gqa(cfg)
    if cfg.sliding_window is not None:
        return init_kv_cache(cfg, batch, max_len, dtype, device)
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    shape = (num_blocks, block_size, K, Dh)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}
