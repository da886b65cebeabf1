"""Paged decode and speculative-verify attention: CUDA kernel wrappers +
plain versions.

Replaces the TPU kernels ``paged_decode_attention_kernel`` and
``paged_verify_attention_kernel``
(``src/repro/kernels/paged_attention/kernel.py``; wrappers
``repro.kernels.paged_attention.ops.paged_{decode,verify}_attention``).
The kernels are ``csrc/paged_decode.cu`` and ``csrc/paged_verify.cu``: a
CTA per (row, kv-head, split of the row's sequence) walks its split of the
row's block table, reading each live K/V row once, and the splits merge in
the same launch; the verify CTA holds the S queries of the row and shares
the decode kernel's body and split plan (`split_plan`), so its query ``s``
is bitwise the decode at ``cache_len = min(q_off + s + 1, mb * bs)``.
Both are bound by memory on the H100 (see the sources' headers).

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; there is no other path.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ops import (
    decode_attention_plain, split_buffers, split_plan)

_entries: dict = {}


def gather_kv(pool, block_tables):
    """pool: (nb, bs, ...); block_tables: (B, mb) int.  Returns the per-row
    logical view (B, mb*bs, ...) — ``repro.kernels.paged_attention.ref``'s
    `gather_kv`."""
    B, mb = block_tables.shape
    g = pool[block_tables.long()]                 # (B, mb, bs, ...)
    return g.reshape((B, mb * pool.shape[1]) + tuple(pool.shape[2:]))


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, cache_len):
    """The kernel's function in plain PyTorch: each row's logical view,
    gathered, through `decode_attention_plain` (the kernel's cast points).

    q: (B,H,Dh); pools: (nb,bs,K,Dh); block_tables: (B,mb); cache_len:
    scalar or (B,).  Returns (B,H,Dh) in q's dtype."""
    return decode_attention_plain(q, gather_kv(k_pool, block_tables),
                                  gather_kv(v_pool, block_tables), cache_len)


def paged_verify_attention_plain(q, k_pool, v_pool, block_tables, q_off):
    """The verify kernel's function in plain PyTorch, in the shape of the
    reference oracle (``ref.py: paged_verify_attention_ref``): query ``s``
    is one paged decode at ``cache_len = min(q_off + s + 1, mb * bs)``.

    q: (B,S,H,Dh); pools: (nb,bs,K,Dh); block_tables: (B,mb); q_off:
    scalar or (B,) position of query 0.  Returns (B,S,H,Dh)."""
    B, S = q.shape[:2]
    T = block_tables.shape[1] * k_pool.shape[1]
    off = torch.as_tensor(q_off, dtype=torch.int32, device=q.device).expand(B)
    return torch.stack(
        [paged_decode_attention_plain(q[:, s], k_pool, v_pool, block_tables,
                                      torch.clamp(off + s + 1, max=T))
         for s in range(S)], dim=1)


def _check_paged(what, q, H, Dh, k_pool, v_pool, block_tables, lens, B):
    K = k_pool.shape[2]
    if H % K or Dh > 256 or k_pool.shape[3] != Dh:
        raise ValueError(f"{what}: unsupported heads/dims q "
                         f"{tuple(q.shape)} pool {tuple(k_pool.shape)}")
    _build.check_operands(what, q.device, (
        ("q", q, torch.bfloat16), ("k_pool", k_pool, torch.bfloat16),
        ("v_pool", v_pool, torch.bfloat16),
        ("block_tables", block_tables, torch.int32),
        ("lengths", lens, torch.int32)))
    if v_pool.shape != k_pool.shape or block_tables.shape[0] != B \
            or tuple(lens.shape) != (B,):
        raise ValueError(f"{what}: shape mismatch")


def _launch(name, symbol, q, k_pool, v_pool, block_tables, lens, ints, R):
    """One launch of a paged entry: its ``ints`` (B, [S,] H, K, Dh, nb, bs,
    mb) and the split plan, with the workspace for ``R`` query rows a
    CTA."""
    fn = _entries.get(symbol)
    if fn is None:
        fn = _entries[symbol] = _build.entry(name, symbol, 8, len(ints) + 2)
    B, K, Dh, bs, mb = ints[0], ints[-5], ints[-4], ints[-2], ints[-1]
    W, n_split = split_plan(mb * bs, bs)
    ws, counters = split_buffers(q.device, B, K, n_split, R, Dh)
    out = torch.empty_like(q)
    err = _build.call(fn, q.device, q.data_ptr(), k_pool.data_ptr(),
                      v_pool.data_ptr(), block_tables.data_ptr(),
                      lens.data_ptr(), out.data_ptr(),
                      0 if ws is None else ws.data_ptr(), counters.data_ptr(),
                      *ints, W, n_split, 1.0 / Dh ** 0.5)
    if err:
        _build.check(name, err, symbol)
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, cache_len):
    """q: (B,H,Dh) one new token per row; pools: (nb,bs,K,Dh) shared block
    pool; block_tables: (B,mb) int32; cache_len: (B,) int32 valid count.
    Returns (B,H,Dh).  CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    _build.refuse_grad("paged_decode_attention", q, k_pool, v_pool)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    B, H, Dh = q.shape
    nb, bs, K, _ = k_pool.shape
    mb = block_tables.shape[1]
    _check_paged("paged_decode_attention", q, H, Dh, k_pool, v_pool,
                 block_tables, cache_len, B)
    out = _launch("paged_decode", "paged_decode_attention_bf16", q, k_pool,
                  v_pool, block_tables, cache_len, (B, H, K, Dh, nb, bs, mb),
                  R=H // K)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_verify_attention(q, k_pool, v_pool, block_tables, q_off):
    """q: (B,S,H,Dh) the S = k+1 verify queries of each row, query ``s`` at
    absolute position ``q_off[b] + s``; pools: (nb,bs,K,Dh); block_tables:
    (B,mb) int32; q_off: (B,) int32.  Returns (B,S,H,Dh).  CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    _build.refuse_grad("paged_verify_attention", q, k_pool, v_pool)
    if q.device.type == "cpu":
        return paged_verify_attention_plain(q, k_pool, v_pool, block_tables,
                                            q_off)
    if q.device.type != "cuda":
        raise ValueError(f"paged_verify_attention: no kernel for {q.device}")
    B, S, H, Dh = q.shape
    nb, bs, K, _ = k_pool.shape
    mb = block_tables.shape[1]
    _check_paged("paged_verify_attention", q, H, Dh, k_pool, v_pool,
                 block_tables, q_off, B)
    out = _launch("paged_verify", "paged_verify_attention_bf16", q, k_pool,
                  v_pool, block_tables, q_off, (B, S, H, K, Dh, nb, bs, mb),
                  R=S * (H // K))
    paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0
