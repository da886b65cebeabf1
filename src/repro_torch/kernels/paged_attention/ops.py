"""Paged single-token decode attention: CUDA kernel wrapper + plain version.

Replaces the TPU kernel ``paged_decode_attention_kernel``
(``src/repro/kernels/paged_attention/kernel.py``; wrapper
``repro.kernels.paged_attention.ops.paged_decode_attention``).  The kernel
is ``csrc/paged_decode.cu``: one block per (row, kv-head) walks the row's
block table up to ``ceil(cache_len / bs)`` entries, reading each live K/V
row once.  It is bound by memory on the H100 (see the source's header).

`paged_decode_attention` launches the kernel for CUDA tensors and runs
`paged_decode_attention_plain` for CPU tensors; there is no other path.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30


def gather_kv(pool, block_tables):
    """pool: (nb, bs, ...); block_tables: (B, mb) int.  Returns the per-row
    logical view (B, mb*bs, ...) — ``repro.kernels.paged_attention.ref``'s
    `gather_kv`."""
    B, mb = block_tables.shape
    g = pool[block_tables.long()]                 # (B, mb, bs, ...)
    return g.reshape((B, mb * pool.shape[1]) + tuple(pool.shape[2:]))


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, cache_len):
    """The kernel's function in plain PyTorch, with its cast points: q, k,
    p and v in bf16, f32 sums and softmax, masked scores at -1e30, invalid
    V rows zeroed before P.V, normaliser clamped at 1e-30.

    q: (B,H,Dh); pools: (nb,bs,K,Dh); block_tables: (B,mb); cache_len:
    scalar or (B,).  Returns (B,H,Dh) in q's dtype."""
    B, H, Dh = q.shape
    K = k_pool.shape[2]
    G = H // K
    kg = gather_kv(k_pool, block_tables)          # (B, T, K, Dh)
    vg = gather_kv(v_pool, block_tables)
    T = kg.shape[1]
    lens = torch.as_tensor(cache_len, dtype=torch.int32,
                           device=q.device).expand(B)
    valid = torch.arange(T, device=q.device)[None, :] < lens[:, None]
    qg = q.to(torch.bfloat16).float().reshape(B, K, G, Dh)
    s = torch.einsum("bkgd,btkd->bkgt", qg,
                     kg.to(torch.bfloat16).float()) * (1.0 / Dh ** 0.5)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)
    v = torch.where(valid[:, :, None, None], vg.to(torch.bfloat16).float(), 0.0)
    o = torch.einsum("bkgt,btkd->bkgd", p.to(torch.bfloat16).float(), v)
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(B, H, Dh).to(q.dtype)


def _lib():
    lib = _build.library("paged_decode")
    fn = lib.paged_decode_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def paged_decode_attention(q, k_pool, v_pool, block_tables, cache_len):
    """q: (B,H,Dh) one new token per row; pools: (nb,bs,K,Dh) shared block
    pool; block_tables: (B,mb) int32; cache_len: (B,) int32 valid count.
    Returns (B,H,Dh).  CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    B, H, Dh = q.shape
    nb, bs, K, _ = k_pool.shape
    mb = block_tables.shape[1]
    if H % K or Dh > 256 or k_pool.shape[3] != Dh:
        raise ValueError(f"paged_decode_attention: unsupported heads/dims "
                         f"q {tuple(q.shape)} pool {tuple(k_pool.shape)}")
    for name, t, dt in (("q", q, torch.bfloat16), ("k_pool", k_pool, torch.bfloat16),
                        ("v_pool", v_pool, torch.bfloat16),
                        ("block_tables", block_tables, torch.int32),
                        ("cache_len", cache_len, torch.int32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} must be a "
                             f"contiguous {dt} tensor on {q.device}")
    if v_pool.shape != k_pool.shape or block_tables.shape[0] != B \
            or tuple(cache_len.shape) != (B,):
        raise ValueError("paged_decode_attention: shape mismatch")
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.paged_decode_attention_bf16(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
            B, H, K, Dh, nb, bs, mb, 1.0 / Dh ** 0.5,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
