"""Dense single-token flash-decode attention: CUDA kernel wrapper + plain
version, and the split plan shared with the paged kernels.

Replaces the TPU kernel ``decode_attention_kernel``
(``src/repro/kernels/decode_attention/kernel.py``; wrapper
``repro.kernels.decode_attention.ops.decode_attention``).  The kernel is
``csrc/decode_attention.cu``: the paged decode kernel's body
(``csrc/gqa_decode.cuh``) over a dense (B, T, K, Dh) cache read in place
(the reference wrapper transposes it to (B, K, T, Dh) first).  It is bound
by memory on the H100.  The body splits each row's sequence over CTAs,
``W`` positions each (`split_plan`), and merges the splits in the same
launch through a workspace and per-(row, kv head) counters that the
wrappers hand it (`split_buffers`).

`decode_attention` launches the kernel for CUDA tensors and runs
`decode_attention_plain` for CPU tensors; there is no other path.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
CHUNK = 64          # positions a CTA stages per step (gqa_decode.cuh kChunk)
SPLIT = 64          # the split width W up to MAX_SPLITS splits
MAX_SPLITS = 32     # the body merges at most CHUNK / 2 splits
_entry = None
_counters: dict = {}


@functools.lru_cache(maxsize=None)
def split_plan(cap: int, bs: int = 1) -> tuple[int, int]:
    """(W, n_split) of the GQA decode body for a sequence capacity ``cap``
    (``mb * bs`` for a paged table of block size ``bs``, ``T`` for a dense
    ring): W positions per split, a multiple of the body's chunk and of
    ``bs``, and n_split * W >= cap.  W is SPLIT up to MAX_SPLITS splits and
    grows with the capacity past that.  The dense and paged entries take it
    from here, so a dense row, a paged row and a verify query split and sum
    alike and stay bitwise equal.  It depends on the capacity alone: the
    host never reads a length."""
    if cap <= 0 or bs <= 0:
        raise ValueError(f"split_plan: capacity {cap}, block size {bs}")
    W = SPLIT * max(1, -(-cap // (SPLIT * MAX_SPLITS)))
    unit = CHUNK * bs // math.gcd(CHUNK, bs)
    W = -(-W // unit) * unit
    return W, -(-cap // W)


def split_buffers(device, B: int, K: int, n_split: int, R: int, Dh: int):
    """The workspace of one launch of the decode body, (B, K, n_split, R,
    Dh + 2) f32 (none when n_split is 1), and the (B * K,) int32 counters,
    0 between launches (each launch's merging CTA resets its own).  The
    counters of a device are kept and grown, never freed, so that a CUDA
    graph that captured them stays valid; launches on one device must be
    ordered on one stream."""
    ws = (torch.empty(B * K * n_split * R * (Dh + 2), dtype=torch.float32,
                      device=device) if n_split > 1 else None)
    have = _counters.get(device)
    if have is None or have[-1].numel() < B * K:
        have = (have or []) + [torch.zeros(max(B * K, 1024), dtype=torch.int32,
                                           device=device)]
        _counters[device] = have
    return ws, have[-1]


def decode_attention_plain(q, k_cache, v_cache, cache_len):
    """The kernel's function in plain PyTorch, with its cast points: q, k,
    p and v in bf16, f32 sums and softmax, masked scores at -1e30, invalid
    V rows zeroed before P.V, normaliser clamped at 1e-30.

    q: (B,H,Dh); caches: (B,T,K,Dh); cache_len: scalar or (B,) valid count.
    Returns (B,H,Dh) in q's dtype."""
    B, H, Dh = q.shape
    T, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    lens = torch.as_tensor(cache_len, dtype=torch.int32,
                           device=q.device).expand(B)
    valid = torch.arange(T, device=q.device)[None, :] < lens[:, None]
    qg = q.to(torch.bfloat16).float().reshape(B, K, G, Dh)
    s = torch.einsum("bkgd,btkd->bkgt", qg,
                     k_cache.to(torch.bfloat16).float()) * (1.0 / Dh ** 0.5)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)
    v = torch.where(valid[:, :, None, None],
                    v_cache.to(torch.bfloat16).float(), 0.0)
    o = torch.einsum("bkgt,btkd->bkgd", p.to(torch.bfloat16).float(), v)
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(B, H, Dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len):
    """q: (B,H,Dh) one new token per row; caches: (B,T,K,Dh); cache_len:
    (B,) int32 valid count.  Returns (B,H,Dh).  CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    B, H, Dh = q.shape
    _, T, K, _ = k_cache.shape
    if H % K or Dh > 256 or k_cache.shape[3] != Dh:
        raise ValueError(f"decode_attention: unsupported heads/dims q "
                         f"{tuple(q.shape)} cache {tuple(k_cache.shape)}")
    _build.check_operands("decode_attention", q.device, (
        ("q", q, torch.bfloat16), ("k_cache", k_cache, torch.bfloat16),
        ("v_cache", v_cache, torch.bfloat16),
        ("cache_len", cache_len, torch.int32)))
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != B \
            or tuple(cache_len.shape) != (B,):
        raise ValueError("decode_attention: shape mismatch")
    global _entry
    if _entry is None:
        _entry = _build.entry("decode_attention", "decode_attention_bf16", 7,
                              7)
    W, n_split = split_plan(T)
    ws, counters = split_buffers(q.device, B, K, n_split, H // K, Dh)
    out = torch.empty_like(q)
    err = _build.call(_entry, q.device, q.data_ptr(), k_cache.data_ptr(),
                      v_cache.data_ptr(), cache_len.data_ptr(),
                      out.data_ptr(), 0 if ws is None else ws.data_ptr(),
                      counters.data_ptr(), B, T, H, K, Dh, W, n_split,
                      1.0 / Dh ** 0.5)
    if err:
        _build.check("decode_attention", err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
