"""Dense single-token flash-decode attention: CUDA kernel wrapper + plain
version.

Replaces the TPU kernel ``decode_attention_kernel``
(``src/repro/kernels/decode_attention/kernel.py``; wrapper
``repro.kernels.decode_attention.ops.decode_attention``).  The kernel is
``csrc/decode_attention.cu``: the paged decode kernel's block body over a
dense (B, T, K, Dh) cache read in place (the reference wrapper transposes
it to (B, K, T, Dh) first).  It is bound by memory on the H100.

`decode_attention` launches the kernel for CUDA tensors and runs
`decode_attention_plain` for CPU tensors; there is no other path.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30


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
    out = torch.empty_like(q)
    fn = _build.entry("decode_attention", "decode_attention_bf16", 5, 5)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 cache_len.data_ptr(), out.data_ptr(), B, T, H, K, Dh,
                 1.0 / Dh ** 0.5, torch.cuda.current_stream().cuda_stream)
    _build.check("decode_attention", err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
