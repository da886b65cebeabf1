"""Flash prefill attention: CUDA kernel wrapper + plain version.

Replaces the TPU kernel ``flash_attention_kernel``
(``src/repro/kernels/flash_attention/kernel.py``; wrapper
``repro.kernels.flash_attention.ops.flash_attention``).  The kernel is
``csrc/flash_prefill.cu``, on Hopper's tensor cores: one CTA per (batch,
query head, 64-row query tile), K/V tiles of 64 keys brought in by TMA
through a two-stage ring, Q.K^T and P.V as ``wgmma`` with the f32 online
softmax in registers, and the key loop stopped at the causal bound of the
tile's last row.  It takes the model layout (q (B,S,H,Dh), k/v (B,T,K,Dh))
as it is: ragged S and T are masked in the kernel.  Head widths 64, 128 and
256 are the kernel's instances; any other width up to 256 is zero-padded
to the next one (`head_width`), which adds exact zeros to Q.K, and the
output is sliced back (the scale stays that of the real width).

`flash_attention` launches the kernel for CUDA tensors and runs
`flash_attention_plain` for CPU tensors; there is no other path.
"""

from __future__ import annotations


import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

NEG_INF = -1e30
INSTANCES = (64, 128, 256)      # head widths csrc/flash_prefill.cu is built for


def _mask(S, T, causal, window, q_offset, device):
    q_pos = q_offset + torch.arange(S, device=device)
    t_pos = torch.arange(T, device=device)
    m = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        m &= t_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= t_pos[None, :] > (q_pos[:, None] - window)
    return m


def head_width(Dh: int) -> int:
    """The kernel instance a head width runs on: the smallest of
    ``INSTANCES`` at least ``Dh``.  Raises for widths above 256."""
    for w in INSTANCES:
        if 0 < Dh <= w:
            return w
    raise ValueError(f"flash_attention: head width {Dh} is not in 1..256")


def flash_attention_plain(q, k, v, *, causal=True, window=None, q_offset=0):
    """The kernel's function in plain PyTorch, with its cast points: q, k,
    p and v in bf16, f32 sums and softmax, masked scores at -1e30 (a fully
    masked row is uniform, not NaN), normaliser clamped at 1e-30.

    q: (B,S,H,Dh); k,v: (B,T,K,Dh).  Returns (B,S,H,Dh) in q's dtype."""
    return _attention_plain(q, k, v, 1.0 / q.shape[-1] ** 0.5, causal, window,
                            q_offset)


def _attention_plain(q, k, v, scale, causal, window, q_offset):
    """`flash_attention_plain` with the softmax scale given: the function
    the kernel computes on head-padded inputs."""
    B, S, H, Dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.to(torch.bfloat16).float().reshape(B, S, K, G, Dh)
    s = torch.einsum("bskgd,btkd->bkgst", qg,
                     k.to(torch.bfloat16).float()) * scale
    valid = _mask(S, T, causal, window, q_offset, q.device)
    s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)                                   # (B,K,G,S)
    o = torch.einsum("bkgst,btkd->bkgsd", p.to(torch.bfloat16).float(),
                     v.to(torch.bfloat16).float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """q: (B,S,H,Dh); k,v: (B,T,K,Dh) -> (B,S,H,Dh).  Query ``i`` sits at
    absolute position ``q_offset + i``; ``window`` (None or > 0) keeps keys
    ``t > pos - window``.  CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    _build.refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    B, S, H, Dh = q.shape
    T, K = k.shape[1], k.shape[2]
    if H % K or k.shape[0] != B or k.shape[3] != Dh or v.shape != k.shape:
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    width = head_width(Dh)
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be > 0, got {window}")
    _build.check_operands("flash_attention", q.device, (
        ("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
        ("v", v, torch.bfloat16)))
    if width != Dh:
        q, k, v = (F.pad(t, (0, width - Dh)) for t in (q, k, v))
    out = torch.empty_like(q)
    fn = _build.entry("flash_prefill", "flash_prefill_bf16", 4, 10)
    err = _build.call(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), B, S, T, H, K, width, int(causal),
                      int(window or 0), int(q_offset), T, 1.0 / Dh ** 0.5)
    _build.check("flash_prefill", err, "flash_attention")
    flash_attention.launches += 1
    return out if width == Dh else out[..., :Dh].contiguous()


flash_attention.launches = 0
