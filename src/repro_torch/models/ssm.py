"""Mamba-2 SSD mixer (state-space duality): init, prefill, O(1) decode.

Port of ``repro.models.ssm``.  The recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t h_t + D x_t

is evaluated over a sequence in the chunked SSD form [arXiv:2405.21060]:
``ssd_chunked`` (``ssm_impl="chunked"``, f32 throughout) or the SSD-scan
kernel (``ssm_impl="pallas"``: ``kernels.ssd_scan.ops.ssd_scan``, whose
``y`` is rounded to x's dtype, bf16 on the serve path, before the D skip,
as the reference's kernel path rounds it).  Decode keeps per-row state
``{"conv": (B, W-1, conv_dim) bf16, "ssd": (B, H, N, P) f32}`` and writes
it IN PLACE, as the attention layers write their caches; the reference
returns new arrays and its engine donates the old ones.  Chunked admission
(``ssm_prefill_chunk_row``) runs a chunk's tokens one at a time through
``ssm_decode`` from one row's cached state, as the reference scans them.

Under a serve mesh every SSM leaf (``in_proj``, ``out_proj``, ``conv_w``,
``conv_b``) and the ``ssd``/``conv`` state are replicated by the serve
rules: one tensor on the lead device, so the mixer and the SSD-scan
kernel run once there.  The reference's ``constrain(xh, "b.m.")`` is a
placement hint to its partitioner; the port places tensors itself and
needs none.

Rounding points follow the reference: the depthwise causal conv is a chain
of bf16 multiplies and adds in a fixed order, the decode conv one bf16
contraction (f32 sums, one rounding), ``silu`` is ``x / (1 + exp(-x))``
with every step in the compute dtype, ``softplus`` and the state math in
f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    COMPUTE, dense_init, read_row, rmsnorm, write_row)


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.state_dim
    return s, d_inner, nheads, conv_dim


def init_ssm(gen, cfg, dtype=COMPUTE, device="cpu"):
    """Seeded ``in_proj``, ``conv_w`` and ``out_proj`` (``gen`` on
    ``device``); ``A_log``, ``D_skip``, ``dt_bias`` and ``norm_scale`` are
    the reference's deterministic values, kept f32 (the reference reads
    them in f32).  The conv weights are stored in ``dtype``: the reference
    casts them to the compute dtype at use."""
    s, d_inner, nheads, conv_dim = _dims(cfg)
    in_dim = 2 * d_inner + 2 * s.n_groups * s.state_dim + nheads
    f64 = dict(dtype=torch.float64, device=device)
    conv_w = torch.randn((s.conv_width, conv_dim), generator=gen,
                         dtype=torch.float32, device=device) * 0.1
    return {
        "in_proj": dense_init(gen, (cfg.d_model, in_dim), dtype=dtype,
                              device=device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, **f64)).float(),
        "D_skip": torch.ones((nheads,), dtype=torch.float32, device=device),
        "dt_bias": torch.log(torch.expm1(
            torch.linspace(1e-3, 0.1, nheads, **f64))).float(),
        "norm_scale": torch.zeros((d_inner,), dtype=torch.float32,
                                  device=device),
        "out_proj": dense_init(gen, (d_inner, cfg.d_model), dtype=dtype,
                               device=device),
    }


def _silu(x):
    """``jax.nn.silu`` as XLA evaluates it in bf16: ``x * 1 / (1 +
    exp(-x))`` with every step rounded to x's dtype (one f32 sigmoid
    rounded once differs from it by an ulp for many bf16 inputs)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w, b):
    """x: (B,S,C); w: (W,C) depthwise causal conv via shifted adds, each
    product and sum rounded to x's dtype in the reference's order."""
    W, S = w.shape[0], x.shape[1]
    out = x * w[-1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[W - 1 - i]
    return out + b


def _split_proj(zxbcdt, cfg):
    s, d_inner, nheads, conv_dim = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt = zxbcdt[..., d_inner + conv_dim:]
    return z, xBC, dt


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD scan, the reference's pure path (no kernel).

    x: (b,S,H,P)  dt: (b,S,H)  A: (H,)  B,C: (b,S,1,N).  Returns (y
    (b,S,H,P) f32, final state (b,H,N,P) f32).  All cumulative and decay
    math in f32; the inter-chunk state is carried by a loop over chunks."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if G != 1 or H % G:
        raise ValueError("ssd_chunked: the state einsums assume shared B/C "
                         "(n_groups=1), as the reference's do")
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // chunk

    def rs(t):
        return t.reshape((b, nc, chunk) + tuple(t.shape[2:]))
    xc, dtc, Bc, Cc = rs(x).float(), rs(dt.float()), rs(B).float(), rs(C).float()

    dA = dtc * A.float()                                  # (b,nc,Q,H)
    cum = torch.cumsum(dA, dim=2)
    total = cum[:, :, -1]                                 # (b,nc,H)

    # intra-chunk: y_t = C_t . sum_{j<=t} exp(cum_t - cum_j) dt_j B_j x_j,
    # masked INSIDE the exponent (the non-causal part can overflow)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,q,j,H)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    seg = seg.masked_fill(~causal[None, None, :, :, None], float("-inf"))
    L = torch.exp(seg)
    CB = torch.einsum("bcqgn,bcjgn->bcgqj", Cc, Bc)       # (b,nc,G,q,j)
    CB = CB.repeat_interleave(H // G, dim=2)              # (b,nc,H,q,j)
    M = CB * L.permute(0, 1, 4, 2, 3)
    xdt = xc * dtc[..., None]                             # (b,nc,j,H,P)
    y_intra = torch.einsum("bchqj,bcjhp->bcqhp", M, xdt)

    # chunk-local end states: S_loc = sum_j exp(total - cum_j) dt_j B_j x_j
    decay_out = torch.exp(total[:, :, None] - cum)        # (b,nc,j,H)
    S_loc = torch.einsum("bcjgn,bcjh,bcjhp->bchnp", Bc, decay_out * dtc, xc)

    # inter-chunk recurrence, then each chunk's carry-in
    state = torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(state)
        state = torch.exp(total[:, c])[:, :, None, None] * state + S_loc[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                 # (b,nc,H,N,P)
    y_inter = torch.einsum("bcqgn,bcqh,bchnp->bcqhp", Cc, torch.exp(cum),
                           s_prevs)

    y = (y_intra + y_inter).reshape(b, nc * chunk, H, P)
    return y[:, :S], state


def _ssm_forward_impl(x, p, cfg, compute, want_cache: bool):
    s, d_inner, nheads, conv_dim = _dims(cfg)
    zxbcdt = x @ p["in_proj"].to(compute)
    z, xBC_pre, dt = _split_proj(zxbcdt, cfg)
    xBC = _silu(_causal_conv(xBC_pre, p["conv_w"].to(compute),
                             p["conv_b"].to(compute)))
    b, S, _ = x.shape
    ng = s.n_groups * s.state_dim
    xh = xBC[..., :d_inner].reshape(b, S, nheads, s.head_dim)
    Bh = xBC[..., d_inner:d_inner + ng].reshape(b, S, s.n_groups, s.state_dim)
    Ch = xBC[..., d_inner + ng:].reshape(b, S, s.n_groups, s.state_dim)
    dt_sp = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if cfg.ssm_impl == "pallas":
        from repro_torch.kernels.ssd_scan.ops import ssd_scan
        y, s_final = ssd_scan(xh, dt_sp, A, Bh, Ch, chunk=s.chunk_size)
        y = y.float()
    else:
        y, s_final = ssd_chunked(xh, dt_sp, A, Bh, Ch, s.chunk_size)
    y = y + xh.float() * p["D_skip"][None, None, :, None]
    y = y.reshape(b, S, d_inner).to(compute)
    y = rmsnorm(y * _silu(z), p["norm_scale"], cfg.norm_eps)
    out = y @ p["out_proj"].to(compute)
    if not want_cache:
        return out, None
    W = s.conv_width
    tail = (xBC_pre[:, -(W - 1):] if S >= W - 1
            else F.pad(xBC_pre, (0, 0, W - 1 - S, 0)))
    return out, {"conv": tail.to(torch.bfloat16), "ssd": s_final}


def ssm_forward(x, p, cfg, compute=COMPUTE):
    """Full Mamba-2 block over a sequence.  x: (B,S,D) -> (B,S,D)."""
    return _ssm_forward_impl(x, p, cfg, compute, want_cache=False)[0]


def ssm_forward_with_cache(x, p, cfg, compute=COMPUTE):
    """Prefill: (out, decode cache {conv, ssd})."""
    return _ssm_forward_impl(x, p, cfg, compute, want_cache=True)


# --------------------------------------------------------------------------
# Decode (O(1) state)
# --------------------------------------------------------------------------

def init_ssm_cache(cfg, batch: int, dtype=COMPUTE, device="cpu"):
    s, d_inner, nheads, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssd": torch.zeros((batch, nheads, s.state_dim, s.head_dim),
                           dtype=torch.float32, device=device),
    }


def ssm_decode(x, p, cfg, cache, compute=COMPUTE):
    """One token.  x: (B,1,D); ``cache`` {conv, ssd} rows of this layer,
    updated IN PLACE.  Returns (out (B,1,D), cache)."""
    s, d_inner, nheads, conv_dim = _dims(cfg)
    zxbcdt = x @ p["in_proj"].to(compute)
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    # conv over (the cached W-1 inputs + the current one): one contraction
    # with f32 sums, rounded once
    hist = torch.cat([cache["conv"].to(compute), xBC[:, 0][:, None]], dim=1)
    w = p["conv_w"].to(compute)
    conv = (hist.float() * w.float()).sum(dim=1).to(compute)
    xBC_t = _silu(conv + p["conv_b"].to(compute))

    b = x.shape[0]
    ng = s.n_groups * s.state_dim
    rep = nheads // s.n_groups
    xh = xBC_t[..., :d_inner].reshape(b, nheads, s.head_dim).float()
    Bh = (xBC_t[..., d_inner:d_inner + ng].reshape(b, s.n_groups, s.state_dim)
          .float().repeat_interleave(rep, dim=1))            # (B,H,N)
    Ch = (xBC_t[..., d_inner + ng:].reshape(b, s.n_groups, s.state_dim)
          .float().repeat_interleave(rep, dim=1))
    dt_sp = _softplus(dt[:, 0].float() + p["dt_bias"])      # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt_sp * A)
    upd = dt_sp[:, :, None, None] * Bh[..., None] * xh[:, :, None, :]
    state = decay[:, :, None, None] * cache["ssd"] + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)
    y = y + xh * p["D_skip"][None, :, None]
    y = y.reshape(b, 1, d_inner).to(compute)
    y = rmsnorm(y * _silu(z), p["norm_scale"], cfg.norm_eps)
    out = y @ p["out_proj"].to(compute)
    cache["conv"].copy_(hist[:, 1:])
    cache["ssd"].copy_(state)
    return out, cache


def ssm_prefill_chunk_row(x, p, cfg, cache, slot, compute=COMPUTE):
    """Chunked-prefill step for ONE batch row of an SSM layer: the chunk's
    tokens through `ssm_decode` one at a time, starting from row ``slot``'s
    cached state (zeroed by the engine before a request's first chunk),
    which they advance IN PLACE.  x: (1,C,D); cache: the layer's full-batch
    {conv, ssd}; ``slot`` an int or a 0-d device tensor (a captured
    chunk's).  Returns (out (1,C,D), cache)."""
    # copies of the row, written back after
    row = {k: read_row(v, slot) for k, v in cache.items()}
    outs = [ssm_decode(x[:, t:t + 1], p, cfg, row, compute=compute)[0]
            for t in range(x.shape[1])]
    for k, v in cache.items():
        write_row(v, slot, row[k])
    return torch.cat(outs, dim=1), cache
