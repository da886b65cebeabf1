"""Shared building blocks: init, norms, RoPE, MLP, embedding, head and loss.

Port of ``repro.models.layers``.  Parameters are stored in the dtype they
are used in (matrices bf16, norm scales f32); reductions that need
precision (norm variance, softmax) run in f32.  Divergence traps against
the JAX reference, each mirrored here: gelu is the tanh approximation,
RMSNorm stores ``scale - 1`` and applies ``1 + scale`` in f32 (LayerNorm
stores and applies ``scale`` and ``bias`` as they are, in f32), and RoPE
splits each head in half (no interleave).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.runtime.sharding import Shards, gather, on_ranks

COMPUTE = torch.bfloat16


# --------------------------------------------------------------------------
# One batch row of a cache leaf
# --------------------------------------------------------------------------

def _row_index(slot, device):
    """``slot`` as a (1,) long index on ``device``: an int is filled there
    (a host-to-device copy could not be captured), a 0-d integer tensor
    (a captured chunk's, the reference's traced scalar) reshaped."""
    if isinstance(slot, torch.Tensor):
        return slot.reshape(1).to(device, torch.long)
    return torch.full((1,), slot, dtype=torch.long, device=device)


def read_row(t, slot):
    """A copy of row ``slot`` of ``t`` (B, ...) as a (1, ...) tensor
    (``index_select``: a tensor index cannot give a view); what is written
    into it goes back through `write_row`."""
    return t.index_select(0, _row_index(slot, t.device))


def write_row(t, slot, row):
    """Write ``row`` (1, ...) into row ``slot`` of ``t`` in place
    (``index_copy_``)."""
    t.index_copy_(0, _row_index(slot, t.device), row)
    return t


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def dense_init(gen, shape, in_axis: int = 0, dtype=torch.float32, device="cpu"):
    """Truncated normal on [-2, 2] times 1/sqrt(fan_in) (the reference's
    maxtext/llama default).  ``gen`` is a torch.Generator on ``device``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (1.0 / math.sqrt(shape[in_axis]))).to(dtype)


def embed_init(gen, shape, dtype=torch.float32, device="cpu"):
    """N(0, 0.02)."""
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (t * 0.02).to(dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def layernorm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


def init_norm(cfg, d: int | None = None, device="cpu"):
    """LayerNorm: ``scale`` ones and ``bias`` zeros (applied as they are);
    RMSNorm: ``scale`` zeros (it stores ``scale - 1``).  All f32."""
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
                "bias": torch.zeros((d,), dtype=torch.float32, device=device)}
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def apply_norm(x, p, cfg):
    """LayerNorm is taken before ``norm_impl`` is read, as in the
    reference: the RMSNorm kernel never runs for a LayerNorm arch."""
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    if cfg.norm_impl == "pallas":
        from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused
        return rmsnorm_fused(x.contiguous(), p["scale"], eps=cfg.norm_eps)[0]
    return rmsnorm(x, p["scale"], cfg.norm_eps)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_table(positions, dim: int, theta: float):
    """cos/sin tables for integer ``positions`` (any shape) and head
    sub-dim ``dim``: each (..., dim/2) f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / torch.pow(float(theta), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, heads, dim); cos/sin: (S, dim/2) or (B, S, dim/2).  The
    head splits in halves (no interleave); math in f32, result in x's dtype."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    elif cos.dim() == 3:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def init_mlp(gen, cfg, dtype=COMPUTE, device="cpu"):
    D, Fd = cfg.d_model, cfg.d_ff
    p = {"up": dense_init(gen, (D, Fd), dtype=dtype, device=device),
         "down": dense_init(gen, (Fd, D), dtype=dtype, device=device)}
    if cfg.mlp_gated:
        p["gate"] = dense_init(gen, (D, Fd), dtype=dtype, device=device)
    return p


def column(x, w, compute=COMPUTE):
    """``x @ w`` for a column-parallel leaf (D, N): under a mesh each
    rank multiplies by its columns (`runtime.sharding.on_ranks`), and the
    output stays split over the ranks."""
    return on_ranks(lambda x, w: x @ w.to(compute), x, w, dim=-1)


def apply_mlp(x, p, cfg, compute=COMPUTE):
    """The MLP; under a mesh ``up`` and ``gate`` split d_ff over the ranks
    and their outputs are gathered before ``down`` (replicated), which
    contracts over d_ff whole."""
    act = act_fn(cfg.activation)
    up = gather(column(x, p["up"], compute))
    if cfg.mlp_gated:
        h = act(gather(column(x, p["gate"], compute))) * up
    else:
        h = act(up)
    return h @ p["down"].to(compute)


# --------------------------------------------------------------------------
# Embedding / head / loss
# --------------------------------------------------------------------------

def embed_lookup(tokens, table, compute=COMPUTE):
    """``table[tokens]``; a table split over the ranks on its vocab rows
    (a `Shards`) is looked up exactly: each token's row comes from the
    rank that holds it, onto the lead device."""
    if isinstance(table, Shards):
        out, lo = None, 0
        lead = table.device
        for part in table.parts:
            n = part.shape[0]
            t = tokens.long().to(part.device)
            rows = part[torch.clamp(t - lo, 0, n - 1)].to(lead)
            mine = ((t >= lo) & (t < lo + n)).to(lead)[..., None]
            out = rows if out is None else torch.where(mine, rows, out)
            lo += n
        return out.to(compute)
    return gather(table)[tokens.long()].to(compute)


def lm_logits(x, head, softcap: float | None = None):
    """x: (B,S,D) compute dtype; head: (D,V).  Returns f32 logits (the
    product is rounded to x's dtype first, as the reference's einsum is).
    A head split on the vocab over the ranks gives each rank its logits'
    columns, gathered before the softcap."""
    logits = gather(column(x, head, x.dtype)).float()
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def softmax_cross_entropy(logits, targets, mask=None):
    """logits (B,S,V) f32, targets (B,S) int -> scalar mean loss (over the
    positions where ``mask`` is 1, when given)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def softmax_cross_entropy_fused(h, head, targets, *, softcap=None, mask=None,
                                chunk: int = 1024):
    """Mean CE of ``logits = h @ head`` without materializing (B,S,V).

    The reference scans the sequence in ``chunk``-token slices under
    ``jax.checkpoint``; here each slice's (B,c,V) logits are made inside
    ``torch.utils.checkpoint`` and recomputed in backward, so peak memory
    holds one chunk's logits instead of the whole sequence's.  The
    sequence is zero-padded to whole chunks with mask 0, as in the
    reference.  ``S <= chunk`` takes the plain path.  The body draws no
    random numbers, so the recompute keeps no generator state
    (``preserve_rng_state=False``, as `transformer._remat`).

    h: (B,S,D) compute dtype; head: (D,V); targets: (B,S) int."""
    B, S, D = h.shape
    if S <= chunk:
        return softmax_cross_entropy(lm_logits(h, head, softcap), targets,
                                     mask)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    pad = (-S) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))

    def body(hb, tb, mb):
        logits = lm_logits(hb, head, softcap)            # (B,c,V) temporary
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tb.long()[..., None])[..., 0]
        return torch.sum((logz - gold) * mb)

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, S + pad, chunk):
        sl = slice(lo, lo + chunk)
        tot = tot + checkpoint(body, h[:, sl], targets[:, sl], mask[:, sl],
                               use_reentrant=False, preserve_rng_state=False)
    return tot / torch.clamp(torch.sum(mask), min=1.0)
