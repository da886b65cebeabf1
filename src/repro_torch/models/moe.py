"""Mixture-of-experts FFN: top-k router + capacity-bucketed dispatch.

Port of ``repro.models.moe``.  Two execution paths, as in the reference:

* ``apply_moe`` (prefill): per-example capacity dispatch.  Token
  assignments are numbered by a cumsum over the flattened (S*k) order,
  bucketed into an (E, C) buffer, run through the experts (one batched
  einsum, or the grouped-matmul kernel with ``moe_impl="gmm"``) and
  combined with the router weights.  Assignments past an expert's capacity
  C are dropped (GShard semantics, capacity_factor 1.25).  The reference's
  ``vmap`` over examples is a batch dimension written out.
* ``apply_moe_dense`` (decode, verify): every expert on every token,
  weighted by the router gates (zero outside the top k); no capacity, no
  drops.

Divergence traps against the reference, each mirrored here: the router
weight is stored in f32 and the router product runs in full f32 (never
TF32 on the card), so top-k picks the same experts; top-k orders equal
probabilities by the lower index first, as ``jax.lax.top_k`` does (a stable
descending sort), which decides exact ties such as identical left-padding
rows or a zeroed router; the ``gmm`` path keeps the up/gate products in
f32 and casts ``act(g) * up`` to bf16 once, while the einsum path rounds
each product to bf16.  Left padding is routed like any token: in the
engine's left-padded prompts the pad rows come first in the cumsum and
take their experts' capacity before any real token does, as in the
reference.  The sharding constraints of the reference are identity
without a mesh and are dropped.

Under a serve mesh (`repro_torch.runtime.sharding.ShardedParams`) the
router and the dispatch run once, in f32, on the lead device; ``up`` and
``gate`` are column leaves split on F over the model ranks, so each rank
runs its ``(E, D, F/m)`` part through the same product (the grouped-matmul
kernel in ``gmm`` mode) and ``act(g) * up`` on its columns; the result is
gathered along F onto the lead device (the reference's
``constrain_replicated(h)``), where ``down`` (row-parallel, replicated)
and the combine run whole, in the one-device order.  In decode, with a
data axis above 1, each data row computes its slice of the experts from
its own copy of the weights (the reference's ``constrain(h, "..dm")``):
the slices are gathered onto the lead device before ``down``.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels.grouped_matmul.ops import bucket_matmul
from repro_torch.launch import op_stats
from repro_torch.models.layers import COMPUTE, act_fn, dense_init
from repro_torch.runtime.sharding import gather, on_ranks, parts


def init_moe(gen, cfg, dtype=COMPUTE, device="cpu"):
    """Router (D,E) in f32 (its logits decide the routing); expert weights
    up/gate (E,D,F) and down (E,F,D) in ``dtype``."""
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.num_experts, m.d_ff_expert
    p = {
        "router": dense_init(gen, (D, E), dtype=torch.float32, device=device),
        "up": dense_init(gen, (E, D, Fe), in_axis=1, dtype=dtype,
                         device=device),
        "down": dense_init(gen, (E, Fe, D), in_axis=1, dtype=dtype,
                           device=device),
    }
    if cfg.mlp_gated:
        p["gate"] = dense_init(gen, (E, D, Fe), in_axis=1, dtype=dtype,
                               device=device)
    return p


def _capacity(cfg, seq_len: int) -> int:
    m = cfg.moe
    c = int(seq_len * m.top_k * m.capacity_factor / m.num_experts) + 1
    return min(seq_len, max(8, -(-c // 8) * 8))   # round up to 8, cap at S


@contextlib.contextmanager
def _full_f32(device):
    """f32 matmuls in full f32 on the card whatever the caller set: TF32
    keeps ~3 decimal digits, enough to reorder close router logits."""
    if device.type != "cuda":
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def router_probs(x, router_w):
    """f32 router logits -> probs.  x: (..., D)."""
    with _full_f32(x.device):
        logits = x.float() @ router_w.float()
    return torch.softmax(logits, dim=-1)


def top_k(probs, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, descending,
    the lower index first among equal values (a stable sort), with the
    weights renormalised to sum to 1.  Returns (wts f32, idx int64)."""
    wts, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    wts, idx = wts[..., :k], idx[..., :k]
    wts = wts / torch.clamp(wts.sum(dim=-1, keepdim=True), min=1e-9)
    return wts, idx


def _dispatch(x, idx, E: int, C: int):
    """x: (B,S,D); idx: (B,S,k).  Returns buckets (B,E,C,D) and
    (e_flat, pos_c, keep), each (B, S*k), for the combine step.  An
    assignment's position is the number of earlier assignments (flattened
    (S*k) order) to its expert; those at C or beyond are dropped: they add
    0 at C-1."""
    B, S, k = idx.shape
    e_flat = idx.reshape(B, S * k)
    one_hot = F.one_hot(e_flat, E).to(torch.int32)           # (B, S*k, E)
    pos = (torch.cumsum(one_hot, dim=1) - one_hot).gather(
        2, e_flat[..., None])[..., 0]
    keep = pos < C
    pos_c = torch.where(keep, pos, C - 1)
    tok = torch.arange(S, device=x.device).repeat_interleave(k)
    contrib = x[:, tok] * keep[..., None].to(x.dtype)
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, S * k)
    buckets = torch.zeros((B, E, C, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    buckets.index_put_((bidx, e_flat, pos_c), contrib, accumulate=True)
    return buckets, (e_flat, pos_c, keep)


def _combine(y, meta, wts, dtype):
    """y: (B,E,C,D) expert outputs; wts: (B,S,k).  Each token's k outputs
    times its (kept) weights, weights and products in y's dtype, summed in
    f32 (as ``jnp.sum`` upcasts bf16) and cast to ``dtype``."""
    e_flat, pos_c, keep = meta
    B, S, k = wts.shape
    bidx = torch.arange(B, device=y.device)[:, None].expand_as(e_flat)
    gathered = y[bidx, e_flat, pos_c]                          # (B, S*k, D)
    gathered = gathered * (wts.reshape(B, S * k) * keep).to(
        gathered.dtype)[..., None]
    return gathered.reshape(B, S, k, -1).sum(dim=2, dtype=torch.float32).to(
        dtype)


def _bucket_gmm(buckets, w):
    """(B,E,C,D) x (E,D,F) -> (B,E,C,F) f32 through the grouped-matmul
    kernel: B*E groups of C rows, group g on expert g % E, one launch."""
    B, E, C, D = buckets.shape
    y = bucket_matmul(buckets.reshape(B * E, C, D), w)
    return y.reshape(B, E, C, w.shape[2])


def apply_moe(x, p, cfg, compute=COMPUTE):
    """x: (B,S,D) -> (out (B,S,D), aux_loss scalar f32)."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.num_experts, m.top_k
    C = _capacity(cfg, S)
    probs = router_probs(x, p["router"])                       # (B,S,E) f32
    wts, idx = top_k(probs, k)                                 # (B,S,k)

    # Switch-style load-balance aux loss
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = F.one_hot(idx, E).float().sum(dim=2).mean(dim=(0, 1))
    aux = m.router_aux_weight * E * torch.sum(me * ce / k)

    buckets, meta = _dispatch(x, idx, E, C)                    # (B,E,C,D)
    act = act_fn(cfg.activation)
    gmm = cfg.moe_impl == "gmm"

    def hidden(b, up, gate):
        """One rank's columns of ``act(g) * up``: its part of ``up`` and
        ``gate`` (E, D, F/m), every bucket."""
        if gmm:
            u = _bucket_gmm(b, up.to(compute))
            if gate is None:
                return act(u).to(compute)
            return (act(_bucket_gmm(b, gate.to(compute))) * u).to(compute)
        u = torch.einsum("becd,edf->becf", b, up.to(compute))
        if gate is None:
            return act(u)
        return act(torch.einsum("becd,edf->becf", b,
                                gate.to(compute))) * u

    h = gather(on_ranks(hidden, buckets, p["up"], p.get("gate"), dim=-1))
    if gmm:
        y = _bucket_gmm(h, p["down"].to(compute)).to(compute)
    else:
        y = torch.einsum("becf,efd->becd", h, p["down"].to(compute))
    return _combine(y, meta, wts, compute), aux


def _dense_hidden(xt, up, gate, act, compute):
    """``act(xt @ gate) * (xt @ up)`` over every expert of ``up``/``gate``
    (E, D, F): (E, M, F)."""
    u = torch.matmul(xt, up.to(compute))
    if gate is None:
        return act(u)
    return act(torch.matmul(xt, gate.to(compute))) * u


def _expert_rows(xt, rows, act, compute):
    """The decode hidden of every expert, each data row computing its
    slice of the experts from its own copy of ``up``/``gate`` (``rows``,
    row 0 first), over its model ranks; gathered onto ``xt``'s device in
    expert order."""
    out = []
    E = rows[0]["up"].shape[0]
    n = E // len(rows)
    for r, p in enumerate(rows):
        sl = slice(r * n, (r + 1) * n)
        gate = p.get("gate")
        x = xt.to(parts(p["up"])[0].device)
        h = gather(on_ranks(
            functools.partial(_dense_hidden, act=act, compute=compute), x,
            p["up"][sl], None if gate is None else gate[sl], dim=-1))
        out.append(h.to(xt.device))
    h = torch.cat(out, dim=0)
    op_stats.transfer("all-gather", h)
    return h


def apply_moe_dense(x, p, cfg, compute=COMPUTE):
    """Decode path: all experts on the (B,S,D) tokens, gated combine.
    Returns (out (B,S,D), aux 0.0)."""
    m = cfg.moe
    B, S, D = x.shape
    probs = router_probs(x, p["router"])                       # (B,S,E)
    wts, idx = top_k(probs, m.top_k)
    gates = torch.zeros_like(probs).scatter_(-1, idx, wts)     # (B,S,E)

    act = act_fn(cfg.activation)
    xt = x.reshape(1, B * S, D)                                # every expert
    rows = getattr(p, "rows", ())
    if len(rows) > 1:
        h = _expert_rows(xt, rows, act, compute)               # (E,BS,F)
    else:
        h = gather(on_ranks(
            functools.partial(_dense_hidden, act=act, compute=compute), xt,
            p["up"], p.get("gate"), dim=-1))
    y = torch.matmul(h, p["down"].to(compute))                 # (E,BS,D)
    out = torch.bmm(gates.reshape(B * S, 1, -1).to(compute),
                    y.transpose(0, 1))                         # (BS,1,D)
    return out.reshape(B, S, D), 0.0
