"""Granite MoE decoder (``family: moe``), plain PyTorch.

Per layer, pre-norm: ``x += attn(rmsnorm(x))``, ``x += moe(rmsnorm(x))``;
then a final RMSNorm and the tied head ``h @ embed.T``.  Attention is
causal grouped-query attention (query head h reads key/value head
h // (H / K)) with rotary embeddings at positions 0..T-1 and scores scaled
by 1/sqrt(head_dim).  The MoE router is an f32 softmax over the experts,
the top k taken (the lower index first among equal probabilities) and
their weights renormalised to 1; an expert is
``(silu(h @ gate) * (h @ up)) @ down``.

A served request's sequence is its prompt left-padded with token 0 to the
admission bucket (``plen`` tokens), then its served tokens.  The prompt
part is routed as one admission: assignments are numbered in (position,
k) order, and those past an expert's capacity
``min(plen, max(8, roundup8(int(plen * k * capacity_factor / E) + 1)))``
add nothing.  The served part is routed without a capacity.
"""

from __future__ import annotations

import torch

from perfbench.reference.common import Precision, rmsnorm, rope, silu


def capacity(c: dict, plen: int) -> int:
    k, E = c["num_experts_per_tok"], c["num_local_experts"]
    n = int(plen * k * c["capacity_factor"] / E) + 1
    return min(plen, max(8, -(-n // 8) * 8))


def _attention(h, p, l, c, prec):
    T, D = h.shape
    H, K, Dh = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    G = H // K
    q = prec.act(prec.mm(h, p["wq"][l].reshape(D, H * Dh))).view(T, H, Dh)
    k = prec.act(prec.mm(h, p["wk"][l].reshape(D, K * Dh))).view(T, K, Dh)
    v = prec.act(prec.mm(h, p["wv"][l].reshape(D, K * Dh))).view(T, K, Dh)
    q, k = prec.act(rope(q, c["rope_theta"])), prec.act(rope(k, c["rope_theta"]))
    q = q.view(T, K, G, Dh)
    s = torch.einsum("tkgd,skd->kgts", q, k) / Dh ** 0.5
    mask = torch.ones((T, T), dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    o = torch.einsum("kgts,skd->tkgd", torch.softmax(s, dim=-1), v)
    return prec.mm(prec.act(o.reshape(T, H * Dh)),
                   p["wo"][l].reshape(H * Dh, D))


def _moe(h, p, l, c, plen, prec):
    T = h.shape[0]
    E, k = c["num_local_experts"], c["num_experts_per_tok"]
    probs = torch.softmax(h @ p["router"][l].float(), dim=-1)
    wts, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    wts, idx = wts[:, :k], idx[:, :k]
    wts = wts / wts.sum(dim=-1, keepdim=True)
    keep = torch.ones_like(idx, dtype=torch.bool)
    n = min(plen, T)
    if n:
        flat = idx[:n].reshape(-1)                       # (position, k) order
        onehot = torch.nn.functional.one_hot(flat, E)
        before = (torch.cumsum(onehot, dim=0) - onehot).gather(
            1, flat[:, None])[:, 0]
        keep[:n] = (before < capacity(c, plen)).view(n, k)
    out = torch.zeros_like(h)
    for e in range(E):
        rows, slot = torch.nonzero((idx == e) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        y = prec.mm(prec.act(silu(prec.mm(x, p["gate"][l, e]))
                             * prec.mm(x, p["up"][l, e])), p["down"][l, e])
        out.index_add_(0, rows, y * wts[rows, slot][:, None])
    return out


@torch.no_grad()
def forward(tree: dict, c: dict, tokens: torch.Tensor, plen: int,
            prec: Precision) -> torch.Tensor:
    """f32 logits (T, V) of ``tokens`` (T,), whose first ``plen`` are one
    admission's padded prompt."""
    eps = c["rms_norm_eps"]
    emb = tree["embed"]
    p = tree["layers"][0]
    x = prec.act(emb[tokens.long()])
    for l in range(c["num_hidden_layers"]):
        h = prec.act(rmsnorm(x, p["mixer_norm"]["scale"][l], eps))
        x = prec.act(x + _attention(h, p["mixer"], l, c, prec))
        h = prec.act(rmsnorm(x, p["ffn_norm"]["scale"][l], eps))
        x = prec.act(x + _moe(h, p["ffn"], l, c, plen, prec))
    x = prec.act(rmsnorm(x, tree["final_norm"]["scale"], eps))
    return prec.mm(x, emb.T)
