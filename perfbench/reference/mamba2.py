"""Mamba-2 (``family: ssm``), plain PyTorch [arXiv:2405.21060].

Per layer, pre-norm: ``x += mixer(rmsnorm(x))``; then a final RMSNorm and
the tied head.  The mixer projects ``h @ in_proj`` into z (d_inner), xBC
(d_inner + 2N) and dt (H); xBC goes through a depthwise causal conv of
width W with bias, then SiLU, and splits into x (H heads of P), B and C
(N each, one group).  With dt = softplus(dt + dt_bias) and A = -exp(A_log),
the state recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T ;  y_t = C_t h_t + D x_t

runs from a zero state at position 0; it is evaluated here in its
quadratic (attention-like) form, ``y_t = sum_{s<=t} exp(cum_t - cum_s)
(C_t . B_s) dt_s x_s``, which no chunking enters.  The output is
``rmsnorm(y * silu(z)) @ out_proj``.  A served request's sequence is its
prompt left-padded with token 0 to its admission bucket, then its served
tokens: the pad runs through the state like any token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import Precision, rmsnorm, silu


def _mixer(h, p, l, c, prec):
    T = h.shape[0]
    N, P, W = c["state_size"], c["head_dim"], c["conv_kernel"]
    d_inner = c["expand"] * c["hidden_size"]
    H = d_inner // P
    zxbcdt = prec.act(prec.mm(h, p["in_proj"][l]))
    z = zxbcdt[:, :d_inner]
    xbc = zxbcdt[:, d_inner:2 * d_inner + 2 * N]
    dt = zxbcdt[:, 2 * d_inner + 2 * N:]
    w, b = p["conv_w"][l].float(), p["conv_b"][l].float()      # (W, C), (C,)
    padded = F.pad(xbc, (0, 0, W - 1, 0))
    conv = b + sum(w[i] * padded[i:i + T] for i in range(W))
    xbc = prec.act(silu(prec.act(conv)))
    x = xbc[:, :d_inner].view(T, H, P)
    B, C = xbc[:, d_inner:d_inner + N], xbc[:, d_inner + N:]
    dt = F.softplus(dt + p["dt_bias"][l])                       # (T, H)
    A = -torch.exp(p["A_log"][l])
    cum = torch.cumsum(dt * A, dim=0)                           # (T, H)
    seg = cum[:, None, :] - cum[None, :, :]                     # (t, s, H)
    causal = torch.ones((T, T), dtype=torch.bool, device=h.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[:, :, None], float("-inf")))
    M = (C @ B.T)[:, :, None] * decay
    y = torch.einsum("tsh,shp->thp", M, x * dt[:, :, None])
    y = y + x * p["D_skip"][l][None, :, None]
    y = prec.act(y.reshape(T, d_inner))
    y = prec.act(rmsnorm(y * silu(z), p["norm_scale"][l], c["rms_norm_eps"]))
    return prec.mm(y, p["out_proj"][l])


def logits(tree: dict, c: dict, tokens: torch.Tensor, prec: Precision,
           layer=None) -> torch.Tensor:
    """f32 logits (T, V) of ``tokens`` (T,) under autograd when the
    weights require it; ``layer(fn, x)`` runs each layer (e.g. under
    activation checkpointing)."""
    eps = c["rms_norm_eps"]
    emb = tree["embed"]
    p = tree["layers"][0]
    x = prec.act(emb[tokens.long()])
    for l in range(c["num_hidden_layers"]):
        def block(x, l=l):
            h = prec.act(rmsnorm(x, p["mixer_norm"]["scale"][l], eps))
            return prec.act(x + _mixer(h, p["mixer"], l, c, prec))
        x = block(x) if layer is None else layer(block, x)
    x = prec.act(rmsnorm(x, tree["final_norm"]["scale"], eps))
    return prec.mm(x, emb.T)


@torch.no_grad()
def forward(tree: dict, c: dict, tokens: torch.Tensor, plen: int,
            prec: Precision) -> torch.Tensor:
    """f32 logits (T, V) of ``tokens`` (T,); ``plen`` is not read (the
    state runs the same over the prompt and the served tokens)."""
    return logits(tree, c, tokens, prec)
