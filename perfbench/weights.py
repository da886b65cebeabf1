"""Weights made from the seed, on the device, in a few large calls.

The tree is the layout the program's parameters take (the JAX reference's
pytree, which ``repro_torch.models.transformer.LMParams`` wraps): ``embed``
(V, D), ``final_norm.scale`` (D,), and ``layers[0]``, whose leaves are
stacked over the layers.  RMSNorm scales are stored as ``scale - 1``.
Matrices are drawn in ``dtype`` (bf16 to serve, f32 for a train state's
master weights) as one normal draw cut into views; the f32 leaves (norm
scales, the router, the SSM's A, dt bias and D) come from two f32 draws.
The same tensors go to the program and to the reference.
"""

from __future__ import annotations

import math

import torch


def _leaf_specs(c: dict) -> tuple[list, list]:
    """(matrices, f32 leaves) of configuration ``c``: each matrix
    ``(path, shape, std)``; each f32 leaf ``(path, shape, kind)``."""
    L, D, V = c["num_hidden_layers"], c["hidden_size"], c["vocab_size"]
    mats = [(("embed",), (V, D), 0.02)]
    f32 = [(("final_norm", "scale"), (D,), "norm")]
    if c["family"] == "moe":
        H, K, Dh = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
        E, F = c["num_local_experts"], c["intermediate_size"]
        mats += [
            (("mixer", "wq"), (L, D, H, Dh), 1 / math.sqrt(D)),
            (("mixer", "wk"), (L, D, K, Dh), 1 / math.sqrt(D)),
            (("mixer", "wv"), (L, D, K, Dh), 1 / math.sqrt(D)),
            (("mixer", "wo"), (L, H, Dh, D), 1 / math.sqrt(H * Dh)),
            (("ffn", "up"), (L, E, D, F), 1 / math.sqrt(D)),
            (("ffn", "gate"), (L, E, D, F), 1 / math.sqrt(D)),
            (("ffn", "down"), (L, E, F, D), 1 / math.sqrt(F)),
        ]
        f32 += [(("mixer_norm", "scale"), (L, D), "norm"),
                (("ffn_norm", "scale"), (L, D), "norm"),
                (("ffn", "router"), (L, D, E), "router")]
    elif c["family"] == "ssm":
        N, P = c["state_size"], c["head_dim"]
        d_inner = c["expand"] * D
        H = d_inner // P
        G = c["n_groups"]
        conv_dim = d_inner + 2 * G * N
        in_dim = 2 * d_inner + 2 * G * N + H
        W = c["conv_kernel"]
        mats += [
            (("mixer", "in_proj"), (L, D, in_dim), 1 / math.sqrt(D)),
            (("mixer", "conv_w"), (L, W, conv_dim), 0.1),
            (("mixer", "conv_b"), (L, conv_dim), 0.1),
            (("mixer", "out_proj"), (L, d_inner, D), 1 / math.sqrt(d_inner)),
        ]
        f32 += [(("mixer_norm", "scale"), (L, D), "norm"),
                (("mixer", "A_log"), (L, H), "A_log"),
                (("mixer", "dt_bias"), (L, H), "dt_bias"),
                (("mixer", "D_skip"), (L, H), "D_skip"),
                (("mixer", "norm_scale"), (L, d_inner), "norm")]
    else:
        raise ValueError(f"no weights for family {c['family']!r}")
    return mats, f32


def _put(tree: dict, path: tuple, t: torch.Tensor):
    if path[0] in ("embed",):
        tree["embed"] = t
        return
    if path[0] == "final_norm":
        tree["final_norm"] = {"scale": t}
        return
    tree["layers"][0].setdefault(path[0], {})[path[1]] = t


def make_weights(c: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The tree of configuration ``c`` from ``seed`` on ``device``."""
    mats, f32 = _leaf_specs(c)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    total = sum(math.prod(s) for _, s, _ in mats)
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    tree: dict = {"layers": [{}]}
    off = 0
    for path, shape, std in mats:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        t.mul_(std)
        _put(tree, path, t)
        off += n
    n32 = sum(math.prod(s) for _, s, _ in f32)
    normal = torch.randn(n32, generator=gen, dtype=torch.float32,
                         device=device)
    unif = torch.rand(n32, generator=gen, dtype=torch.float32, device=device)
    off = 0
    D = c["hidden_size"]
    for path, shape, kind in f32:
        n = math.prod(shape)
        z, u = normal[off:off + n].view(shape), unif[off:off + n].view(shape)
        if kind == "norm":                 # stored as scale - 1
            t = z * 0.1
        elif kind == "router":
            t = z / math.sqrt(D)
        elif kind == "A_log":              # A uniform on [1, 16]
            t = torch.log(1.0 + 15.0 * u)
        elif kind == "dt_bias":            # softplus^-1 of dt, log-uniform
            dt = torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3)))
            t = dt + torch.log(-torch.expm1(-dt))
        elif kind == "D_skip":
            t = 0.5 + u
        else:
            raise ValueError(kind)
        _put(tree, path, t.contiguous())
        off += n
    return tree

