"""Parameter bridge between the JAX package's pytree and the port's module.

The reference's parameters (``repro.models.api.build_model(cfg).init``)
come in as a nested dict of numpy arrays — ``embed``, ``layers`` (one dict
per slot, leaves stacked ``(n_groups, ...)``), ``final_norm`` and an
optional ``head`` — and map leaf to leaf onto :class:`LMParams`.  bf16
arrays (numpy's ``ml_dtypes`` bfloat16, which torch cannot take) go
through float32, which is exact.  Norm scales stay float32 because the
reference takes ``1 + scale`` in f32, and so do MoE routers, whose f32
logits decide which experts a token reaches (``moe.router_probs`` casts
both operands to f32), and the SSM mixer's ``A_log``, ``dt_bias``,
``D_skip`` and ``norm_scale``, which the reference reads in f32
(``models/ssm.py``); every other leaf is stored in bf16, which rounds
exactly as the reference's ``.astype(bf16)`` at use does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import LMParams


F32_LEAVES = ("scale", "router", "A_log", "dt_bias", "D_skip", "norm_scale")


def _keeps_f32(path: tuple) -> bool:
    return path[-1] in F32_LEAVES


def _convert(tree, path, device, matrix_dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, path + (k,), device, matrix_dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, path + (i,), device, matrix_dtype)
                for i, v in enumerate(tree)]
    t = torch.from_numpy(np.array(tree, dtype=np.float32))   # own copy
    dt = torch.float32 if _keeps_f32(path) else matrix_dtype
    return t.to(device=device, dtype=dt)


def params_from_numpy(tree: dict, cfg, device="cuda",
                      matrix_dtype=torch.bfloat16) -> LMParams:
    """The reference's parameter pytree (numpy leaves) -> :class:`LMParams`
    on ``device``."""
    out = _convert(tree, (), torch.device(device), matrix_dtype)
    if cfg.tie_embeddings and "head" in out:
        raise ValueError("tied-embedding config but the tree has a head")
    return LMParams(out)


def params_to_numpy(params: LMParams) -> dict:
    """:class:`LMParams` -> the reference's pytree layout, float32 numpy."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t.detach().float().cpu().numpy()
    return walk(params.tree())
