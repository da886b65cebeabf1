"""Parameter bridge between the JAX package's pytree and the port's module.

The reference's parameters (``repro.models.api.build_model(cfg).init``)
come in as a nested dict of numpy arrays — ``embed``, ``layers`` (one dict
per slot, leaves stacked ``(n_groups, ...)``), ``final_norm`` and an
optional ``head`` — and map leaf to leaf onto :class:`LMParams`.  bf16
arrays (numpy's ``ml_dtypes`` bfloat16, which torch cannot take) go
through float32, which is exact.  Norm scales (and LayerNorm biases) stay
float32 because the reference keeps them in f32 and applies them in f32
(``1 + scale`` for RMSNorm), and so do MoE routers, whose f32
logits decide which experts a token reaches (``moe.router_probs`` casts
both operands to f32), and the SSM mixer's ``A_log``, ``dt_bias``,
``D_skip`` and ``norm_scale``, which the reference reads in f32
(``models/ssm.py``), and MLA's ``q_norm`` and ``kv_norm`` scales, which
the reference initialises and applies in f32 (``models/attention.py``);
every other leaf is stored in bf16, which rounds
exactly as the reference's ``.astype(bf16)`` at use does.

A train state maps too: the reference's ``{"params", "opt": {"m", "v",
"step"}}`` (`repro.launch.steps.init_train_state`) becomes the port's
(`repro_torch.launch.steps.init_train_state`) with every leaf in f32 (the
master weights and moments; ``matrix_dtype=torch.float32``), the
parameters requiring grad and ``step`` an int32 scalar, and back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch.models.transformer import LMParams


F32_LEAVES = ("scale", "bias", "router", "A_log", "dt_bias", "D_skip",
              "norm_scale", "q_norm", "kv_norm")


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


def _host_f32(t) -> np.ndarray:
    """A float32 numpy copy (never a view of a CPU tensor's storage, which
    an in-place optimizer step would change under the caller)."""
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def params_to_numpy(params: LMParams) -> dict:
    """:class:`LMParams` -> the reference's pytree layout, float32 numpy."""
    return tree_mod.map_leaves(_host_f32, params.tree())


def train_state_from_numpy(state: dict, cfg, device="cuda") -> dict:
    """The reference's train state (numpy leaves) -> the port's: f32
    parameters requiring grad, f32 moments, an int32 ``step``."""
    dev = torch.device(device)
    params = params_from_numpy(state["params"], cfg, device=dev,
                               matrix_dtype=torch.float32)
    params.requires_grad_(True)
    opt = state["opt"]
    return {"params": params,
            "opt": {"m": _convert(opt["m"], (), dev, torch.float32),
                    "v": _convert(opt["v"], (), dev, torch.float32),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32, device=dev)}}


def train_state_to_numpy(state: dict) -> dict:
    """The port's train state -> the reference's layout: float32 numpy
    parameters and moments, an int32 numpy scalar ``step``."""
    opt = state["opt"]
    return {"params": params_to_numpy(state["params"]),
            "opt": {"m": tree_mod.map_leaves(_host_f32, opt["m"]),
                    "v": tree_mod.map_leaves(_host_f32, opt["v"]),
                    "step": np.asarray(int(opt["step"]), np.int32)}}
