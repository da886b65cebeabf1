"""input_specs(): meta-device stand-ins for every step-function input.

Port of ``repro.launch.specs``.  The reference's stand-ins are
``jax.ShapeDtypeStruct``s from ``jax.eval_shape``; the port's are tensors
on ``torch.device("meta")``: they allocate nothing and carry the
reference's shapes and dtypes, leaf for leaf, and the port's step
functions run on them (`repro_torch.launch.op_cost`).  Train steps take
(state, batch); prefill takes (params, batch); decode takes (params,
decode_state).  Parameters come as the bundle's params object
(`LMParams`, `EncDecParams`; ``.tree()`` is the reference's pytree).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.api import (
    _has_frontend, _text_len, build_model, init_decode_state)
from repro_torch.optim.adamw import init_opt_state

META = torch.device("meta")


def param_specs(cfg: ArchConfig, *, dtype=None):
    """The parameters on meta, every leaf f32 as the reference's init
    makes them; ``dtype`` recasts the floating leaves (the reference's
    bf16 serve stand-ins)."""
    params = build_model(cfg).init(0, device=META, dtype=torch.float32)
    if dtype is not None:
        params = params.to(dtype)
    return params


def train_state_specs(cfg: ArchConfig):
    """{"params", "opt": {"m","v","step"}} on meta (f32 master)."""
    params = param_specs(cfg)
    params.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params.live())}


def decode_state_specs(cfg: ArchConfig, shape: ShapeSpec, *,
                       dtype=torch.bfloat16, kv: str = "dense"):
    """The decode state of ``shape`` on meta; the reference's default
    dense layout (a sliding window's rolling ring of its window's
    slots)."""
    return init_decode_state(cfg, shape.global_batch, shape.seq_len,
                             dtype=dtype, kv=kv, device=META)


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec,
                      compute=torch.bfloat16) -> dict:
    """tokens and targets (B, S) int32 and, for a VLM or audio model, the
    frontend stub (B, frontend_tokens, d_model) in ``compute``; a VLM's S
    leaves room for its patches."""
    B = shape.global_batch
    S = _text_len(cfg, shape.seq_len)
    specs = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META),
             "targets": torch.empty((B, S), dtype=torch.int32, device=META)}
    if _has_frontend(cfg):
        specs["frontend"] = torch.empty(
            (B, cfg.frontend_tokens, cfg.d_model), dtype=compute, device=META)
    return specs


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeSpec,
                        compute=torch.bfloat16) -> dict:
    return {k: v for k, v in train_batch_specs(cfg, shape, compute).items()
            if k != "targets"}


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, *, with_targets=True,
                compute=torch.bfloat16):
    if with_targets:
        return train_batch_specs(cfg, shape, compute)
    return prefill_batch_specs(cfg, shape, compute)


def input_specs(cfg: ArchConfig, shape: ShapeSpec, mode: str):
    """The step's argument tuple for the given step kind."""
    if mode == "train":
        return (train_state_specs(cfg), batch_specs(cfg, shape))
    if mode == "prefill":
        return (param_specs(cfg, dtype=torch.bfloat16),
                batch_specs(cfg, shape, with_targets=False))
    if mode == "decode":
        return (param_specs(cfg, dtype=torch.bfloat16),
                decode_state_specs(cfg, shape))
    raise ValueError(f"unknown mode {mode!r}")
