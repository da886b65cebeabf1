"""AdamW + global-norm clipping + cosine schedule.

Port of ``repro.optim.adamw``.  The moments are trees with the parameters'
structure, as in the reference, so a train state ``{"params", "opt": {"m",
"v", "step"}}`` has the reference's leaves in the reference's order
(`repro_torch.tree`) and checkpoints into its layout.  The reference
returns new pytrees and donates the old ones; here `adamw_update` writes
the parameters and the moments IN PLACE under ``torch.no_grad()``, the
torch idiom, with the reference's order of operations in f32: the optional
``grad_transform`` (e.g. `repro_torch.runtime.compression`), the global
norm, the clip, the bias-corrected moments, then decoupled weight decay on
the f32 parameter.  Every scalar (step, lr, norm) stays a 0-d tensor on the
parameters' device, so an update makes no host sync.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_lr(oc: OptimConfig, step):
    """Linear warm-up to ``peak_lr``, then a cosine down to ``min_lr_ratio``
    of it; ``step`` an int tensor, the result a 0-d f32 tensor."""
    step = torch.as_tensor(step).float()
    warm = step / max(oc.warmup_steps, 1)
    prog = (step - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = oc.min_lr_ratio + (1 - oc.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return oc.peak_lr * torch.where(step < oc.warmup_steps, warm, cos)


def init_opt_state(params):
    """Zero moments shaped as ``params`` (a tree of tensors) and an int32
    step on their device."""
    first = tree.leaves(params)[0]
    return {"m": tree.map_leaves(torch.zeros_like, params),
            "v": tree.map_leaves(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(grads):
    """sqrt of the sum of every leaf's squares, in f32, leaves summed in
    tree order."""
    total = None
    for g in tree.leaves(grads):
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, opt_state, oc: OptimConfig,
                 grad_transform: Callable[[Any], Any] | None = None) -> dict:
    """One AdamW step on ``params`` (a tree of tensors, e.g.
    ``LMParams.live()``) from ``grads`` (the same tree), updating the
    parameters and ``opt_state`` in place.  Returns {"grad_norm", "lr"}
    (0-d f32 tensors)."""
    step = opt_state["step"]
    step.add_(1)
    if grad_transform is not None:
        grads = grad_transform(grads)
    gnorm = global_norm(grads)
    scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = cosine_lr(oc, step)
    b1, b2 = oc.b1, oc.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                          tree.leaves(opt_state["m"]),
                          tree.leaves(opt_state["v"]), strict=True):
        g = (g * scale).float()
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        step_dir = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps)
        pf = p.float()
        p.copy_(pf - lr * (step_dir + oc.weight_decay * pf))
    return {"grad_norm": gnorm, "lr": lr}
