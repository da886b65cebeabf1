"""The first steps of a train payload, in plain PyTorch.

Next-token cross-entropy, the mean over every position of the batch, its
gradient by autograd (a row at a time, each layer recomputed in the
backward pass, so it fits), then AdamW as the configuration's
``train.optimizer`` states it: the gradients clipped to a global norm
(their tree's root sum of squares), bias-corrected moments, decoupled
weight decay on every parameter, and a learning rate warmed up linearly
from the first update, then cosine-decayed.  Parameters start from the
weights the benchmark made, in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import mamba2
from perfbench.reference.common import Precision, full_f32

LOGITS = {"ssm": mamba2.logits}


def leaves(tree, path=()):
    """(path, tensor) of every leaf of a nested dict and list tree, keys
    in sorted order."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))


def tree_map(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return [tree_map(fn, v) for v in tree]


def lr_at(oc: dict, step: int) -> float:
    """The learning rate of update ``step`` (the first is 1)."""
    if step < oc["warmup_steps"]:
        return oc["peak_lr"] * step / max(oc["warmup_steps"], 1)
    prog = (step - oc["warmup_steps"]) / max(
        oc["total_steps"] - oc["warmup_steps"], 1)
    prog = min(max(prog, 0.0), 1.0)
    r = oc["min_lr_ratio"]
    return oc["peak_lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


def run(tree0: dict, c: dict, batches: list, device, prec: Precision) -> dict:
    """Train from ``tree0`` (left unchanged) on ``batches`` (host dicts of
    ``tokens`` and ``targets``, (B, S) each).  Returns each step's loss,
    each step's clipped gradient norm by leaf, and each leaf's change norm
    after the last step."""
    oc = c["train"]["optimizer"]
    fwd = LOGITS[c["family"]]
    ptree = tree_map(lambda t: t.detach().clone().float().requires_grad_(True),
                     tree0)
    params = dict(leaves(ptree))
    start = {path: t.detach().float() for path, t in leaves(tree0)}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad_norms = [], []

    def layer(fn, x):
        return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False)

    with full_f32():
        for step, batch in enumerate(batches, start=1):
            tok = torch.as_tensor(batch["tokens"], device=device)
            tgt = torch.as_tensor(batch["targets"], device=device)
            B, S = tok.shape
            for p in params.values():
                p.grad = None
            total = 0.0
            for r in range(B):
                lg = fwd(ptree, c, tok[r], prec, layer=layer)
                loss = F.cross_entropy(lg, tgt[r].long(), reduction="sum") / (B * S)
                loss.backward()
                total += float(loss.detach())
                del lg, loss
            losses.append(total)
            with torch.no_grad():
                g2 = sum(float(p.grad.double().pow(2).sum())
                         for p in params.values())
                scale = min(1.0, oc["clip_norm"] / max(math.sqrt(g2), 1e-9))
                lr = lr_at(oc, step)
                bc1 = 1 - oc["b1"] ** step
                bc2 = 1 - oc["b2"] ** step
                grad_norms.append({k: float(p.grad.norm()) * scale
                                   for k, p in params.items()})
                for k, p in params.items():
                    g = p.grad * scale
                    m[k].mul_(oc["b1"]).add_(g, alpha=1 - oc["b1"])
                    v2[k].mul_(oc["b2"]).add_(g * g, alpha=1 - oc["b2"])
                    upd = (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + oc["eps"])
                    p.sub_(lr * (upd + oc["weight_decay"] * p))
    change = {k: float((p.detach() - start[k]).norm())
              for k, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
