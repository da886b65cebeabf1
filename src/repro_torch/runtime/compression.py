"""Int8 error-feedback gradient compression.

Port of ``repro.runtime.compression``.  Before the data-parallel gradient
reduction, each gradient leaf is quantized to int8 with a per-leaf scale;
the quantization error is kept and added back to the next step's gradient
(error feedback keeps SGD/Adam convergence).  On a fleet this shrinks the
reduce-scatter payload 4x (f32 -> i8); with one device the transport is
modelled by the quantize -> dequantize round trip, as in the reference.
Plugged into `repro_torch.launch.steps.make_train_step` as its
``grad_transform``, with the residuals held by the caller beside the
optimizer state.
"""

from __future__ import annotations

import torch

from repro_torch import tree


def init_residuals(params):
    """f32 zeros shaped as ``params`` (a tree of tensors)."""
    return tree.map_leaves(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def _quantize_leaf(g, r):
    g = g.float() + r
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    dq = q.float() * scale
    return dq, g - dq


def compress(grads, residuals):
    """Returns (dequantized grads, new residuals), each shaped as
    ``grads``.  The transport payload is the int8 tensor and one f32 scale
    per leaf."""
    out = [_quantize_leaf(g, r) for g, r in zip(
        tree.leaves(grads), tree.leaves(residuals), strict=True)]
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(grads, [o[1] for o in out]))


def payload_bytes(grads) -> tuple[int, int]:
    """(uncompressed_bytes, compressed_bytes) of the DP reduction payload."""
    flat = tree.leaves(grads)
    raw = sum(g.numel() * g.element_size() for g in flat)
    comp = sum(g.numel() * 1 + 4 for g in flat)
    return raw, comp
