"""Fused residual-add + RMSNorm: CUDA kernel wrapper + plain version.

Replaces the TPU kernel ``rmsnorm_kernel``
(``src/repro/kernels/rmsnorm/kernel.py``; wrapper
``repro.kernels.rmsnorm.ops.rmsnorm_fused``).  It computes, per row,
``x = x (+ residual)`` in f32, ``var = mean(x^2)``,
``normed = x * rsqrt(var + eps) * (1 + scale)`` and returns
``(normed, x)`` both cast to x's dtype — the two-output contract.

The kernel is ``csrc/rmsnorm.cu``: one 128-thread block per row (the 8
decode rows on 8 SMs), 16-byte loads and stores, the row and its scale
held in registers between the reduction and the elementwise pass (up to
D = 4096).  At the main path's decode shape (8 rows of 960) the device work
is a microsecond or two and the host path of each call is the cost, so the
wrapper keeps it short: the ctypes entry is typed once, both outputs come
from one ``torch.empty``, the stream is read as a raw handle, and the
device is switched only when x is not on the current one
(``_build.call``).

`rmsnorm_fused` launches the kernel for CUDA tensors and runs
`rmsnorm_plain` for CPU tensors; there is no other path.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}   # the kernel's dtype codes
_entry = None


def rmsnorm_plain(x, scale, residual=None, *, eps=1e-5):
    """The kernel's function in plain PyTorch (same cast points: residual
    add, variance and scaling in f32; both outputs in x's dtype)."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    normed = normed * (1.0 + scale.float())
    return normed.to(x.dtype), xf.to(x.dtype)


def rmsnorm_fused(x, scale, residual=None, *, eps=1e-5):
    """x: (..., D); scale: (D,) stored as (gamma - 1); optional residual of
    x's shape.  Returns (normed, residual_out), both shaped like x.  CUDA
    tensors launch the kernel; CPU tensors run the plain version."""
    global _entry
    _build.refuse_grad("rmsnorm_fused", x, scale, residual)
    dev = x.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return rmsnorm_plain(x, scale, residual, eps=eps)
        raise ValueError(f"rmsnorm_fused: no kernel for {dev}")
    D = x.shape[-1]
    if x.dtype not in _DTYPES or not x.is_contiguous() \
            or scale.shape != (D,) or scale.dtype != torch.float32 \
            or scale.device != dev or not scale.is_contiguous():
        raise ValueError("rmsnorm_fused: x must be a contiguous bf16 or f32 "
                         "tensor and scale a (D,) f32 one on the same device")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or not residual.is_contiguous()
                                 or residual.device != dev):
        raise ValueError("rmsnorm_fused: residual must match x")
    if _entry is None:
        _entry = _build.entry("rmsnorm", "rmsnorm_fused_fwd", 4, 3)
    out = torch.empty((2, *x.shape), dtype=x.dtype, device=dev)
    err = _build.call(_entry, dev, x.data_ptr(),
                      0 if residual is None else residual.data_ptr(),
                      scale.data_ptr(), out.data_ptr(), x.numel() // max(D, 1),
                      D, _DTYPES[x.dtype], eps)
    if err:
        _build.check("rmsnorm", err, "rmsnorm_fused")
    rmsnorm_fused.launches += 1
    return out.unbind(0)


rmsnorm_fused.launches = 0
