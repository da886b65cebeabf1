"""Fused residual-add + RMSNorm: Triton kernel wrapper + plain version.

Replaces the TPU kernel ``rmsnorm_kernel``
(``src/repro/kernels/rmsnorm/kernel.py``; wrapper
``repro.kernels.rmsnorm.ops.rmsnorm_fused``).  It computes, per row,
``x = x (+ residual)`` in f32, ``var = mean(x^2)``,
``normed = x * rsqrt(var + eps) * (1 + scale)`` and returns
``(normed, x)`` both cast to x's dtype — the two-output contract.

What bounds it on the H100: memory (one read of x, of the residual and of
the scale, two row writes; a few flops per element).  The design keeps the
row in registers between the reduction and the elementwise pass, so every
byte crosses device memory once: one Triton program per row, the row as one
power-of-two block masked down to D (960 on the main path -> 1024).  At the
main path's decode shape (8 rows) the launch, not the bytes, is the cost.

`rmsnorm_fused` launches the kernel for CUDA tensors and runs
`rmsnorm_plain` for CPU tensors; there is no other path.
"""

from __future__ import annotations

import os

import torch

from repro_torch.kernels import _build

_KERNEL = None


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


def _kernel():
    """Build the Triton kernel at first use (triton exists only on the
    machine with the card; its cache goes beside the CUDA builds)."""
    global _KERNEL, triton, tl
    if _KERNEL is not None:
        return _KERNEL
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(_build.BUILD_DIR.parent / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_row(x_ptr, r_ptr, scale_ptr, o_ptr, res_ptr, D, eps,
                    HAS_RES: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        mask = cols < D
        off = row.to(tl.int64) * D + cols
        x = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        if HAS_RES:
            x = x + tl.load(r_ptr + off, mask=mask, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / D
        normed = x * tl.rsqrt(var + eps)
        sc = tl.load(scale_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        normed = normed * (1.0 + sc)
        tl.store(o_ptr + off, normed.to(o_ptr.dtype.element_ty), mask=mask)
        tl.store(res_ptr + off, x.to(res_ptr.dtype.element_ty), mask=mask)

    _KERNEL = rmsnorm_row
    return _KERNEL


def rmsnorm_fused(x, scale, residual=None, *, eps=1e-5):
    """x: (..., D); scale: (D,) stored as (gamma - 1); optional residual of
    x's shape.  Returns (normed, residual_out), both shaped like x.  CUDA
    tensors launch the kernel; CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, residual, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_fused: no kernel for {x.device}")
    D = x.shape[-1]
    if not x.is_contiguous() or tuple(scale.shape) != (D,) \
            or scale.device != x.device or not scale.is_contiguous():
        raise ValueError("rmsnorm_fused: x must be contiguous and scale (D,) "
                         "on the same device")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or not residual.is_contiguous()
                                 or residual.device != x.device):
        raise ValueError("rmsnorm_fused: residual must match x")
    x2 = x.reshape(-1, D)
    R = x2.shape[0]
    o = torch.empty_like(x2)
    res = torch.empty_like(x2)
    kernel = _kernel()
    block = 1 << max(D - 1, 1).bit_length()
    with torch.cuda.device(x.device):
        kernel[(R,)](x2, residual.reshape(-1, D) if residual is not None else x2,
                     scale, o, res, D, eps, HAS_RES=residual is not None,
                     BLOCK=block, num_warps=4 if block <= 2048 else 8)
    rmsnorm_fused.launches += 1
    return o.reshape(x.shape), res.reshape(x.shape)


rmsnorm_fused.launches = 0
