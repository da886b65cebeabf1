"""Shared pieces of the references: precision, RMSNorm, RoPE, SiLU."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0                    # float8_e4m3fn's largest finite value


@contextlib.contextmanager
def full_f32():
    """f32 products in full f32 on the card (no TF32) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its absolute maximum maps to 448), back in f32."""
    amax = t.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    if torch.is_grad_enabled() and t.requires_grad:
        return t + (q - t).detach()        # the gradient passes the rounding
    return q


class Precision:
    """How a forward rounds: ``"f32"`` (the reference: nothing rounded,
    f32 products with TF32 off) or ``"fp8"`` (the control, one step below
    the bf16 the configurations serve in: wherever the program rounds to
    bf16, this rounds to float8 e4m3 instead, with a scale per row of an
    activation and per column of a weight; products accumulate in f32)."""

    def __init__(self, name: str):
        if name not in ("f32", "fp8"):
            raise ValueError(name)
        self.name = name

    def act(self, t: torch.Tensor) -> torch.Tensor:
        """An activation as the program stores it (the residual stream,
        q, k, v, a layer's hidden)."""
        t = t.float()
        return _fp8(t, -1) if self.name == "fp8" else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` for activations x (..., K) and weights w (K, N)."""
        x, w = x.float(), w.float()
        if self.name == "fp8":
            x, w = _fp8(x, -1), _fp8(w, -2)
        return x @ w


def rmsnorm(x: torch.Tensor, scale_minus_one: torch.Tensor,
            eps: float) -> torch.Tensor:
    """RMSNorm with the stored ``scale - 1`` applied as ``1 + scale``."""
    var = x.pow(2).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale_minus_one.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (T, heads, dim) at positions 0..T-1, the head
    split in halves (rotate-half)."""
    T, _, dim = x.shape
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=x.device) / dim)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :dim // 2], x[..., dim // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
