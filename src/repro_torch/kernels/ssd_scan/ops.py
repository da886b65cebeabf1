"""Mamba-2 SSD chunked scan: CUDA kernel wrapper + plain version.

Replaces the TPU kernel ``ssd_scan_kernel``
(``src/repro/kernels/ssd_scan/kernel.py``; wrapper
``repro.kernels.ssd_scan.ops.ssd_scan``, oracle ``ref.ssd_scan_ref``).
Per (batch, head), over chunks of Q steps in order, all in f32:

    dA = dt * A_h ;  cum = inclusive cumsum(dA)
    y  = ((C B^T) . L) @ (dt * x)  +  exp(cum) * (C @ state)
         with L = exp(cum_q - cum_j) masked to j <= q inside the exponent
    state <- exp(cum_Q) * state + B^T @ (x * dt * exp(cum_Q - cum))

``y`` uses the state from before the chunk's update; the final state is
returned once, after the last chunk.  B and C of group ``h // (H/G)``
serve head ``h``.

The kernel is ``csrc/ssd_scan.cu``, three launches with every product on
the tensor cores (bf16 -> f32): each chunk's own end state into a
workspace (``mma.sync``); the state entering each chunk (and the final
state) by passing those states along; then per (one or two heads, chunk,
64-row q tile) the carry-in (``mma.sync``), the causal intra-chunk term
(C.B^T and its product with x on ``wgmma``) and y, with C.B^T computed
once for both heads of a pair.  f32 accuracy comes from splitting each f32
operand into bf16 hi + lo (the f32 instance also splits x, B and C).  Its
header says what bounds it on the H100 and what the design does about it.
It reads the model layout as it is and masks the ragged last chunk itself,
which computes what padding with ``dt = 0`` does (an exact no-op on the
carried state).  There is no interpret mode: a CPU tensor runs the plain
version.

`ssd_scan` launches the kernel for CUDA tensors (every call counts once in
``ssd_scan.launches``, for its three device launches) and runs
`ssd_scan_plain` for CPU tensors; there is no other path.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_STATE_DIM = 128        # the kernel's (64, 128) shared B and C tiles
# The kernel's own chunk length, at most: the scan's result does not depend
# on how the sequence is chunked (padding rows are exact no-ops), and
# shorter chunks shorten each output CTA's causal walk for a longer state
# passing (PERF.md, row 7 of the kernel table, times both).
KERNEL_CHUNK = 128
_entries: dict = {}        # C entries by name, typed once


def chunk_for(S: int, chunk: int) -> int:
    """The reference wrapper's chunk choice: ``chunk`` when it divides S,
    else ``min(chunk, S)`` (the sequence is then padded to a multiple)."""
    return min(chunk, S) if S % chunk else chunk


def _shapes(x, dt, A, B, C):
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if (dt.shape != (b, S, H) or A.shape != (H,) or B.shape != (b, S, G, N)
            or C.shape != B.shape or G == 0 or H % G):
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}: need "
            "x (b,S,H,P), dt (b,S,H), A (H,), B = C (b,S,G,N), H % G == 0")
    if S == 0:
        raise ValueError("ssd_scan: empty sequence")
    return b, S, H, P, G, N


def ssd_scan_plain(x, dt, A, B, C, *, chunk=128):
    """The kernel's function in plain PyTorch, chunk by chunk in f32 as the
    Pallas kernel computes it (model layout).  x: (b,S,H,P); dt: (b,S,H)
    post-softplus; A: (H,) negative; B, C: (b,S,G,N).  Returns (y
    (b,S,H,P) in x's dtype, final state (b,H,N,P) f32)."""
    b, S, H, P, G, N = _shapes(x, dt, A, B, C)
    Q = chunk_for(S, chunk)
    pad = (-S) % Q
    rep = H // G
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))    # dt = 0
    Bf, Cf = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
              .repeat_interleave(rep, dim=2) for t in (B, C))    # (b,S',H,N)
    Af = A.float()
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S + pad, Q):
        xc, dtc = xf[:, c0:c0 + Q], dtf[:, c0:c0 + Q]
        Bc, Cc = Bf[:, c0:c0 + Q], Cf[:, c0:c0 + Q]
        cum = torch.cumsum(dtc * Af, dim=1)                     # (b,Q,H)
        total = cum[:, -1]                                      # (b,H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]           # (b,q,j,H)
        seg = seg.masked_fill(~causal[None, :, :, None], float("-inf"))
        M = (torch.einsum("bqhn,bjhn->bhqj", Cc, Bc)
             * torch.exp(seg).permute(0, 3, 1, 2))
        y = torch.einsum("bhqj,bjhp->bqhp", M, xc * dtc[..., None])
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bqhn,bhnp->bqhp", Cc, state)
        ys.append(y)
        w = dtc * torch.exp(total[:, None] - cum)               # (b,Q,H)
        state = (torch.exp(total)[..., None, None] * state
                 + torch.einsum("bjhn,bjhp->bhnp", Bc, xc * w[..., None]))
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(x.dtype), state


def ssd_scan(x, dt, A, B, C, *, chunk=128):
    """x: (b,S,H,P) bf16 or f32; dt: (b,S,H) f32; A: (H,) f32; B, C:
    (b,S,G,N) in x's dtype.  Returns (y (b,S,H,P) in x's dtype, final
    state (b,H,N,P) f32).  CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    _build.refuse_grad("ssd_scan", x, dt, A, B, C)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for {x.device}")
    return _launch(x, dt, A, B, C, chunk)


def _launch(x, dt, A, B, C, chunk, *, Q=None, heads=0):
    """One launch of the kernel on CUDA tensors, on its own chunks of Q
    steps (by default ``min(chunk_for(S, chunk), KERNEL_CHUNK)``), with
    ``heads`` (1 or 2) heads a CTA in its last phase, or 0 to leave that
    choice to the kernel.  `ssd_scan` takes the defaults; chip_smoke.py
    times the other choices through here."""
    b, S, H, P, G, N = _shapes(x, dt, A, B, C)
    Q = min(chunk_for(S, chunk), KERNEL_CHUNK) if Q is None else Q
    if N > MAX_STATE_DIM:
        raise ValueError(f"ssd_scan: state_dim {N} > {MAX_STATE_DIM}")
    suffix = {torch.bfloat16: "bf16", torch.float32: "f32"}.get(x.dtype)
    if suffix is None:
        raise ValueError(f"ssd_scan: x must be bf16 or f32, got {x.dtype}")
    x, dt, A, B, C = (t.contiguous() for t in (x, dt, A, B, C))
    _build.check_operands("ssd_scan", x.device, [
        ("x", x, x.dtype), ("dt", dt, torch.float32), ("A", A, torch.float32),
        ("B", B, x.dtype), ("C", C, x.dtype)])
    fn = _entries.get(suffix)
    if fn is None:
        fn = _entries[suffix] = _build.entry("ssd_scan", f"ssd_scan_{suffix}",
                                             8, 8, scale=False)
    size = _entries.get("ws")
    if size is None:     # the workspace's layout lives in the kernel alone
        size = _build.library("ssd_scan").ssd_scan_workspace_floats
        size.argtypes = [ctypes.c_int] * 6
        size.restype = ctypes.c_longlong
        _entries["ws"] = size
    y = torch.empty_like(x)
    state = torch.empty((b, H, N, P), dtype=torch.float32, device=x.device)
    ws = torch.empty(size(b, S, H, P, N, Q), dtype=torch.float32,
                     device=x.device)
    err = _build.call(fn, x.device, x.data_ptr(), dt.data_ptr(),
                      A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
                      state.data_ptr(), ws.data_ptr(), b, S, H, P, G, N, Q,
                      heads)
    if err:
        _build.check("ssd_scan", err, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
