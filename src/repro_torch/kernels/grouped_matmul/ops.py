"""Grouped (per-expert) matmul: CUDA kernel wrapper + plain version.

Replaces the TPU kernel ``grouped_matmul_kernel``
(``src/repro/kernels/grouped_matmul/kernel.py``; wrappers
``repro.kernels.grouped_matmul.ops.grouped_matmul`` / ``bucket_matmul``,
oracle ``ref.grouped_matmul_ref``).  Rows sorted by group times the weight
slab of each group's expert, bf16 products summed in f32, f32 out.

The kernel is ``csrc/grouped_matmul.cu``: ``wgmma`` on operands that TMA
brings into shared memory, persistent CTAs walking 128 x 128 output tiles,
each finding a tile's (group, column tile, row tile) itself and masking a
ragged group end.  What bounds it on the H100 is device-memory bytes
(~120-140 flop/byte at the MoE admission shapes, below the card's ~295);
its header says what the design does about it.  Unlike the Pallas kernel it needs no group padded to a tile
height: ``block_m``/``block_n`` are the reference's Pallas tile sizes,
kept in the signatures so callers pass the same arguments to either
package, and they do not change the result.  There is no interpret mode:
a CPU tensor runs the plain version.

Groups may outnumber experts: group ``g`` uses expert ``g % E``, so the
capacity buckets of a batch, ``(B, E, C, D)``, are ``B * E`` groups of
``C`` rows in one launch.  Under a serve mesh each model rank passes its
contiguous ``(E, D, F/m)`` part of ``up`` or ``gate`` as ``w``, unchanged:
the kernel walks fixed 128 x 128 output tiles and reduces each over the
whole of D, so a part whose width is a whole number of tiles gives the
whole call's columns bitwise (the serve engine checks it at construction,
`repro_torch.runtime.sharding.slices_exact`).

`grouped_matmul` and `bucket_matmul` launch the kernel for CUDA tensors
(every launch counts in ``grouped_matmul.launches``) and run
`grouped_matmul_plain` for CPU tensors; there is no other path.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_entry = None


def pad_group_sizes(group_sizes, block_m: int):
    """Round every group size up to a multiple of block_m."""
    return ((group_sizes + block_m - 1) // block_m) * block_m


def _n_groups(sizes_len: int, E: int) -> int:
    if sizes_len == 0 or sizes_len % E:
        raise ValueError(f"grouped_matmul: {sizes_len} groups for {E} "
                         "experts; group g uses expert g % E, so the count "
                         "must be a positive multiple of E")
    return sizes_len


def grouped_matmul_plain(x, w, group_sizes):
    """The kernel's function in plain PyTorch, group by group in f32 (never
    the reference oracle's (T, D, F) gather of weights, 32 GB at the main
    shape).  x: (T,D); w: (E,D,F); group_sizes: (G,) non-negative with G a
    multiple of E, group g's rows following group g-1's and using expert
    g % E.  Rows past the groups' sum are 0.  Returns (T,F) f32."""
    T = x.shape[0]
    E, _, F = w.shape
    sizes = torch.as_tensor(group_sizes).tolist()
    _n_groups(len(sizes), E)
    y = torch.zeros((T, F), dtype=torch.float32, device=x.device)
    off = 0
    for g, s in enumerate(sizes):
        end = min(off + max(int(s), 0), T)
        if end > off:
            y[off:end] = x[off:end].float() @ w[g % E].float()
        off += max(int(s), 0)
    return y


def _launch(x, w, sizes, n_groups: int, uniform: int):
    """One launch of the kernel over x (T, D) and w (E, D, F): ``sizes``
    (n_groups,) int32 on the card, or None for n_groups groups of
    ``uniform`` rows."""
    T, D = x.shape
    E, Dw, F = w.shape
    if Dw != D or D % 8 or F % 8:
        raise ValueError(f"grouped_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} need equal D and D, F multiples "
                         "of 8 (16-byte rows)")
    ops = [("x", x, torch.bfloat16), ("w", w, torch.bfloat16)]
    if sizes is not None:
        ops.append(("group_sizes", sizes, torch.int32))
    _build.check_operands("grouped_matmul", x.device, ops)
    if any(t.data_ptr() % 16 for _, t, _ in ops[:2]):
        raise ValueError("grouped_matmul: x and w must be 16-byte aligned")
    global _entry
    if _entry is None:
        _entry = _build.entry("grouped_matmul", "grouped_matmul_bf16", 4, 6,
                              scale=False)
    y = torch.empty((T, F), dtype=torch.float32, device=x.device)
    err = _build.call(_entry, x.device, x.data_ptr(), w.data_ptr(),
                      None if sizes is None else sizes.data_ptr(),
                      y.data_ptr(), T, D, F, E, n_groups, uniform)
    if err:
        _build.check("grouped_matmul", err, "grouped_matmul")
    grouped_matmul.launches += 1
    return y


def grouped_matmul(x, w, group_sizes, *, block_m=128, block_n=128):
    """x: (T,D) rows sorted by group; w: (E,D,F); group_sizes: (G,) sizes
    summing to <= T, G a multiple of E (group g uses expert g % E).
    Returns (T,F) f32; rows past the groups are 0.  CUDA tensors launch
    the kernel (bf16 x and w, int32 sizes); CPU tensors run the plain
    version."""
    _build.refuse_grad("grouped_matmul", x, w)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul: no kernel for {x.device}")
    n = _n_groups(group_sizes.shape[0], w.shape[0])
    return _launch(x, w, group_sizes, n, 0)


def bucket_matmul(buckets, w, *, block_m=128, block_n=128):
    """Capacity-bucket layout (models/moe.py): buckets (G,C,D), G a
    multiple of E, bucket g for expert g % E -> (G,C,F) f32.  CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    _build.refuse_grad("bucket_matmul", buckets, w)
    G, C, D = buckets.shape
    x = buckets.reshape(G * C, D)
    if buckets.device.type == "cpu":
        y = grouped_matmul_plain(x, w, [C] * G)
    elif buckets.device.type != "cuda":
        raise ValueError(f"bucket_matmul: no kernel for {buckets.device}")
    else:
        y = _launch(x, w, None, _n_groups(G, w.shape[0]), C)
    return y.reshape(G, C, w.shape[2])


grouped_matmul.launches = 0
