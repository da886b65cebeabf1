"""The port's three kernel modules against the JAX package's.

On the CPU each wrapper of ``repro_torch.kernels`` runs its plain PyTorch
version (the kernels themselves are CUDA C++ and run only on the card).
The same inputs, made with numpy from a seed, go through the JAX wrappers
in Pallas interpret mode (as tests/test_kernels.py runs them) and through
the f32 oracles.  Tolerances are those of tests/test_kernels.py: attention
rtol=5e-2, atol=2e-2 (bf16 operands of both products, summed in another
order); RMSNorm 5e-2.  The kernels against their plain versions on the card are
in tests/test_torch_card.py.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.paged_attention.ops import paged_decode_attention as jax_paged
from repro.kernels.paged_attention.ref import paged_decode_attention_ref
from repro.kernels.rmsnorm.ops import rmsnorm_fused as jax_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import (
    _attention_plain, flash_attention, flash_attention_plain, head_width)
from repro_torch.kernels.paged_attention.ops import (
    gather_kv, paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused, rmsnorm_plain

ATTN_TOL = dict(rtol=5e-2, atol=2e-2)
NORM_TOL = dict(rtol=5e-2, atol=5e-2)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _pair(rng, shape, dtype, scale=1.0):
    """The same values as a torch tensor and a jax array (bf16-exact when
    dtype is bf16)."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale)
    t = t.to(tdt)
    return t, jnp.asarray(t.float().numpy(), jdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def _paged_inputs(B, H, K, Dh, bs, mb, dtype, seed=0):
    rng = np.random.default_rng(seed)
    nb = B * mb + 2
    q = _pair(rng, (B, H, Dh), dtype)
    kp = _pair(rng, (nb, bs, K, Dh), dtype)
    vp = _pair(rng, (nb, bs, K, Dh), dtype)
    tables = np.stack([rng.permutation(np.arange(1, nb))[:mb]
                       for _ in range(B)]).astype(np.int32)
    lens = rng.integers(1, mb * bs + 1, size=(B,)).astype(np.int32)
    lens[0] = 1                          # a freshly admitted row
    if B > 1:
        lens[1] = mb * bs                # a full row
    if B > 2:
        tables[2] = 0                    # a free slot over the scratch block
        lens[2] = bs + 3
    return q, kp, vp, tables, lens


@pytest.mark.parametrize("B,H,K,Dh,bs,mb,dtype", [
    (3, 3, 1, 20, 16, 4, "f32"),     # smollm-360m smoke: G = 3, Dh = 20
    (3, 3, 1, 20, 16, 4, "bf16"),
    (4, 15, 5, 64, 16, 5, "bf16"),   # smollm-360m widths: G = 3, Dh = 64
    (3, 4, 4, 32, 8, 6, "f32"),      # G = 1, small blocks
])
def test_paged_decode_matches_jax(B, H, K, Dh, bs, mb, dtype):
    q, kp, vp, tables, lens = _paged_inputs(B, H, K, Dh, bs, mb, dtype)
    out = paged_decode_attention(q[0], kp[0], vp[0], torch.from_numpy(tables),
                                 torch.from_numpy(lens))
    assert out.dtype == q[0].dtype and out.shape == (B, H, Dh)
    ref = jax_paged(q[1], kp[1], vp[1], jnp.asarray(tables), jnp.asarray(lens))
    np.testing.assert_allclose(_np(out), _np(ref), **ATTN_TOL)
    oracle = paged_decode_attention_ref(q[1], kp[1], vp[1], jnp.asarray(tables),
                                        jnp.asarray(lens))
    np.testing.assert_allclose(_np(out), _np(oracle), **ATTN_TOL)


def test_paged_decode_ignores_rows_past_length():
    """Pool rows no valid position reads may hold anything (the scratch
    block keeps stale writes): NaN there must not reach the output, as in
    the Pallas body, and must not change a bit of it."""
    B, H, K, Dh, bs, mb = 3, 6, 2, 32, 16, 4
    q, kp, vp, tables, lens = _paged_inputs(B, H, K, Dh, bs, mb, "bf16", 1)
    lens[:] = [5, 20, 7]
    tables[2] = 0                        # a free slot over the scratch block
    args = (torch.from_numpy(tables), torch.from_numpy(lens))
    clean = paged_decode_attention(q[0], kp[0], vp[0], *args)
    read = {(int(tables[b, p // bs]), p % bs)
            for b in range(B) for p in range(lens[b])}
    kp_t, vp_t = kp[0].clone(), vp[0].clone()
    for blk in range(kp_t.shape[0]):
        for r in range(bs):
            if (blk, r) not in read:
                kp_t[blk, r] = float("nan")
                vp_t[blk, r] = float("nan")
    dirty = paged_decode_attention(q[0], kp_t, vp_t, *args)
    assert torch.equal(clean, dirty)
    ref = jax_paged(q[1], jnp.asarray(kp_t.float().numpy(), jnp.bfloat16),
                    jnp.asarray(vp_t.float().numpy(), jnp.bfloat16),
                    jnp.asarray(tables), jnp.asarray(lens))
    np.testing.assert_allclose(_np(dirty), _np(ref), **ATTN_TOL)


def test_paged_decode_rows_are_independent():
    """Changing the other rows' lengths leaves a row bit-identical."""
    q, kp, vp, tables, lens = _paged_inputs(4, 6, 2, 32, 16, 4, "bf16", 2)
    a = paged_decode_attention(q[0], kp[0], vp[0], torch.from_numpy(tables),
                               torch.from_numpy(lens))
    lens2 = lens.copy()
    lens2[1:] = [3, 40, 64]
    b = paged_decode_attention(q[0], kp[0], vp[0], torch.from_numpy(tables),
                               torch.from_numpy(lens2))
    assert torch.equal(a[0], b[0])


def test_gather_kv_matches_reference():
    from repro.kernels.paged_attention.ref import gather_kv as jax_gather_kv
    rng = np.random.default_rng(3)
    pool = rng.normal(size=(9, 4, 2, 3)).astype(np.float32)
    tables = rng.integers(0, 9, size=(3, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        gather_kv(torch.from_numpy(pool), torch.from_numpy(tables)).numpy(),
        np.asarray(jax_gather_kv(jnp.asarray(pool), jnp.asarray(tables))))


# ---------------------------------------------------------------------------
# flash prefill attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,T,H,K,Dh,window,causal,dtype", [
    (1, 100, 100, 6, 2, 32, None, True, "f32"),    # S not a multiple of 128
    (2, 37, 37, 15, 5, 64, None, True, "bf16"),    # smollm-360m widths, odd S
    (1, 96, 96, 4, 2, 32, 40, True, "bf16"),       # sliding window
    (1, 48, 112, 4, 2, 32, None, True, "f32"),     # T > S (q_offset)
    (1, 48, 100, 4, 2, 32, None, False, "bf16"),   # non-causal, T unaligned
])
def test_flash_attention_matches_jax(B, S, T, H, K, Dh, window, causal, dtype):
    rng = np.random.default_rng(4)
    q = _pair(rng, (B, S, H, Dh), dtype)
    k = _pair(rng, (B, T, K, Dh), dtype)
    v = _pair(rng, (B, T, K, Dh), dtype)
    off = T - S if causal else 0
    out = flash_attention(q[0], k[0], v[0], causal=causal, window=window,
                          q_offset=off)
    assert out.dtype == q[0].dtype and out.shape == (B, S, H, Dh)
    ref = jax_flash(q[1], k[1], v[1], causal=causal, window=window,
                    q_offset=off)
    np.testing.assert_allclose(_np(out), _np(ref), **ATTN_TOL)
    oracle = attention_ref(q[1], k[1], v[1], causal=causal, window=window,
                           q_offset=off)
    np.testing.assert_allclose(_np(out), _np(oracle), **ATTN_TOL)


def test_flash_attention_fully_masked_rows_are_uniform():
    """With -1e30 masks a row that sees no key averages V instead of
    producing NaN (the Pallas body's behaviour, not the oracle's -inf)."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(1, 4, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 8, 1, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 8, 1, 16)).astype(np.float32))
    out = flash_attention_plain(q, k, v, causal=True, q_offset=-2)
    assert torch.isfinite(out).all()
    vb = v.to(torch.bfloat16).float()
    np.testing.assert_allclose(out[0, 0, 0].numpy(), vb[0, :, 0].mean(0).numpy(),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("Dh,width", [(16, 64), (20, 64), (32, 64), (64, 64),
                                      (100, 128), (128, 128), (256, 256)])
def test_flash_head_width_pads_up_to_an_instance(Dh, width):
    """The kernel is built for head widths 64, 128 and 256; the wrapper
    runs any other width on the next one up."""
    assert head_width(Dh) == width


@pytest.mark.parametrize("Dh", [0, 257, 512])
def test_flash_head_width_refuses_wider_than_256(Dh):
    with pytest.raises(ValueError, match="head width"):
        head_width(Dh)


@pytest.mark.parametrize("Dh,causal,window", [(16, True, None), (20, True, 9),
                                              (32, False, None),
                                              (100, True, None)])
def test_flash_zero_padded_heads_give_the_same_output(Dh, causal, window):
    """What the wrapper hands the kernel for a width that is not an
    instance: q, k and v zero-padded in Dh, with the scale of the real
    width.  The zero columns add exact zeros to Q.K and to the padded
    output columns, so the output is the unpadded one."""
    rng = np.random.default_rng(7)
    B, S, T, H, K = 2, 19, 23, 4, 2
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
               for sh in ((B, S, H, Dh), (B, T, K, Dh), (B, T, K, Dh)))
    kw = dict(causal=causal, window=window, q_offset=T - S)
    pad = head_width(Dh) - Dh
    got = _attention_plain(*(torch.nn.functional.pad(x, (0, pad))
                             for x in (q, k, v)),
                           1.0 / Dh ** 0.5, kw["causal"], kw["window"],
                           kw["q_offset"])
    assert not got[..., Dh:].any()
    torch.testing.assert_close(got[..., :Dh], flash_attention_plain(q, k, v,
                                                                    **kw),
                               rtol=1e-6, atol=1e-6)


def test_build_lists_every_kernel_source():
    """One CUDA C++ source per TPU kernel (RMSNorm's among them since it
    left Triton); the build compiles each on its own."""
    assert _build.sources() == ["decode_attention", "flash_prefill",
                                "grouped_matmul", "paged_decode",
                                "paged_verify", "rmsnorm", "ssd_scan"]


# ---------------------------------------------------------------------------
# the decode body's split plan, and the wrappers' launch path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [16, 64, 1000, 1024, 4096, 4160, 32768])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_split_plan_is_the_same_for_paged_and_dense(cap, bs):
    """A paged table of block size 8, 16 or 32 and a dense ring of the same
    capacity split alike (the kernels' bitwise pairs need one W), W a
    multiple of the body's chunk and of bs, and the splits cover the
    capacity with no split left empty."""
    from repro_torch.kernels.decode_attention.ops import CHUNK, split_plan
    cap = -(-cap // bs) * bs                     # a whole number of blocks
    W, n = split_plan(cap, bs)
    assert (W, n) == split_plan(cap)
    assert W % CHUNK == 0 and W % bs == 0
    assert n * W >= cap > (n - 1) * W


def test_split_plan_keeps_the_split_count_bounded():
    from repro_torch.kernels.decode_attention.ops import (
        MAX_SPLITS, SPLIT, split_plan)
    assert split_plan(1024, 16) == (SPLIT, 1024 // SPLIT)
    assert split_plan(1, 1) == (SPLIT, 1)
    for cap in (SPLIT * MAX_SPLITS, SPLIT * MAX_SPLITS + 1, 10 ** 6):
        assert split_plan(cap)[1] <= MAX_SPLITS
    with pytest.raises(ValueError):
        split_plan(0)


def test_split_buffers_size_the_workspace_and_keep_the_counters():
    """One launch's workspace holds (m, l, acc) of every (row, kv head,
    split, query row); none when one split covers the capacity.  The
    counters are zeros, kept per device, and grown without freeing the old
    ones (a captured CUDA graph may hold them)."""
    from repro_torch.kernels.decode_attention import ops
    dev = torch.device("cpu")
    ops._counters.pop(dev, None)
    ws, c = ops.split_buffers(dev, 8, 5, 8, 15, 64)
    assert ws.dtype == torch.float32 and ws.numel() == 8 * 5 * 8 * 15 * 66
    assert c.dtype == torch.int32 and c.numel() >= 40 and not c.any()
    assert ops.split_buffers(dev, 2, 1, 1, 3, 20)[0] is None
    assert ops.split_buffers(dev, 8, 5, 8, 3, 64)[1] is c
    _, big = ops.split_buffers(dev, 64, 40, 2, 3, 64)
    assert big.numel() >= 64 * 40 and ops._counters[dev][0] is c
    ops._counters.pop(dev)


OPS = sorted((Path(_build.__file__).parent).glob("*/ops.py"))


@pytest.mark.parametrize("path", OPS, ids=lambda p: p.parent.name)
def test_wrappers_take_the_short_launch_path(path):
    """Every kernel wrapper launches through `_build.call` (the stream's raw
    handle, a device switch only when the tensor is on another device),
    never building a stream object or entering torch.cuda.device per call."""
    src = path.read_text()
    assert "_build.call(" in src
    assert ".cuda_stream" not in src and "torch.cuda.device(" not in src


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 960), (3, 37, 60)])
@pytest.mark.parametrize("with_residual", [False, True])
def test_rmsnorm_matches_jax(shape, dtype, with_residual):
    rng = np.random.default_rng(6)
    x = _pair(rng, shape, dtype)
    res = _pair(rng, shape, dtype) if with_residual else (None, None)
    sc = torch.from_numpy(rng.normal(size=(shape[-1],)).astype(np.float32) * 0.1)
    o, r = rmsnorm_fused(x[0], sc, res[0])
    assert o.dtype == x[0].dtype and r.shape == x[0].shape
    jo, jr = jax_rmsnorm(x[1], jnp.asarray(sc.numpy()), res[1])
    np.testing.assert_allclose(_np(o), _np(jo), **NORM_TOL)
    np.testing.assert_allclose(_np(r), _np(jr), **NORM_TOL)
    ro, rr = rmsnorm_ref(x[1], jnp.asarray(sc.numpy()), residual=res[1])
    np.testing.assert_allclose(_np(o), _np(ro), **NORM_TOL)
    np.testing.assert_allclose(_np(r), _np(rr), **NORM_TOL)


# ---------------------------------------------------------------------------
# the wrappers' dispatch: plain only for CPU tensors, never a fallback
# ---------------------------------------------------------------------------

def test_cpu_path_launches_no_kernel():
    before = (paged_decode_attention.launches, flash_attention.launches,
              rmsnorm_fused.launches)
    q, kp, vp, tables, lens = _paged_inputs(2, 3, 1, 20, 16, 2, "bf16")
    paged_decode_attention(q[0], kp[0], vp[0], torch.from_numpy(tables),
                           torch.from_numpy(lens))
    x = torch.ones((2, 5, 3, 8), dtype=torch.bfloat16)
    flash_attention(x, x[:, :, :1].contiguous(), x[:, :, :1].contiguous())
    rmsnorm_fused(torch.ones((2, 8)), torch.zeros(8))
    assert (paged_decode_attention.launches, flash_attention.launches,
            rmsnorm_fused.launches) == before


@pytest.mark.parametrize("which", ["paged", "flash", "rmsnorm"])
def test_wrapper_refuses_devices_without_a_kernel(which):
    """A tensor on neither the CPU nor a CUDA card is refused, not quietly
    computed by the plain version."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        if which == "paged":
            paged_decode_attention(
                torch.empty((2, 3, 8), dtype=torch.bfloat16, **meta),
                torch.empty((4, 16, 1, 8), dtype=torch.bfloat16, **meta),
                torch.empty((4, 16, 1, 8), dtype=torch.bfloat16, **meta),
                torch.empty((2, 2), dtype=torch.int32, **meta),
                torch.empty((2,), dtype=torch.int32, **meta))
        elif which == "flash":
            x = torch.empty((1, 4, 2, 8), dtype=torch.bfloat16, **meta)
            flash_attention(x, x, x)
        else:
            rmsnorm_fused(torch.empty((2, 8), **meta),
                          torch.empty((8,), **meta))
