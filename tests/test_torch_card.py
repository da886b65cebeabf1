"""The port's hand-written kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA card (the CUDA kernels run
only there).  This file imports no JAX, so it runs on the
machine with the card as it is:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_card.py

Inputs are bf16 at the main paths' shapes (smollm-360m: 15 heads, 5 KV
heads, head dim 64, d_model 960; granite-moe-3b-a800m's experts: 40 of
1536 x 512, capacity 256 at the 1023-token admission and the ragged 136 at
512; mamba2-370m's SSD scan: 32 heads of 64, state 128, chunk 256 at the
1023-token admission); tolerances are those of tests/test_kernels.py:
attention rtol=5e-2, atol=2e-2; RMSNorm and grouped matmul 5e-2; SSD scan
1e-3 for f32 inputs, 6e-2 for bf16.  The kernels are also held at the
widths of gemma-2b (MQA at head width 256: flash at its 1023-token
admission, paged decode and verify at G = 8), starcoder2-3b (24 heads over
2 of 128: G = 12) and mixtral-8x7b (flash at its 8191-token admission with
a window of 4096; dense decode over its 4096-slot rings; its experts of
4096 x 14336 at capacity 2560), RMSNorm at D = 2048, minicpm3-4b
(MLA: flash at its 1023-token admission with every head its own KV head,
G = 1, at the q/k width 96 the wrapper pads to 128; RMSNorm at D = 2560),
jamba-v0.1-52b and llava-next-mistral-7b (flash at (1,1023,32/8,128);
jamba's 16 experts at capacity 160; its SSD scan at state 16 over 128
heads) and whisper-small (flash non-causal over its 1500 frames, S = T
in the encoder and S != T in the cross-attention; dense decode at G = 1
over its 448-slot cache).
The flash kernel is
also held at the smoke widths the wrapper pads, and one raw Q.K^T tile of
it against torch; the grouped matmul at
every capacity bucket and with its wgmma in the SASS; the SSD scan with
tensor-core instructions in its SASS; every kernel is also captured in one
CUDA graph and replayed.  The serve engine's decode step, captured as a
CUDA graph, is held bitwise to the eager step at smoke widths (paged,
dense, mamba2, mixtral's rolling rings, minicpm3's latent pools and
rings, jamba's paged and dense hybrid stacks, and llava text only), its replays to their launch counts, and a chunked
admission beside a decoding slot to its idle-engine run; so are the
engine's other graphs (the admission prefill of each bucket, the chunk
function of each chunk length, the draft chain and verify step) and the
decode image's step, each against its eager run; one pilot binds
two smoke serve images in turn, each bitwise its direct engine; three
pilots serve one pool's requests, one killed, bitwise the direct engine; a
decode-role engine imports prefill-role handoffs into its graphed step
bitwise a unified engine, and a disaggregated fleet with one pilot of each
stage killed replays bitwise the direct engine.
The train step on the card is held to the same step on the CPU (loss,
norm, every gradient leaf) with no kernel launched, its captured CUDA
graph to the eager step (smollm-360m under both remat policies,
granite-moe-3b-a800m, mamba2-370m, a compression transform, a second
batch shape, ``train_direct``), every kernel wrapper
refuses a CUDA input that requires grad, and a pilot's train payload
resumes from its checkpoint after a node failure.  The verify and dense
decode kernels share the paged decode kernel's body and split plan, so
they are also held to it bitwise, at lengths on the edges of its
sequence splits too.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_plain)
from repro_torch.kernels.grouped_matmul.ops import (
    bucket_matmul, grouped_matmul, grouped_matmul_plain)
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_decode_attention_plain,
    paged_verify_attention, paged_verify_attention_plain)
from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused, rmsnorm_plain
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain

pytestmark = pytest.mark.gpu

ATTN_TOL = dict(rtol=5e-2, atol=2e-2)
NORM_TOL = dict(rtol=5e-2, atol=5e-2)
GMM_TOL = dict(rtol=5e-2, atol=5e-2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _bf16(rng, shape, dev):
    return (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(dev, torch.bfloat16))


# gemma-2b (G = 8 at head width 256) and starcoder2-3b (G = 12) beside
# smollm's heads and the smoke widths
@pytest.mark.parametrize("H,K,Dh", [(15, 5, 64), (3, 1, 20), (8, 1, 256),
                                    (24, 2, 128)])
def test_paged_decode_kernel_matches_plain(card, H, K, Dh):
    """Ragged lengths (1 and mb*bs among them), a free slot over the
    scratch block 0, and NaN in every pool row no valid position reads."""
    rng = np.random.default_rng(0)
    B, bs, mb = 8, 16, 64
    nb = B * mb + 1
    tables = rng.permutation(np.arange(1, nb)).reshape(B, mb).astype(np.int32)
    tables[2] = 0
    lens = np.array([1, mb * bs, 37, 500, 17, 16, 333, 900], np.int32)
    read = np.zeros((nb, bs), bool)
    for b in range(B):
        p = np.arange(lens[b])
        read[tables[b, p // bs], p % bs] = True
    kp, vp = _bf16(rng, (nb, bs, K, Dh), card), _bf16(rng, (nb, bs, K, Dh), card)
    unread = torch.from_numpy(~read).to(card)
    kp[unread] = float("nan")
    vp[unread] = float("nan")
    args = (_bf16(rng, (B, H, Dh), card), kp, vp,
            torch.from_numpy(tables).to(card), torch.from_numpy(lens).to(card))
    before = paged_decode_attention.launches
    out = paged_decode_attention(*args)
    assert paged_decode_attention.launches == before + 1
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(),
                               paged_decode_attention_plain(*args).float(),
                               **ATTN_TOL)


@pytest.mark.parametrize("B,S,T,H,K,Dh,window,causal", [
    (1, 1023, 1023, 15, 5, 64, None, True),   # the longest admission bucket
    (1, 100, 100, 15, 5, 64, None, True),     # S not a multiple of the tile
    (1, 48, 112, 15, 5, 64, 40, True),        # q_offset = 64, sliding window
    (1, 48, 100, 15, 5, 64, None, False),     # non-causal, T unaligned
    (1, 1, 1, 15, 5, 64, None, True),         # one token
    (1, 65, 65, 15, 5, 64, None, True),       # one row past a tile
    (2, 300, 300, 15, 5, 64, None, True),     # two prompts
    (1, 1023, 1023, 24, 8, 64, None, True),   # granite's heads
    (1, 300, 300, 16, 4, 128, None, True),    # Dh = 128
    (1, 200, 200, 8, 1, 256, None, True),     # Dh = 256, MQA (gemma)
    (1, 130, 130, 8, 1, 256, 50, True),       # Dh = 256 with a window
    (1, 1023, 1023, 8, 1, 256, None, True),   # gemma-2b's 1023 admission
    (1, 16, 16, 8, 1, 256, None, True),       # gemma-2b's 16-bucket one
    (1, 1023, 1023, 24, 2, 128, None, True),  # starcoder2-3b's
    (1, 8191, 8191, 32, 8, 128, 4096, True),  # mixtral-8x7b's, window 4096
    (1, 1023, 1023, 40, 40, 96, None, True),  # minicpm3-4b's: G = 1, Dh 96
    (1, 1023, 1023, 32, 8, 128, None, True),  # jamba's and llava's 1023
    (8, 1500, 1500, 12, 12, 64, None, False),  # whisper's encoder: S = T
    (8, 4, 1500, 12, 12, 64, None, False),    # its cross-attention, S != T
    (2, 100, 1500, 12, 12, 64, None, False),  # a longer prompt over frames
    (1, 37, 37, 3, 1, 20, None, True),        # smoke widths, padded to 64
    (1, 70, 70, 4, 2, 100, None, True),       # padded to 128
])
def test_flash_kernel_matches_plain(card, B, S, T, H, K, Dh, window, causal):
    rng = np.random.default_rng(1)
    q = _bf16(rng, (B, S, H, Dh), card)
    k, v = _bf16(rng, (B, T, K, Dh), card), _bf16(rng, (B, T, K, Dh), card)
    kw = dict(causal=causal, window=window, q_offset=T - S if causal else 0)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape and torch.isfinite(got.float()).all()
    G = H // K
    for kh in range(K):         # the plain version a KV head at a time
        hs = slice(kh * G, (kh + 1) * G)
        want = flash_attention_plain(q[:, :, hs], k[:, :, kh:kh + 1],
                                     v[:, :, kh:kh + 1], **kw)
        torch.testing.assert_close(got[:, :, hs].float(), want.float(),
                                   **ATTN_TOL)


@pytest.mark.parametrize("S,T", [(64, 64), (128, 64), (100, 100)])
def test_flash_qk_tile_matches_torch(card, S, T):
    """The raw f32 Q.K^T accumulator of the first 64-key tile (TMA with the
    128-byte swizzle, wgmma descriptors), before any softmax: products of
    bf16 values are exact in f32, so only the summation order differs."""
    from repro_torch.kernels import _build
    rng = np.random.default_rng(10)
    q, k = _bf16(rng, (1, S, 1, 64), card), _bf16(rng, (1, T, 1, 64), card)
    out = torch.full((S, 64), float("nan"), device=card)
    fn = _build.entry("flash_prefill", "flash_prefill_qk_tile_bf16", 3, 2,
                      scale=False)
    _build.check("flash_prefill", fn(q.data_ptr(), k.data_ptr(),
                                     out.data_ptr(), S, T,
                                     torch.cuda.current_stream().cuda_stream),
                 "qk tile")
    torch.cuda.synchronize()
    kt = torch.zeros((64, 64), device=card)
    kt[:min(T, 64)] = k[0, :64, 0].float()
    want = q[0, :, 0].float() @ kt.T
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("D", [60, 960, 1536, 4096, 2048, 2560])
@pytest.mark.parametrize("R", [1, 8, 1023])
@pytest.mark.parametrize("with_residual", [False, True])
def test_rmsnorm_kernel_matches_plain(card, R, D, with_residual):
    rng = np.random.default_rng(2)
    x = _bf16(rng, (R, D), card)
    r = _bf16(rng, (R, D), card) if with_residual else None
    sc = torch.from_numpy(rng.normal(size=(D,)).astype(np.float32) * 0.1).to(card)
    before = rmsnorm_fused.launches
    got = rmsnorm_fused(x, sc, r)
    assert rmsnorm_fused.launches == before + 1
    for g, want in zip(got, rmsnorm_plain(x, sc, r)):
        assert g.shape == x.shape and g.dtype == x.dtype
        torch.testing.assert_close(g.float(), want.float(), **NORM_TOL)


def test_kernels_replay_in_a_cuda_graph(card):
    """Flash prefill, RMSNorm, the grouped matmul, the three decode entries
    and the SSD scan captured in one CUDA graph (no per-call host work the
    capture cannot hold; the decode body's split workspace and counters
    and the scan's chunk-state workspace replay with it) and replayed give
    the eager results on new inputs."""
    rng = np.random.default_rng(11)
    q = _bf16(rng, (1, 300, 15, 64), card)
    k, v = _bf16(rng, (1, 300, 5, 64), card), _bf16(rng, (1, 300, 5, 64), card)
    x, r = _bf16(rng, (8, 960), card), _bf16(rng, (8, 960), card)
    sc = torch.from_numpy(rng.normal(size=(960,)).astype(np.float32)).to(card)
    bk = _bf16(rng, (40, 72, 1536), card)
    w = _bf16(rng, (40, 1536, 512), card) * 1536 ** -0.5
    B, bs, mb, T = 8, 16, 64, 1024
    nb = B * mb + 1
    tables = torch.from_numpy(rng.permutation(np.arange(1, nb)).reshape(
        B, mb).astype(np.int32)).to(card)
    kp, vp = _bf16(rng, (nb, bs, 5, 64), card), _bf16(rng, (nb, bs, 5, 64), card)
    kc, vc = _bf16(rng, (B, T, 5, 64), card), _bf16(rng, (B, T, 5, 64), card)
    lens = torch.tensor([1, 1024, 129, 500, 17, 128, 333, 900],
                        dtype=torch.int32, device=card)
    qd, qv = _bf16(rng, (B, 15, 64), card), _bf16(rng, (B, 5, 15, 64), card)
    scan = _ssd_inputs(rng, card, 1, 300, 32, 64, 1, 128, torch.bfloat16)

    def step():
        return (flash_attention(q, k, v), *rmsnorm_fused(x, sc, r),
                bucket_matmul(bk, w),
                paged_decode_attention(qd, kp, vp, tables, lens),
                paged_verify_attention(qv, kp, vp, tables, lens - 1),
                decode_attention(qd, kc, vc, lens),
                *ssd_scan(*scan, chunk=256))

    eager = step()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    for t in (q, x, bk, qd, qv, scan[0]):    # new inputs, same buffers
        t.copy_(_bf16(rng, t.shape, card))
    lens.copy_(torch.tensor([1024, 1, 700, 128, 129, 255, 64, 1000],
                            dtype=torch.int32, device=card))
    graph.replay()
    torch.cuda.synchronize()
    fresh = step()
    for i, (a, b) in enumerate(zip(captured, fresh)):
        assert torch.equal(a, b), i
    for i, (a, b) in enumerate(zip(captured, eager)):
        assert not torch.equal(a, b), i


def _pool_with_nan(rng, dev, tables, reach, nb, bs, K, Dh):
    """Pools with NaN in every row no query reads (reach[b] positions of
    row b are read)."""
    read = np.zeros((nb, bs), bool)
    for b, n in enumerate(reach):
        p = np.arange(n)
        read[tables[b, p // bs], p % bs] = True
    kp, vp = _bf16(rng, (nb, bs, K, Dh), dev), _bf16(rng, (nb, bs, K, Dh), dev)
    unread = torch.from_numpy(~read).to(dev)
    kp[unread] = float("nan")
    vp[unread] = float("nan")
    return kp, vp


@pytest.mark.parametrize("H,K,Dh", [(15, 5, 64), (3, 1, 20), (8, 1, 256),
                                    (24, 2, 128)])
def test_paged_verify_kernel_matches_plain_and_decode(card, H, K, Dh):
    """S = 5 queries per row at ragged offsets, one of them overflowing the
    table (q_off = mb*bs - 2), a free slot over the scratch block: within
    tolerance of the plain version, and query s bitwise the paged decode
    kernel at cache_len = min(q_off + s + 1, mb*bs)."""
    rng = np.random.default_rng(3)
    B, S, bs, mb = 8, 5, 16, 64
    T, nb = mb * bs, B * mb + 1
    tables = rng.permutation(np.arange(1, nb)).reshape(B, mb).astype(np.int32)
    tables[2] = 0
    off = np.array([0, T - 2, 37, 500, 17, 15, 333, 900], np.int32)
    kp, vp = _pool_with_nan(rng, card, tables, np.minimum(off + S, T), nb,
                            bs, K, Dh)
    q = _bf16(rng, (B, S, H, Dh), card)
    tb, qo = torch.from_numpy(tables).to(card), torch.from_numpy(off).to(card)
    before = paged_verify_attention.launches
    out = paged_verify_attention(q, kp, vp, tb, qo)
    assert paged_verify_attention.launches == before + 1
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(
        out.float(), paged_verify_attention_plain(q, kp, vp, tb, qo).float(),
        **ATTN_TOL)
    for s in range(S):
        one = paged_decode_attention(q[:, s].contiguous(), kp, vp, tb,
                                     torch.clamp(qo + s + 1, max=T))
        assert torch.equal(out[:, s], one), s


@pytest.mark.parametrize("H,K,Dh", [(15, 5, 64), (3, 1, 20)])
def test_decode_attention_kernel_matches_plain_and_paged(card, H, K, Dh):
    """Dense rings (B, T, K, Dh) with ragged lengths 1..T and NaN past
    them: within tolerance of the plain version, and bitwise the paged
    decode kernel over the same rows scattered into a permuted pool."""
    rng = np.random.default_rng(4)
    B, bs, mb = 8, 16, 64
    T, nb = mb * bs, B * mb + 1
    lens = np.array([1, T, 37, 500, 17, 16, 333, 900], np.int32)
    kc, vc = _bf16(rng, (B, T, K, Dh), card), _bf16(rng, (B, T, K, Dh), card)
    past = torch.arange(T, device=card)[None] >= torch.from_numpy(lens).to(
        card)[:, None]
    kc[past] = float("nan")
    vc[past] = float("nan")
    q = _bf16(rng, (B, H, Dh), card)
    ln = torch.from_numpy(lens).to(card)
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, ln)
    assert decode_attention.launches == before + 1
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(
        out.float(), decode_attention_plain(q, kc, vc, ln).float(), **ATTN_TOL)
    tables = torch.from_numpy(rng.permutation(np.arange(1, nb)).reshape(
        B, mb).astype(np.int32)).to(card)
    pools = []
    for c in (kc, vc):
        pool = torch.zeros((nb, bs, K, Dh), dtype=torch.bfloat16, device=card)
        pool[tables.reshape(-1).long()] = c.reshape(B * mb, bs, K, Dh)
        pools.append(pool)
    assert torch.equal(out, paged_decode_attention(q, *pools, tables, ln))


@pytest.mark.parametrize("lens", [(4, 1), (64, 37)])
@pytest.mark.parametrize("H,K,Dh", [(15, 5, 64), (8, 1, 256)])
def test_decode_attention_kernel_at_the_examples_shapes(card, H, K, Dh, lens):
    """The examples' decode images (2 rows over 64 positions) at
    smollm-360m's and gemma-2b's heads: within tolerance of the plain
    version, and bitwise the paged decode kernel over the same rows."""
    rng = np.random.default_rng(5)
    B, T, bs = 2, 64, 16
    mb, nb = T // bs, B * T // bs + 1
    ln = torch.tensor(lens, dtype=torch.int32, device=card)
    kc, vc = _bf16(rng, (B, T, K, Dh), card), _bf16(rng, (B, T, K, Dh), card)
    past = torch.arange(T, device=card)[None] >= ln[:, None]
    kc[past] = float("nan")
    vc[past] = float("nan")
    q = _bf16(rng, (B, H, Dh), card)
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, ln)
    assert decode_attention.launches == before + 1
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(
        out.float(), decode_attention_plain(q, kc, vc, ln).float(), **ATTN_TOL)
    tables = torch.from_numpy(rng.permutation(np.arange(1, nb)).reshape(
        B, mb).astype(np.int32)).to(card)
    pools = []
    for c in (kc, vc):
        pool = torch.zeros((nb, bs, K, Dh), dtype=torch.bfloat16, device=card)
        pool[tables.reshape(-1).long()] = c.reshape(B * mb, bs, K, Dh)
        pools.append(pool)
    assert torch.equal(out, paged_decode_attention(q, *pools, tables, ln))


def test_decode_attention_kernel_at_g1(card):
    """whisper-small's decoder self-attention: 12 heads over 12 KV heads
    (G = 1) of width 64 against its 448-slot dense cache, ragged lengths
    and NaN past them: within tolerance of the plain version."""
    rng = np.random.default_rng(14)
    B, T, H, Dh = 8, 448, 12, 64
    lens = np.array([1, 4, 5, 64, 128, 200, 447, 448], np.int32)
    kc, vc = _bf16(rng, (B, T, H, Dh), card), _bf16(rng, (B, T, H, Dh), card)
    past = torch.arange(T, device=card)[None] >= torch.from_numpy(lens).to(
        card)[:, None]
    kc[past] = float("nan")
    vc[past] = float("nan")
    q = _bf16(rng, (B, H, Dh), card)
    ln = torch.from_numpy(lens).to(card)
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, ln)
    assert decode_attention.launches == before + 1
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(
        out.float(), decode_attention_plain(q, kc, vc, ln).float(), **ATTN_TOL)


def test_decode_attention_kernel_on_a_window_ring(card):
    """mixtral-8x7b's decode: 32 heads over 8 KV heads of 128 on its
    4096-slot rolling rings, lengths up to the full ring (a row whose
    decode has crossed the window reads all 4096 slots): within tolerance
    of the plain version, and bitwise the paged decode kernel on the same
    rows (the same split plan at capacity 4096)."""
    rng = np.random.default_rng(14)
    B, T, H, K, Dh, bs = 8, 4096, 32, 8, 128, 16
    mb, nb = T // bs, B * T // bs + 1
    lens = np.array([T, 1, 4095, 2048, T, 129, 4000, 64], np.int32)
    kc, vc = _bf16(rng, (B, T, K, Dh), card), _bf16(rng, (B, T, K, Dh), card)
    ln = torch.from_numpy(lens).to(card)
    past = torch.arange(T, device=card)[None] >= ln[:, None]
    kc[past] = float("nan")
    vc[past] = float("nan")
    q = _bf16(rng, (B, H, Dh), card)
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, ln)
    assert decode_attention.launches == before + 1
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(
        out.float(), decode_attention_plain(q, kc, vc, ln).float(), **ATTN_TOL)
    tables = torch.from_numpy(rng.permutation(np.arange(1, nb)).reshape(
        B, mb).astype(np.int32)).to(card)
    pools = []
    for c in (kc, vc):
        pool = torch.zeros((nb, bs, K, Dh), dtype=torch.bfloat16, device=card)
        pool[tables.reshape(-1).long()] = c.reshape(B * mb, bs, K, Dh)
        pools.append(pool)
    assert torch.equal(out, paged_decode_attention(q, *pools, tables, ln))


def _split_width():
    from repro_torch.kernels.decode_attention.ops import split_plan
    return split_plan(1024, 16)[0]


@pytest.mark.parametrize("H,K", [(15, 5), (24, 8)])
def test_decode_entries_at_split_edges_are_bitwise_paged(card, H, K):
    """Lengths on the edges of the decode body's sequence splits (1, W - 1,
    W, W + 1, 2W + 1, the capacity) with NaN past them: the dense entry
    within tolerance of its plain version and bitwise the paged decode of
    the same rows, at smollm's and granite's head counts."""
    rng = np.random.default_rng(12)
    W = _split_width()
    B, bs, mb, Dh = 8, 16, 64, 64
    T, nb = mb * bs, B * mb + 1
    lens = np.array([1, W - 1, W, W + 1, 2 * W + 1, T, T - 1, 3 * W],
                    np.int32)
    kc, vc = _bf16(rng, (B, T, K, Dh), card), _bf16(rng, (B, T, K, Dh), card)
    ln = torch.from_numpy(lens).to(card)
    past = torch.arange(T, device=card)[None] >= ln[:, None]
    kc[past] = float("nan")
    vc[past] = float("nan")
    q = _bf16(rng, (B, H, Dh), card)
    out = decode_attention(q, kc, vc, ln)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(
        out.float(), decode_attention_plain(q, kc, vc, ln).float(), **ATTN_TOL)
    # a second launch merges again (its counters were reset) to the same bits
    assert torch.equal(out, decode_attention(q, kc, vc, ln))
    tables = torch.from_numpy(rng.permutation(np.arange(1, nb)).reshape(
        B, mb).astype(np.int32)).to(card)
    pools = []
    for c in (kc, vc):
        pool = torch.full((nb, bs, K, Dh), float("nan"), dtype=torch.bfloat16,
                          device=card)
        pool[tables.reshape(-1).long()] = c.reshape(B * mb, bs, K, Dh)
        pools.append(pool)
    assert torch.equal(out, paged_decode_attention(q, *pools, tables, ln))


@pytest.mark.parametrize("H,K", [(15, 5), (24, 8)])
def test_verify_staircases_across_splits_are_bitwise_decode(card, H, K):
    """Verify offsets whose S = 5 frontiers cross a split, and the rows at
    1022 and 1023 that reach past the table: query s bitwise the paged
    decode at min(q_off + s + 1, mb*bs), NaN in every unread pool row."""
    rng = np.random.default_rng(13)
    W = _split_width()
    B, S, bs, mb, Dh = 8, 5, 16, 64, 64
    T, nb = mb * bs, B * mb + 1
    tables = rng.permutation(np.arange(1, nb)).reshape(B, mb).astype(np.int32)
    off = np.array([W - 3, W - 1, 2 * W - 2, T - 2, T - 1, 0, W, 3 * W - 4],
                   np.int32)
    kp, vp = _pool_with_nan(rng, card, tables, np.minimum(off + S, T), nb,
                            bs, K, Dh)
    q = _bf16(rng, (B, S, H, Dh), card)
    tb, qo = torch.from_numpy(tables).to(card), torch.from_numpy(off).to(card)
    out = paged_verify_attention(q, kp, vp, tb, qo)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(
        out.float(), paged_verify_attention_plain(q, kp, vp, tb, qo).float(),
        **ATTN_TOL)
    assert torch.equal(out, paged_verify_attention(q, kp, vp, tb, qo))
    for s in range(S):
        one = paged_decode_attention(q[:, s].contiguous(), kp, vp, tb,
                                     torch.clamp(qo + s + 1, max=T))
        assert torch.equal(out[:, s], one), s


@pytest.mark.parametrize("D,F", [
    (1536, 512),           # up/gate
    (512, 1536),           # down
])
@pytest.mark.parametrize("C", [
    256,                   # the 1023-token admission
    136, 72, 40, 24,       # the 512 ... 64 buckets: C not a multiple of the
])                         # tile height, below it from 72 on
def test_grouped_matmul_kernel_matches_plain(card, C, D, F):
    """granite-moe's capacity buckets (40 experts), one launch."""
    rng = np.random.default_rng(5)
    E = 40
    b = _bf16(rng, (E, C, D), card)
    w = _bf16(rng, (E, D, F), card) * D ** -0.5
    before = grouped_matmul.launches
    got = bucket_matmul(b, w)
    assert grouped_matmul.launches == before + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    want = grouped_matmul_plain(b.reshape(E * C, D), w, [C] * E)
    torch.testing.assert_close(got, want.reshape(E, C, F), **GMM_TOL)


@pytest.mark.parametrize("D,F", [(4096, 14336), (14336, 4096)])
def test_grouped_matmul_kernel_at_mixtral_widths(card, D, F):
    """mixtral-8x7b's experts (8 of 4096 x 14336) at the capacity of its
    8191-token admission, C = 2560: up/gate and down, one launch each."""
    rng = np.random.default_rng(15)
    E, C = 8, 2560
    b = _bf16(rng, (E, C, D), card)
    w = _bf16(rng, (E, D, F), card) * D ** -0.5
    before = grouped_matmul.launches
    got = bucket_matmul(b, w)
    assert grouped_matmul.launches == before + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    want = grouped_matmul_plain(b.reshape(E * C, D), w, [C] * E)
    torch.testing.assert_close(got, want.reshape(E, C, F), **GMM_TOL)


@pytest.mark.parametrize("D,F", [(4096, 14336), (14336, 4096)])
def test_grouped_matmul_kernel_at_jamba_widths(card, D, F):
    """jamba-v0.1-52b's experts (16 of 4096 x 14336, top 2) at the
    capacity of its 1023-token admission, C = 160: up/gate and down, one
    launch each."""
    rng = np.random.default_rng(16)
    E, C = 16, 160
    b = _bf16(rng, (E, C, D), card)
    w = _bf16(rng, (E, D, F), card) * D ** -0.5
    before = grouped_matmul.launches
    got = bucket_matmul(b, w)
    assert grouped_matmul.launches == before + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    want = grouped_matmul_plain(b.reshape(E * C, D), w, [C] * E)
    torch.testing.assert_close(got, want.reshape(E, C, F), **GMM_TOL)


@pytest.mark.parametrize("E,D,F,sizes,tail", [
    (3, 96, 96, (0, 64, 32), 32),                  # empty group
    (40, 1536, 512, "ragged", 100),                # granite, ragged sizes
    (40, 512, 1536, "ragged", 131),                # granite's down
    (2, 96, 96, (130, 0), 0),                      # a group over 128 rows
])
def test_grouped_matmul_kernel_ragged_groups(card, E, D, F, sizes, tail):
    """Ragged group sizes (empty groups among them) and tail rows owned by
    no group: the kernel writes the tail as 0 without reading it (NaN
    there), and the groups within tolerance of the plain version."""
    rng = np.random.default_rng(6)
    if sizes == "ragged":
        sizes = rng.integers(0, 300, size=E)
        sizes[[3, 17]] = 0
    sizes = np.asarray(sizes, np.int32)
    n = int(sizes.sum())
    x = _bf16(rng, (n + tail, D), card)
    x[n:] = float("nan")
    w = _bf16(rng, (E, D, F), card) * D ** -0.5
    gs = torch.from_numpy(sizes).to(card)
    got = grouped_matmul(x, w, gs)
    assert torch.isfinite(got).all() and not got[n:].any()
    torch.testing.assert_close(got, grouped_matmul_plain(x, w, gs), **GMM_TOL)


def test_grouped_matmul_runs_on_wgmma(card):
    """The grouped-matmul library's SASS holds HGMMA (wgmma), not only the
    mma.sync (HMMA) fallback."""
    import re
    import shutil
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        pytest.skip("needs cuobjdump from the CUDA toolkit")
    _build.library("grouped_matmul")
    sass = subprocess.run([tool, "-sass", str(_build._target("grouped_matmul"))],
                          capture_output=True, text=True, check=True).stdout
    assert re.search(r"\bHGMMA\b", sass)


def test_router_runs_in_full_f32_when_tf32_is_on(card):
    """The MoE router product stays full f32 on the card even where the
    caller turned TF32 on (TF32 moves the probabilities by up to ~1e-3
    relative, enough to reorder close experts), and the caller's setting
    comes back."""
    from repro_torch.models.moe import router_probs
    rng = np.random.default_rng(7)
    x = _bf16(rng, (1023, 1536), card)
    w = torch.from_numpy(rng.normal(size=(1536, 40)).astype(np.float32)
                         * 1536 ** -0.5).to(card)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = router_probs(x, w)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    want = torch.softmax(x.double().cpu() @ w.double().cpu(), dim=-1)
    torch.testing.assert_close(got.double().cpu(), want, rtol=1e-5,
                               atol=1e-9)


def _ssd_inputs(rng, dev, b, S, H, P, G, N, dtype):
    """The reference sweep's recipe (tests/test_kernels.py): dt after a
    softplus, A = -exp(0.5 n), B and C scaled by 0.3."""
    def n(shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                * scale).to(dev)
    return (n((b, S, H, P)).to(dtype),
            torch.nn.functional.softplus(n((b, S, H))),
            -torch.exp(n((H,), 0.5)), n((b, S, G, N), 0.3).to(dtype),
            n((b, S, G, N), 0.3).to(dtype))


@pytest.mark.parametrize("b,S,H,P,G,N,chunk,dtype", [
    (1, 1023, 32, 64, 1, 128, 256, torch.bfloat16),  # the 1023 admission
    (2, 1023, 32, 64, 1, 128, 256, torch.bfloat16),  # two rows
    (1, 1023, 32, 64, 2, 128, 256, torch.bfloat16),  # two groups, full width
    (1, 257, 32, 64, 1, 128, 256, torch.bfloat16),   # a one-row last chunk
    (1, 512, 32, 64, 1, 128, 256, torch.bfloat16),   # the 512 bucket
    (1, 128, 32, 64, 1, 128, 256, torch.bfloat16),   # chunk 128 (S = 128)
    (1, 64, 32, 64, 1, 128, 256, torch.bfloat16),    # chunk 64
    (1, 32, 32, 64, 1, 128, 256, torch.bfloat16),    # chunk 32
    (1, 100, 4, 32, 1, 64, 32, torch.bfloat16),      # padded: 4 chunks of 32
    (1, 1023, 128, 64, 1, 16, 256, torch.bfloat16),  # jamba: N = 16, 128 heads
    (1, 300, 128, 64, 1, 16, 256, torch.float32),
    (1, 300, 4, 96, 2, 40, 256, torch.bfloat16),     # two P panels, N = 40
    (1, 300, 4, 96, 2, 40, 256, torch.float32),
    (1, 192, 8, 32, 2, 64, 64, torch.bfloat16),      # grouped B/C
    (2, 256, 4, 64, 1, 128, 64, torch.float32),      # the reference sweep
    (1, 192, 8, 32, 2, 64, 64, torch.float32),
    (2, 128, 2, 64, 1, 128, 128, torch.float32),
    (1, 100, 4, 32, 1, 64, 32, torch.float32),
])
def test_ssd_scan_kernel_matches_plain(card, b, S, H, P, G, N, chunk, dtype):
    """The SSD-scan kernel against its plain version (chunk by chunk, the
    same masked-decay math in f32), y and the final state."""
    rng = np.random.default_rng(8)
    args = _ssd_inputs(rng, card, b, S, H, P, G, N, dtype)
    before = ssd_scan.launches
    y, st = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    yw, sw = ssd_scan_plain(*args, chunk=chunk)
    tol = 1e-3 if dtype == torch.float32 else 6e-2
    torch.testing.assert_close(y.float(), yw.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(st, sw, rtol=tol, atol=tol)


def test_ssd_scan_runs_on_tensor_cores(card):
    """The SSD-scan library's SASS holds tensor-core products (HMMA from
    mma.sync, or HGMMA), not only f32 FMAs."""
    import re
    import shutil
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        pytest.skip("needs cuobjdump from the CUDA toolkit")
    _build.library("ssd_scan")
    sass = subprocess.run([tool, "-sass", str(_build._target("ssd_scan"))],
                          capture_output=True, text=True, check=True).stdout
    assert re.search(r"\bHG?MMA\b", sass)


@pytest.mark.parametrize("S", [1023, 512, 64])
def test_ssd_scan_heads_per_cta_agree(card, S):
    """The scan's last phase with one or two heads of a group a CTA (two
    share each C.B^T tile), whichever the kernel would choose at this
    size: the same operations in the same order, so the same bits, within
    the bf16 tolerance of the plain version."""
    from repro_torch.kernels.ssd_scan import ops
    rng = np.random.default_rng(12)
    args = _ssd_inputs(rng, card, 1, S, 32, 64, 1, 128, torch.bfloat16)
    (y1, st1), (y2, st2) = (ops._launch(*args, 256, heads=h) for h in (1, 2))
    assert torch.equal(y1, y2) and torch.equal(st1, st2)
    yw, sw = ssd_scan_plain(*args, chunk=256)
    torch.testing.assert_close(y1.float(), yw.float(), rtol=6e-2, atol=6e-2)
    torch.testing.assert_close(st1, sw, rtol=6e-2, atol=6e-2)


def test_ssd_scan_kernel_writes_y_in_x_dtype(card):
    """On the kernel path y comes back in x's dtype (bf16 on the serve
    path; the mixer then casts it to f32 before the D skip, as the
    reference's kernel path does) and the state in f32, shaped (b,H,N,P)."""
    rng = np.random.default_rng(9)
    args = _ssd_inputs(rng, card, 2, 40, 4, 16, 1, 16, torch.bfloat16)
    y, st = ssd_scan(*args, chunk=32)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 40, 4, 16)
    assert st.dtype == torch.float32 and st.shape == (2, 4, 16, 16)


# ---------------------------------------------------------------------------
# the engine's decode step as a captured CUDA graph, and chunked admission
# ---------------------------------------------------------------------------

def _smoke_engine(arch, kv, max_len=64, **kw):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.serve import build_engine
    return build_engine(get_smoke_config(arch), 2, max_len, kv=kv,
                        device="cuda", **kw)


def _drive(eng, ticks=20):
    """Requests arriving and finishing between steps: an admission at ticks
    0, 3 and 9 (the last into the slot that request 0's eviction freed),
    then the engine runs dry.  Returns {rid: tokens}."""
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(0)
    plan = {0: (0, 9, 6), 3: (1, 30, 12), 9: (2, 5, 8)}
    for t in range(ticks):
        if t in plan:
            rid, plen, budget = plan[t]
            eng.submit(Request(rid, rng.integers(0, 512, size=plen)
                               .astype(np.int32), max_new_tokens=budget))
        eng.step()
    eng.run()
    return {rid: r.tokens for rid, r in sorted(eng.done.items())}


@pytest.mark.parametrize("arch,kv", [("smollm-360m", "paged"),
                                     ("smollm-360m", "dense"),
                                     ("mamba2-370m", "dense"),
                                     ("minicpm3-4b", "paged"),
                                     ("minicpm3-4b", "dense")])
def test_graphed_step_equals_eager_step(card, arch, kv):
    """Twenty ticks of the replayed graph, with admissions and an eviction
    between replays, give the eager step's streams bitwise, with one
    device->host copy a step (minicpm3-4b: MLA's latent pools and rings,
    written in place)."""
    graphed = _smoke_engine(arch, kv)
    eager = _smoke_engine(arch, kv, step_graph=False)
    assert graphed._graph is not None and eager._graph is None
    got, want = _drive(graphed), _drive(eager)
    assert got == want and sorted(got) == [0, 1, 2]
    assert graphed.d2h_transfers == graphed.steps == eager.steps


@pytest.mark.parametrize("arch,kv", [("jamba-v0.1-52b", "paged"),
                                     ("jamba-v0.1-52b", "dense"),
                                     ("llava-next-mistral-7b", "paged")])
def test_graphed_step_equals_eager_on_the_last_families(card, arch, kv):
    """The hybrid (its attention slot paged or dense, its SSM rows written
    in place by the captured step) and the VLM served text only: the
    replayed graph's streams are the eager step's, bitwise."""
    graphed = _smoke_engine(arch, kv)
    eager = _smoke_engine(arch, kv, step_graph=False)
    assert graphed._graph is not None and graphed.kv == kv
    got, want = _drive(graphed), _drive(eager)
    assert got == want and sorted(got) == [0, 1, 2]
    assert graphed.d2h_transfers == graphed.steps == eager.steps


def test_graphed_step_equals_eager_on_a_rolling_ring(card):
    """mixtral-8x7b's smoke config (window 64) at max_len 256: a rolling
    admission (100 tokens, bucket 128) and one whose decode crosses the
    window (60 tokens, bucket 64), then a third into the freed slot.  The
    captured step writes the rings in place at ``pos mod 64``: its streams
    are the eager step's, bitwise."""
    from repro_torch.serving.engine import Request
    streams = []
    for graph in (None, False):
        eng = _smoke_engine("mixtral-8x7b", None, max_len=256,
                            step_graph=graph)
        assert eng.kv == "dense" and (eng._graph is None) == (graph is False)
        assert eng.state["cache"][0]["k"].shape[2] == 64
        rng = np.random.default_rng(0)
        for rid, (n, budget) in enumerate(((100, 24), (60, 30), (9, 12))):
            eng.submit(Request(rid, rng.integers(0, 512, size=n)
                               .astype(np.int32), max_new_tokens=budget))
        stats = eng.run()
        assert stats["completed"] == 3
        assert stats["d2h_transfers"] == stats["decode_steps"]
        streams.append({rid: r.tokens for rid, r in eng.done.items()})
    assert streams[0] == streams[1]


def test_graph_replay_counts_its_launches(card):
    """Each replay adds the launches its capture recorded: one paged decode
    a layer and 2 * layers + 1 RMSNorms a step, and nothing for the
    capture itself."""
    from repro_torch.serving.engine import Request
    eng = _smoke_engine("smollm-360m", "paged")
    layers = eng.cfg.num_layers
    per_step = {w.__name__: n for w, n in eng._graph.launches.items()}
    assert per_step == {"paged_decode_attention": layers,
                        "rmsnorm_fused": 2 * layers + 1}
    assert eng._graph.warm_launches["paged_decode_attention"] == 3 * layers
    eng.submit(Request(0, np.arange(1, 12, dtype=np.int32),
                       max_new_tokens=8))
    eng.step()                                  # admission and a replay
    ws = list(eng._graph.launches)
    before = [w.launches for w in ws]
    for _ in range(3):
        eng.step()
    assert [w.launches - n for w, n in zip(ws, before)] == \
        [3 * eng._graph.launches[w] for w in ws]


@pytest.mark.parametrize("arch,kv", [("smollm-360m", "paged"),
                                     ("mamba2-370m", "dense"),
                                     ("minicpm3-4b", "paged")])
def test_chunked_admission_on_card_matches_idle_engine(card, arch, kv):
    """A request admitted chunk by chunk while another slot decodes
    (graphed) gives its idle-engine tokens bitwise."""
    from repro_torch.serving.engine import Request

    def req(rid, plen, budget):
        prompt = np.random.default_rng(rid).integers(0, 512, size=plen)
        return Request(rid, prompt.astype(np.int32), max_new_tokens=budget)
    kw = dict(prefill="chunked", prefill_chunk=16)
    solo = _smoke_engine(arch, kv, **kw)
    solo.submit(req(1, 30, 3))
    solo.run()
    eng = _smoke_engine(arch, kv, **kw)
    for r in (req(0, 20, 12), req(1, 30, 3), req(2, 7, 4)):
        eng.submit(r)
    stats = eng.run()
    assert stats["completed"] == 3 and stats["prefill_chunks"] == 5
    assert stats["step_graph"] and stats["d2h_transfers"] == stats["decode_steps"]
    assert eng.done[1].tokens == solo.done[1].tokens
    assert eng.block_leaks() == 0


def _net_launches(eng):
    """The engine's kernel launches less its graphs' throwaway warm-up
    steps (the decode step's and the spec pair's)."""
    warm = eng._stats(0, 0.0)["graph_warm_launches"]
    net = {k: n - warm.get(k, 0) for k, n in eng.launches.items()}
    return {k: n for k, n in net.items() if n}


@pytest.mark.parametrize("arch,kv,prefill", [
    ("smollm-360m", "paged", "oneshot"), ("smollm-360m", "paged", "chunked"),
    ("smollm-360m", "dense", "chunked"), ("granite-moe-3b-a800m", "paged",
                                          "oneshot"),
    ("mamba2-370m", "dense", "oneshot"), ("mamba2-370m", "dense", "chunked"),
    ("minicpm3-4b", "paged", "chunked"), ("mixtral-8x7b", None, "chunked"),
    ("jamba-v0.1-52b", "paged", "chunked")])
def test_graphed_admission_equals_eager(card, arch, kv, prefill):
    """The admission prefill's graph of each bucket and the chunk
    function's of each chunk length (slot and offset as device scalars)
    replay the eager admission bitwise: `_drive`'s streams equal, the
    graphs captured, and the same kernel launches once the decode step's
    warm-up steps are taken off."""
    kw = dict(prefill=prefill, prefill_chunk=16)
    graphed = _smoke_engine(arch, kv, **kw)
    eager = _smoke_engine(arch, kv, step_graph=False, **kw)
    got, want = _drive(graphed), _drive(eager)
    assert got == want and sorted(got) == [0, 1, 2]
    st = graphed._stats(0, 0.0)
    if graphed.prefill_mode == "chunked":
        assert st["chunk_graph"] and not st["prefill_graph"], st
    else:
        assert st["prefill_graph"] and not st["chunk_graph"], st
    assert st["graph_pool_bytes"] > 0, st["graph_pool_bytes"]
    assert not any(eager._admit_graphs.values())
    # the one-shot graphs write into one shared output
    if graphed.prefill_mode != "chunked":
        assert graphed._admit_out["prefill"].ref is not None
    assert _net_launches(graphed) == _net_launches(eager)


@pytest.mark.parametrize("draft", ["self", "cold"])
def test_graphed_spec_pair_equals_eager(card, draft):
    """The draft chain's and the verify step's graphs, captured at
    construction, replay the eager spec step bitwise: streams, acceptance,
    the same launches net of their warm-up steps; the draft cache keeps its
    tensors."""
    import dataclasses
    from repro_torch.configs.base import get_smoke_config
    cfg = get_smoke_config("smollm-360m")
    kw = dict(spec="draft", spec_k=3,
              draft_cfg=(None if draft == "self"
                         else dataclasses.replace(cfg, num_layers=1)))
    graphed = _smoke_engine("smollm-360m", "paged", **kw)
    eager = _smoke_engine("smollm-360m", "paged", step_graph=False, **kw)
    assert graphed._spec_graphs is not None and graphed._graph is None
    ptrs = [t.data_ptr() for leaf in graphed._draft_cache
            for t in leaf.values()]
    got, want = _drive(graphed), _drive(eager)
    assert got == want and sorted(got) == [0, 1, 2]
    assert graphed.spec_accepted == eager.spec_accepted
    assert graphed.spec_drafted == eager.spec_drafted > 0
    assert (graphed.spec_accepted > 0) == (draft == "self")
    assert ptrs == [t.data_ptr() for leaf in graphed._draft_cache
                    for t in leaf.values()]
    assert graphed.draft_time_s > 0
    assert _net_launches(graphed) == _net_launches(eager)


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-small"])
def test_graphed_decode_image_step_equals_eager(card, arch):
    """The decode image's step, captured per state at its first call:
    six steps of two states from one function, interleaved, give the eager
    step's logits and tokens bitwise, each state returned as given and
    holding its own graph."""
    import dataclasses
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.serve import KERNEL_FLAGS
    from repro_torch.launch.steps import GRAPH_KEY, make_serve_step
    from repro_torch.models.api import build_model, init_decode_state
    cfg = dataclasses.replace(get_smoke_config(arch), **dict(KERNEL_FLAGS))
    params = build_model(cfg).init(0, device="cuda")
    graphed, eager = make_serve_step(cfg), make_serve_step(cfg, False)

    def state(seed):
        st = init_decode_state(cfg, 2, 64, kv="dense", device="cuda")
        st["token"].copy_(torch.randint(0, 500, (2, 1), generator=(
            torch.Generator("cuda").manual_seed(seed)), device="cuda",
            dtype=torch.int32))
        return st
    runs = {k: [state(0), state(1)] for k in ("graphed", "eager")}
    for _ in range(6):
        for i in range(2):
            g, gst = graphed(params, runs["graphed"][i])
            e, est = eager(params, runs["eager"][i])
            assert gst is runs["graphed"][i] and est is runs["eager"][i]
            assert torch.equal(g, e)
    for i in range(2):
        assert torch.equal(runs["graphed"][i]["token"],
                           runs["eager"][i]["token"])
        assert GRAPH_KEY not in runs["eager"][i]
    assert (runs["graphed"][0][GRAPH_KEY][1]
            is not runs["graphed"][1][GRAPH_KEY][1])


# ---------------------------------------------------------------------------
# the pilot system on the card
# ---------------------------------------------------------------------------

def test_pilot_binds_serve_images_on_the_card(card):
    """One pilot late-binds two smoke serve images in turn on the card, the
    second prefetched while the first serves: both payloads replay their
    captured step and give the direct engine's streams bitwise, and each
    engine counts only its own kernel launches."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.serve import (
        make_trace, serve_direct, serve_via_pilots)
    archs = ["smollm-360m", "mamba2-370m"]
    traces = [make_trace(512, 6, max_len=64, seed=0) for _ in archs]
    out = serve_via_pilots(archs, slots=2, max_len=64, smoke=True,
                           device="cuda", traces=traces, idle_grace=0.5)
    assert out["drained"] and out["registry"]["prefetches"] == 1
    assert out["pilot"].history[1]["bind_cached"] is True
    for arch, p in zip(archs, out["payloads"]):
        assert p["exitcode"] == 0, p["error"]
        assert p["engine"]["step_graph"] and p["engine"]["block_leaks"] == 0
        direct = serve_direct(get_smoke_config(arch), 6, 2, 64,
                              device="cuda")
        assert {int(r): t for r, t in p["tokens"].items()} == \
            direct["streams"], arch
    smollm, mamba = (p["engine"]["launches"] for p in out["payloads"])
    assert smollm["flash_attention"] == 6 * 2      # 6 admissions x 2 layers
    assert "ssd_scan" not in smollm and "flash_attention" not in mamba
    assert mamba["ssd_scan"] == 6 * get_smoke_config(archs[1]).num_layers


def test_fleet_requeues_a_dead_servers_requests_on_the_card(card):
    """Three pilots lease one pool's requests on the card, each server a
    smoke engine replaying its captured step; the pilot holding the most
    leases is killed after 2 settled requests.  Every request completes
    once, its tokens bitwise ``serve_direct``'s on the card, and every
    surviving server returns each KV block."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.serve import serve_direct, serve_fleet
    out = serve_fleet("smollm-360m", 10, 3, slots=2, max_len=64, fail_at=2,
                      smoke=True, device="cuda")
    assert out["drained"] and out["completed"] == 10
    assert len(out["failed_pilots"]) == 1 and out["replays"] >= 1
    assert sorted(out["results"]) == list(range(10))
    direct = serve_direct(get_smoke_config("smollm-360m"), 10, 2, 64,
                          device="cuda")
    assert out["results"] == direct["streams"]
    done = [s for s in out["servers"] if s["serve"].get("fleet")]
    assert done
    for s in done:
        assert s["exitcode"] == 0 and s["engine"]["step_graph"], s["error"]
        assert s["serve"]["fleet"]["leaked_blocks"] == 0


@pytest.mark.parametrize("arch", ["smollm-360m", "minicpm3-4b"])
def test_decode_role_imports_into_its_graph_on_the_card(card, arch):
    """A prefill-role engine (no step, no graph) exports each request's
    blocks; a decode-role engine imports them in place and replays its
    captured step: streams bitwise a unified graphed engine's (a rebound
    pool would leave the graph reading stale addresses)."""
    from repro_torch.serving.engine import Request
    uni = _smoke_engine(arch, "paged")
    pf = _smoke_engine(arch, "paged", role="prefill")
    dc = _smoke_engine(arch, "paged", role="decode")
    assert pf._graph is None and dc._graph is not None
    rng = np.random.default_rng(3)
    reqs = [(rid, rng.integers(0, 512, size=int(rng.integers(4, 40)))
             .astype(np.int32), int(rng.integers(4, 12))) for rid in range(5)]
    for rid, prompt, mnt in reqs:
        uni.submit(Request(rid, prompt, max_new_tokens=mnt))
        pf.submit(Request(rid, prompt, max_new_tokens=mnt))
    uni.run()
    pf.run()
    for rid, prompt, mnt in reqs:
        dc.submit(Request(rid, prompt, max_new_tokens=mnt,
                          handoff=pf.done[rid].handoff))
    dc.run()
    assert {r: dc.done[r].tokens for r, _, _ in reqs} == \
        {r: uni.done[r].tokens for r, _, _ in reqs}
    assert pf.block_leaks() == 0 == dc.block_leaks()
    assert dc.handoffs_imported == pf.prefills_exported == len(reqs)


def test_disagg_fleet_replays_on_the_card(card):
    """Two prefill-role and two decode-role pilots on the card, one of
    each killed: every request completes once, bitwise ``serve_direct``'s,
    and every surviving server returns each KV block."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.serve import serve_direct, serve_disagg
    out = serve_disagg("smollm-360m", 10, prefill_pilots=2, decode_pilots=2,
                       slots=2, max_len=64, fail_prefill_at=2,
                       fail_decode_at=4, lease_ttl=1.0, smoke=True,
                       device="cuda")
    assert out["drained"] and sorted(out["results"]) == list(range(10))
    direct = serve_direct(get_smoke_config("smollm-360m"), 10, 2, 64,
                          device="cuda")
    assert out["results"] == direct["streams"]
    assert out["leaked_blocks"] == 0
    for s in out["servers"]["decode"]:
        if s["serve"].get("fleet"):
            assert s["exitcode"] == 0 and s["engine"]["step_graph"]


# ---------------------------------------------------------------------------
# the training payload on the card
# ---------------------------------------------------------------------------

_WRAPPERS = (flash_attention, paged_decode_attention, paged_verify_attention,
             decode_attention, rmsnorm_fused, grouped_matmul, ssd_scan)


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m",
                                  "mamba2-370m"])
def test_train_step_on_the_card_matches_the_cpu(card, arch):
    """One train step of the smoke config on the card and on the CPU from
    the same f32 state: loss within 2e-3, grad norm within 2 %, every
    gradient leaf within 5e-2 relative (bf16 products in other orders, as
    tests/test_torch_train.py holds the CPU to JAX), and no kernel launched
    (the train path is the plain one)."""
    from repro_torch import tree
    from repro_torch.bridge import train_state_from_numpy, train_state_to_numpy
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM, to_device
    from repro_torch.launch.steps import init_train_state, make_train_step
    cfg = get_smoke_config(arch)
    cpu = init_train_state(cfg, 0, "cpu")
    gpu = train_state_from_numpy(train_state_to_numpy(cpu), cfg, card)
    batch = SyntheticLM(SyntheticConfig(cfg.vocab_size, 64, 2)).batch_at(0)
    step = make_train_step(cfg)
    for w in _WRAPPERS:
        w.launches = 0
    _, mg = step(gpu, to_device(batch, card))
    _, mc = step(cpu, to_device(batch, "cpu"))
    assert all(w.launches == 0 for w in _WRAPPERS)
    assert abs(float(mg["loss"]) - float(mc["loss"])) < 2e-3
    np.testing.assert_allclose(float(mg["grad_norm"]), float(mc["grad_norm"]),
                               rtol=2e-2)
    for pg, pc in zip(tree.leaves(gpu["params"].live()),
                      tree.leaves(cpu["params"].live())):
        g, c = pg.grad.float().cpu(), pc.grad
        assert torch.isfinite(g).all()
        assert float((g - c).norm() / c.norm().clamp_min(1e-30)) < 5e-2


# The graphed train step against the eager one (``chip_smoke.py``'s
# ``train_graph_parity`` rule, at smoke widths): from a state S1, two eager
# steps on one batch give the eager step's own spread (the card's backward
# accumulates with atomics); a state whose step was captured from S (its
# first call) and then restored to S1 in place replays one step.  Its loss
# is bitwise the eager step's wherever the two eager runs agree bitwise;
# its grad norm and every leaf of the state after the update are no
# farther from the first eager run than the second is, plus f32 rounding.
GRAPH_PARITY_ATOL = 1e-6


def _train_runs(cfg, compress=False):
    """A function of ``graph`` -> (a fresh train state of seed 0 on the
    card, the leaves it carries beside its state, its step).  With
    ``compress`` the step's ``grad_transform`` is int8 compression whose
    residuals the closure writes in place."""
    from repro_torch import tree
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim.adamw import OptimConfig
    from repro_torch.runtime import compression
    oc = OptimConfig(warmup_steps=2, total_steps=20, peak_lr=1e-2)

    def fresh(graph):
        state = init_train_state(cfg, 0, "cuda")
        transform, extra = None, []
        if compress:
            res = compression.init_residuals(state["params"].live())
            extra = tree.leaves(res)

            def transform(grads):
                out, new = compression.compress(grads, res)
                for r, n in zip(extra, tree.leaves(new), strict=True):
                    r.copy_(n)
                return out
        return state, extra, make_train_step(
            cfg, oc, grad_transform=transform, step_graph=graph)
    return fresh


def _snap(state, extra):
    from repro_torch import tree
    from repro_torch.launch.steps import state_tree
    return [t.detach().clone().float()
            for t in tree.leaves(state_tree(state)) + list(extra)]


def _restore(state, extra, snap):
    from repro_torch import tree
    from repro_torch.launch.steps import load_train_state, state_tree
    n = len(tree.leaves(state_tree(state)))
    load_train_state(state, tree.unflatten(state_tree(state), snap[:n]))
    with torch.no_grad():
        for dst, src in zip(extra, snap[n:], strict=True):
            dst.copy_(src)


def _graph_parity(cfg, batches, compress=False):
    """The rule above on ``batches`` (S -> S1 on the first, the compared
    step on the second); returns the replay's metrics."""
    from repro_torch.launch.steps import GRAPH_KEY
    fresh = _train_runs(cfg, compress)
    state, extra, eager = fresh(False)
    eager(state, batches[0])
    s1 = _snap(state, extra)
    ms, snaps = [], []
    for _ in range(2):
        _restore(state, extra, s1)
        _, m = eager(state, batches[1])
        ms.append({k: float(v) for k, v in m.items()})
        snaps.append(_snap(state, extra))
    assert GRAPH_KEY not in state
    del state, extra, eager
    state, extra, graphed = fresh(True)
    graphed(state, batches[0])                   # step 0, then the capture
    assert GRAPH_KEY in state
    _restore(state, extra, s1)
    _, m = graphed(state, batches[1])            # a replay from S1
    got = {k: float(v) for k, v in m.items()}
    a, b = ms
    if a["loss"] == b["loss"]:
        assert got["loss"] == a["loss"]
    else:
        assert abs(got["loss"] - a["loss"]) <= abs(a["loss"] - b["loss"])
    assert abs(got["grad_norm"] - a["grad_norm"]) <= (
        abs(a["grad_norm"] - b["grad_norm"]) + 1e-6 * a["grad_norm"])
    assert got["lr"] == a["lr"]
    for g, x, y in zip(_snap(state, extra), snaps[0], snaps[1], strict=True):
        spread = float((x - y).abs().max())
        assert float((g - x).abs().max()) <= spread + GRAPH_PARITY_ATOL
    return got


def _smoke_batches(cfg, shapes=((2, 64), (2, 64))):
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM, to_device
    return [to_device(SyntheticLM(SyntheticConfig(cfg.vocab_size, s, b))
                      .batch_at(i), "cuda")
            for i, (b, s) in enumerate(shapes)]


@pytest.mark.parametrize("arch,remat", [
    ("smollm-360m", "full"), ("smollm-360m", "dots"),
    ("granite-moe-3b-a800m", "full"), ("mamba2-370m", "full")])
def test_graphed_train_step_replays_the_eager_step(card, arch, remat):
    """The train step captured as a CUDA graph (forward, backward under
    ``remat``, AdamW) replays the eager step by the parity rule above, a
    restore after the capture included, and launches no kernel."""
    import dataclasses
    from repro_torch.configs.base import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    for w in _WRAPPERS:
        w.launches = 0
    got = _graph_parity(cfg, _smoke_batches(cfg))
    assert np.isfinite(got["loss"])
    assert all(w.launches == 0 for w in _WRAPPERS)


def test_graphed_train_step_with_a_compression_transform(card):
    """A ``grad_transform`` closure (int8 compression) that writes its
    residuals in place replays, graphed, the eager step by the same rule,
    the residuals among the compared leaves."""
    from repro_torch.configs.base import get_smoke_config
    cfg = get_smoke_config("smollm-360m")
    _graph_parity(cfg, _smoke_batches(cfg), compress=True)


def test_train_graph_captures_again_for_another_batch_shape(card):
    """A batch of another shape captures again and replaces the state's
    graph, as a jit compiles again; a batch of the held shape replays.
    Each step starts from the eager run's state, restored in place, so
    each loss (the forward before the update) is bitwise the eager
    step's."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.steps import held_graph
    cfg = get_smoke_config("smollm-360m")
    shapes = [(2, 64), (2, 64), (4, 32), (4, 32), (4, 32), (2, 64), (2, 64)]
    batches = _smoke_batches(cfg, shapes)
    fresh = _train_runs(cfg)
    (e, e_extra, eager), (g, g_extra, graphed) = fresh(False), fresh(True)
    graphs = []
    for batch in batches:
        _restore(g, g_extra, _snap(e, e_extra))
        _, mg = graphed(g, batch)
        _, me = eager(e, batch)
        assert float(mg["loss"]) == float(me["loss"])
        graphs.append(held_graph(g))
    assert all(x is not None for x in graphs)
    same = [graphs[i] is graphs[i - 1] for i in range(1, len(graphs))]
    assert same == [True, False, True, True, False, True]
    assert graphs[5] is not graphs[0]


def test_train_direct_replays_its_graph_on_the_card(card):
    """``train_direct`` on the card captures its step at the first call,
    reports ``step_graph`` and the graph's pool, and launches no kernel;
    ``step_graph=False`` keeps the step eager."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.train import train_direct
    cfg = get_smoke_config("smollm-360m")
    for w in _WRAPPERS:
        w.launches = 0
    out = train_direct(cfg, 4, 2, 64, device=card)
    assert all(w.launches == 0 for w in _WRAPPERS)
    assert out["step_graph"] is True and out["graph_pool_bytes"] > 0
    assert out["capture_s"] == out["step_seconds"][0]
    assert np.isfinite(out["losses"]).all()
    eager = train_direct(cfg, 4, 2, 64, device=card, step_graph=False)
    assert eager["step_graph"] is False and eager["graph_pool_bytes"] == 0
    # step 0 is the eager step in both runs
    assert out["losses"][0] == eager["losses"][0]


def test_kernel_wrappers_refuse_grad_on_the_card(card):
    q = torch.zeros((1, 16, 4, 64), device=card, dtype=torch.bfloat16,
                    requires_grad=True)
    kv = torch.zeros((1, 16, 2, 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="no VJP"):
        flash_attention(q, kv, kv)
    x = torch.zeros((4, 64), device=card, dtype=torch.bfloat16)
    scale = torch.zeros(64, device=card, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no VJP"):
        rmsnorm_fused(x, scale)
    with torch.no_grad():
        flash_attention(q, kv, kv)
        rmsnorm_fused(x, scale)


def test_pilot_train_payload_resumes_on_the_card(card, tmp_path):
    """A smoke train payload on the card checkpoints, loses its node once
    step 2 is on disk, and a replacement pilot resumes it from the last
    checkpoint the killed payload wrote."""
    from repro_torch.launch.train import train_via_pilots
    out = train_via_pilots("smollm-360m", True, 6, ckpt=str(tmp_path / "ck"),
                           device="cuda", ckpt_every=2, fail_after_ckpt=2)
    res, fail = out["result"], out["failure"]
    assert res is not None and res.exitcode == 0
    assert res.pilot_id != fail["pilot"]
    assert res.telemetry["resumed_from"] == fail["ckpt_step"] >= 2
    assert res.telemetry["steps"] == 6 - fail["ckpt_step"]
    assert np.isfinite(res.telemetry["last_loss"])
    # the killed payload and the resumed one each replayed a graph
    assert fail["step_graph"] is True and res.telemetry["step_graph"] is True


def test_serve_cell_bytes_match_an_engine_on_the_card(card):
    """The dry run's serve accounting (`run_serve_cell` at the engine's
    bf16 layout) against the parameter and KV pool tensors a smoke
    smollm-360m engine holds on the card: equal bytes."""
    from repro_torch import tree
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.dryrun import run_serve_cell
    from repro_torch.launch.serve import build_engine
    eng = build_engine(get_smoke_config("smollm-360m"), 2, 64, seed=0,
                       device=card)
    pred = run_serve_cell("smollm-360m", smoke=True, slots=2, max_len=64,
                          param_dtype=torch.bfloat16, whole=())
    params = tree.leaves(eng.params.tree())
    pools = [t for leaf in eng.state["cache"] for t in leaf.values()]
    assert all(t.is_cuda for t in params + pools)
    assert sum(t.numel() * t.element_size() for t in params) == (
        pred["params_bytes"]) == pred["params_bytes_per_rank"][0]
    assert sum(t.numel() * t.element_size() for t in pools) == (
        pred["kv_pool_bytes"])
