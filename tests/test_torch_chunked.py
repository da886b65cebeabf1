"""The port's chunked-prefill admission and ``attn_impl="causal_blocked"``
against the JAX package, and the chunked engine's invariants inside the
port.

Inputs are made with numpy from a seed and handed to both packages; model
and layer parameters are the reference's own (``jax.random`` keys),
bridged.  Both sides run ``attn_impl="pallas"``, ``norm_impl="pallas"``
(and ``ssm_impl="pallas"`` for mamba2-370m): the JAX RMSNorm kernel in
Pallas interpret mode, the port's wrappers on their plain versions (CPU
tensors).  The chunk attend is plain on both sides, as in the reference.

Tolerances, and why:

* Cache writes (`_paged_write_chunk`, `_ring_write_chunk_row`): bitwise,
  they move values.
* `_chunk_attend`, `causal_blocked_attention`: rtol 5e-2, atol 2e-2, those
  of tests/test_kernels.py and tests/test_models_math.py for attention
  (bf16 operands, f32 sums in another order, bf16 out).
* Layer outputs and model logits: rtol = atol = 1e-2, that of
  tests/test_torch_model.py (bf16 activations rounded at the same points,
  summed in other orders); K/V pools 2e-2 (one bf16 ulp at |x| ~ 4); the
  SSM state rows 1e-2 (tests/test_torch_ssm.py).
* Inside the port: streams bitwise.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro.models.api import build_model as jax_build
from repro.models.api import init_decode_state as jax_state
from repro.serving.engine import prefill_chunk_shapes as jax_chunk_shapes
from repro_torch.bridge import F32_LEAVES, params_from_numpy
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.api import build_model, init_decode_state
from repro_torch.serving.engine import (
    Request, ServeEngine, admit_buckets, prefill_chunk_shapes)

ATTN_TOL = dict(rtol=5e-2, atol=2e-2)
TOL = dict(rtol=1e-2, atol=1e-2)
POOL_TOL = dict(rtol=2e-2, atol=2e-2)
KERNELS = dict(attn_impl="pallas", norm_impl="pallas", ssm_impl="pallas")
SMOLLM, GRANITE, MAMBA = "smollm-360m", "granite-moe-3b-a800m", "mamba2-370m"
MLA, SWA, HYBRID = "minicpm3-4b", "mixtral-8x7b", "jamba-v0.1-52b"
# a window the test's 45-token prompt wraps
_ARCH_KW = {SWA: dict(sliding_window=16)}
# jamba's chain runs at f32 compute and f32 matrices on both sides, as
# tests/test_torch_hybrid.py holds its chunk chain's cache leaves: in bf16
# its eight layers (seven SSM mixers, two MoE FFNs) round apart further
_F32 = {HYBRID}


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(arch, **kw):
    kw = {**KERNELS, **kw}
    return (dataclasses.replace(get_smoke_config(arch), **kw),
            dataclasses.replace(jax_smoke(arch), **kw))


def _bf16_pair(rng, shape, scale=1.0):
    """The same bf16 values as a torch tensor and a jax array."""
    t = torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
    t = t.to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _layer_params(tree):
    """A layer's reference parameters on the CPU as the bridge stores
    them: bf16 matrices, f32 leaves kept f32."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k in F32_LEAVES else torch.bfloat16)
        for k, v in tree.items()}


_MODELS: dict = {}


def _model(arch, **kw):
    """(cfg, jcfg, port params, jax params) of ``arch``'s smoke config
    with the reference's weights from key 0, built once per config."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        cfg, jcfg = _cfgs(arch, **kw)
        jparams = jax_build(jcfg).init(jax.random.key(0))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
        _MODELS[key] = (cfg, jcfg, params, jparams)
    return _MODELS[key]


# ---------------------------------------------------------------------------
# the chunk helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("off,C", [(0, 16), (20, 12), (40, 30)])
def test_paged_write_chunk_matches_jax(off, C):
    """Positions map through the row's table with the (p // bs) % mb
    wrap; the rows land bitwise where the reference puts them."""
    rng = np.random.default_rng(off)
    nb, bs, mb, K, Dh = 9, 8, 4, 2, 8
    pool, jpool = _bf16_pair(rng, (nb, bs, K, Dh))
    new, jnew = _bf16_pair(rng, (C, K, Dh))
    row = np.array([5, 2, 7, 3], np.int32)
    positions = off + np.arange(C)
    got = attn._paged_write_chunk(pool.clone(), new, torch.from_numpy(row),
                                  torch.from_numpy(positions))
    want = jattn._paged_write_chunk(jpool, jnew, jnp.asarray(row),
                                    jnp.asarray(positions))
    np.testing.assert_array_equal(_f(got), _f(want))


@pytest.mark.parametrize("W,C,off", [(16, 8, 0), (16, 8, 12), (8, 20, 5),
                                     (16, 16, 30)])
def test_ring_write_chunk_row_matches_jax(W, C, off):
    """C < W, C > W, and offsets that wrap the ring."""
    rng = np.random.default_rng(W + C + off)
    row, jrow = _bf16_pair(rng, (W, 2, 8))
    chunk, jchunk = _bf16_pair(rng, (C, 2, 8))
    got = attn._ring_write_chunk_row(row, chunk, off)
    want = jattn._ring_write_chunk_row(jrow, jchunk, off)
    np.testing.assert_array_equal(_f(got), _f(want))


@pytest.mark.parametrize("case", ["causal", "negative_positions", "window"])
def test_chunk_attend_matches_jax(case):
    rng = np.random.default_rng(3)
    C, T, H, K, Dh = 8, 24, 4, 2, 16
    q, jq = _bf16_pair(rng, (1, C, H, Dh))
    k, jk = _bf16_pair(rng, (1, T, K, Dh))
    v, jv = _bf16_pair(rng, (1, T, K, Dh))
    q_pos = np.arange(C) + 16
    t_pos, window = None, None
    if case != "causal":
        t_pos = np.arange(T) - 4                 # four ring slots before 0
    if case == "window":
        window = 10
    got = attn._chunk_attend(
        q, k, v, torch.from_numpy(q_pos),
        None if t_pos is None else torch.from_numpy(t_pos), window)
    want = jattn._chunk_attend(
        jq, jk, jv, jnp.asarray(q_pos),
        None if t_pos is None else jnp.asarray(t_pos), window)
    np.testing.assert_allclose(_f(got), _f(want), **ATTN_TOL)


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_attention_prefill_chunk_matches_jax(kv):
    """Three chunks (16, 16, 13 tokens) of one row chained through the
    layer: each chunk's output, and the cache after them (the row's
    blocks or its ring row; every other row and block untouched)."""
    cfg, jcfg = _cfgs(SMOLLM)
    jp = jattn.init_attention(jax.random.key(1), jcfg)
    p = _layer_params(jax.tree.map(np.asarray, jp))
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    B, T, bs, slot = 2, 48, 16, 1
    nb = B * (T // bs) + 1
    shape = (nb, bs, K, Dh) if kv == "paged" else (B, T, K, Dh)
    names = ("kp", "vp") if kv == "paged" else ("k", "v")
    cache = {n: torch.zeros(shape, dtype=torch.bfloat16) for n in names}
    jcache = {n: jnp.zeros(shape, jnp.bfloat16) for n in names}
    row = np.array([4, 1, 6], np.int32)
    rng = np.random.default_rng(5)
    off = 0
    for C in (16, 16, 13):
        x, jx = _bf16_pair(rng, (1, C, cfg.d_model))
        out, _ = attn.attention_prefill_chunk(
            x, p, cfg, cache, torch.from_numpy(row), slot, off)
        jout, jcache = jattn.attention_prefill_chunk(
            jx, jp, jcfg, jcache, jnp.asarray(row), jnp.int32(slot),
            jnp.int32(off))
        np.testing.assert_allclose(_f(out), _f(jout), **TOL)
        off += C
    for n in names:
        np.testing.assert_allclose(_f(cache[n]), _f(jcache[n]), **POOL_TOL)
    if kv == "dense":
        assert not cache["k"][0].any()           # the other row untouched


@pytest.mark.parametrize("C", [1, 7])
def test_ssm_prefill_chunk_row_matches_jax(C):
    """A chunk through one row of an SSM layer from that row's nonzero
    state: the outputs and the row's {conv, ssd} after it; the other row
    is untouched, bitwise."""
    cfg, jcfg = _cfgs(MAMBA)
    jp = jssm.init_ssm(jax.random.key(2), jcfg)
    p = _layer_params(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(C)
    conv, jconv = _bf16_pair(rng, (2,) + tuple(
        ssm.init_ssm_cache(cfg, 1)["conv"].shape[1:]), 0.5)
    ssd_np = (rng.normal(size=tuple(ssm.init_ssm_cache(cfg, 2)["ssd"].shape))
              * 0.1).astype(np.float32)
    cache = {"conv": conv, "ssd": torch.from_numpy(ssd_np.copy())}
    jcache = {"conv": jconv, "ssd": jnp.asarray(ssd_np)}
    other = {k: v[0].clone() for k, v in cache.items()}
    x, jx = _bf16_pair(rng, (1, C, cfg.d_model))
    out, _ = ssm.ssm_prefill_chunk_row(x, p, cfg, cache, 1)
    jout, jcache = jssm.ssm_prefill_chunk_row(jx, jp, jcfg, jcache,
                                              jnp.int32(1))
    np.testing.assert_allclose(_f(out), _f(jout), **TOL)
    for k in ("conv", "ssd"):
        np.testing.assert_allclose(_f(cache[k][1]), _f(jcache[k][1]), **TOL)
        assert torch.equal(cache[k][0], other[k])


# ---------------------------------------------------------------------------
# the model: lm_prefill_chunk chained over a prompt
# ---------------------------------------------------------------------------

def _chunks_int_and_tensor(chunk_fn, params, cfg, state, prompt, row, slot):
    """The chunks (16, 16, 13) of ``prompt`` into row ``slot`` of ``state``
    with ``slot`` and ``q_offset`` as ints, then into a copy of the state
    as they started with both as 0-d int32 tensors (a captured chunk's
    static inputs).  Asserts the two bitwise equal, chunk for chunk and
    leaf for leaf; returns the int form's logits."""
    twin = {**state, "cache": [{k: v.clone() for k, v in leaf.items()}
                               for leaf in state["cache"]]}
    got = {"int": [], "tensor": []}
    for form, st in (("int", state), ("tensor", twin)):
        off = 0
        for C in (16, 16, 13):
            toks = torch.from_numpy(prompt[None, off:off + C])
            s, o = slot, off
            if form == "tensor":
                s = torch.tensor(slot, dtype=torch.int32)
                o = torch.tensor(off, dtype=torch.int32)
            logits, _ = chunk_fn(params, st, toks, torch.from_numpy(row),
                                 s, o)
            got[form].append(logits)
            off += C
    for a, b in zip(got["int"], got["tensor"]):
        assert torch.equal(a, b)
    for leaf, tleaf in zip(state["cache"], twin["cache"]):
        for k, v in leaf.items():
            assert torch.equal(v, tleaf[k]), k
    return got["int"]


@pytest.mark.parametrize("arch,kv", [(SMOLLM, "paged"), (SMOLLM, "dense"),
                                     (GRANITE, "paged"), (MAMBA, "dense"),
                                     (MLA, "paged"), (SWA, "dense"),
                                     (HYBRID, "paged")])
def test_lm_prefill_chunk_chained_matches_jax(arch, kv):
    """Every chunk of a 45-token prompt (16, 16, 13) into row 1 of a
    2-slot state: each chunk's last-position logits and, after the last,
    every cache leaf.  ``slot`` and ``q_offset`` as 0-d int32 tensors give
    the int form's logits and cache bitwise.  minicpm3-4b runs MLA's
    latent pools, mixtral-8x7b its ring at a window of 16 (the prompt
    wraps it twice), jamba its hybrid stack (SSM rows and a paged
    attention slot, at f32 compute)."""
    cfg, jcfg, params, jparams = _model(arch, **_ARCH_KW.get(arch, {}))
    compute, jcompute = torch.bfloat16, jnp.bfloat16
    if arch in _F32:
        compute, jcompute = torch.float32, jnp.float32
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu", matrix_dtype=compute)
    slots, max_len, bs, slot = 2, 64, 16, 1
    nb = slots * (max_len // bs) + 1
    kw = dict(num_blocks=nb, block_size=bs) if kv == "paged" else {}
    state = init_decode_state(cfg, slots, max_len, kv=kv, device="cpu",
                              dtype=compute, **kw)
    jstate = jax_state(jcfg, slots, max_len, kv=kv, dtype=jcompute, **kw)
    mb = max(max_len // bs, 1) if kv == "paged" else 1
    row = np.zeros((mb,), np.int32)
    if kv == "paged":
        row[:3] = [6, 2, 8]
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=45).astype(np.int32)
    logits = _chunks_int_and_tensor(
        build_model(cfg, compute=compute).prefill_chunk, params, cfg, state,
        prompt, row, slot)
    jchunk = jax.jit(jax_build(jcfg, compute=jcompute).prefill_chunk)
    off = 0
    for C, got in zip((16, 16, 13), logits):
        toks = prompt[None, off:off + C]
        jlogits, jstate = jchunk(jparams, jstate, jnp.asarray(toks),
                                 jnp.asarray(row), jnp.int32(slot),
                                 jnp.int32(off))
        assert got.shape == (1, cfg.vocab_size)
        np.testing.assert_allclose(_f(got), _f(jlogits), **TOL)
        off += C
    for leaf, jleaf in zip(state["cache"], jstate["cache"]):
        assert set(leaf) == set(jleaf)
        for k, v in leaf.items():
            tol = POOL_TOL if k in ("kp", "vp", "k", "v") else TOL
            np.testing.assert_allclose(_f(v), _f(jleaf[k]), **tol)


# ---------------------------------------------------------------------------
# chunk shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_len,bs,chunk", [(96, 16, 32), (64, 16, 16),
                                              (1024, 16, 128)])
def test_prefill_chunk_shapes_match_reference(max_len, bs, chunk):
    assert prefill_chunk_shapes(max_len, bs, chunk) == \
        jax_chunk_shapes(max_len, bs, chunk)


@pytest.mark.parametrize("max_len,bs,chunk", [(96, 16, 32), (1024, 16, 128)])
def test_prefill_chunk_shapes_closed_under_prefix_offsets(max_len, bs, chunk):
    """Aligned chunking from any block-boundary start produces only chunk
    lengths in the warmable set (tests/test_paged_kv.py)."""
    shapes = set(prefill_chunk_shapes(max_len, bs, chunk))
    for plen in admit_buckets(max_len):
        for start in range(0, plen, bs):
            off = start
            while off < plen:
                C = min(chunk - off % chunk, plen - off)
                assert C in shapes, (plen, start, off, C)
                off += C


# ---------------------------------------------------------------------------
# attn_impl="causal_blocked"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,window", [(128, None), (256, None), (256, 64)])
def test_causal_blocked_matches_jax(S, window):
    """tests/test_models_math.py's cases, against the reference's function
    and against the port's own chunked attention."""
    rng = np.random.default_rng(S + (window or 0))
    q, jq = _bf16_pair(rng, (1, S, 4, 64))
    k, jk = _bf16_pair(rng, (1, S, 2, 64))
    v, jv = _bf16_pair(rng, (1, S, 2, 64))
    got = attn.causal_blocked_attention(q, k, v, window=window, chunk=32,
                                        block_q=64)
    want = jattn.causal_blocked_attention(jq, jk, jv, window=window,
                                          chunk=32, block_q=64)
    np.testing.assert_allclose(_f(got), _f(want), **ATTN_TOL)
    plain = attn.chunked_attention(q, k, v, causal=True, window=window,
                                   chunk=32)
    np.testing.assert_allclose(_f(got), _f(plain), **ATTN_TOL)


def test_causal_blocked_prefill_matches_jax():
    """``attn_impl="causal_blocked"`` through the model's prefill: the
    last-position logits of a 64-token prompt."""
    cfg, jcfg, params, jparams = _model(SMOLLM, attn_impl="causal_blocked")
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(1, 64)).astype(np.int32)
    logits, _ = build_model(cfg).prefill(params,
                                         {"tokens": torch.from_numpy(toks)})
    jlogits, _ = jax.jit(jax_build(jcfg).prefill)(
        jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(_f(logits), _f(jlogits), **TOL)


# ---------------------------------------------------------------------------
# the chunked engine (bitwise, inside the port)
# ---------------------------------------------------------------------------

def _engine(arch, **kw):
    cfg, _, params, _ = _model(arch)
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    return ServeEngine(cfg, params, device="cpu", **kw)


def _req(rid, plen, max_new, vocab=512):
    prompt = np.random.default_rng(rid).integers(0, vocab, size=plen)
    return Request(rid=rid, prompt=prompt.astype(np.int32),
                   max_new_tokens=max_new)


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_chunked_admission_isolates_running_slot(kv):
    """A 4-chunk admission leaves the running slot's stream bitwise equal
    to its idle-engine run, and decode advances between chunks: one chunk
    and one decode step a tick (tests/test_paged_kv.py)."""
    kw = dict(kv=kv, max_len=96, prefill="chunked", prefill_chunk=16)
    solo = _engine(SMOLLM, **kw)
    solo.submit(_req(0, 7, 24))
    solo.run()
    alone = _engine(SMOLLM, **kw)
    alone.submit(_req(1, 60, 4))
    alone.run()

    eng = _engine(SMOLLM, **kw)
    eng.submit(_req(0, 7, 24))
    for _ in range(3):
        eng.step()
    steps_before = eng.steps
    eng.submit(_req(1, 60, 4))                  # bucket 64 -> 4 chunks
    while True:
        chunks = eng.prefill_chunks
        eng.step()
        assert eng.prefill_chunks == chunks + 1  # one chunk a tick
        if not eng._jobs:
            break
    assert eng.steps - steps_before == 4        # a decode step each tick
    stats = eng.run()
    assert eng.done[0].tokens == solo.done[0].tokens
    assert eng.done[1].tokens == alone.done[1].tokens
    assert stats["prefill_chunks"] == 1 + 4 and stats["prefill"] == "chunked"
    assert stats["d2h_transfers"] == stats["decode_steps"]
    assert eng.block_leaks() == 0


@pytest.mark.parametrize("arch,kv", [(SMOLLM, "paged"), (SMOLLM, "dense"),
                                     (GRANITE, "paged"), (MAMBA, "dense")])
def test_chunked_admission_beside_decode_matches_idle_engine(arch, kv):
    """A request admitted chunk by chunk while another slot decodes gives
    the tokens of the same request admitted into an idle engine: the
    decode step must not advance a mid-admission row's ring or SSM state
    between its chunks (`_guard_rows`)."""
    kw = dict(kv=kv, prefill="chunked", prefill_chunk=16)
    solo = _engine(arch, **kw)
    solo.submit(_req(1, 30, 3))                 # two chunks, idle engine
    solo.run()
    eng = _engine(arch, **kw)
    reqs = [(20, 12), (30, 3), (7, 4)]
    for i, (pl, mn) in enumerate(reqs):
        eng.submit(_req(i, pl, mn))
    stats = eng.run()
    assert stats["completed"] == 3 and stats["prefill_chunks"] == 5
    assert [len(eng.done[i].tokens) for i in range(3)] == \
        [mn + 1 for _, mn in reqs]
    assert eng.done[1].tokens == solo.done[1].tokens
    assert stats["d2h_transfers"] == stats["decode_steps"]
    assert eng.block_leaks() == 0


def test_cancel_mid_job_returns_its_blocks():
    """Cancelling a request whose chunked admission is in flight drops the
    job and returns its slot and blocks: the engine then drains with 0
    leaks; a drain with a job in flight returns it too."""
    eng = _engine(SMOLLM, max_len=96, prefill="chunked", prefill_chunk=16)
    eng.submit(_req(0, 60, 8))                  # 4 chunks
    eng.submit(_req(1, 5, 6))
    eng.step()
    eng.step()
    assert [j.req.rid for j in eng._jobs] == [0, 1]  # 0 mid-admission
    req = eng.cancel(0)
    assert req is not None and req.rid == 0 and req.tokens == []
    assert not any(j.req.rid == 0 for j in eng._jobs)
    eng.run()
    assert 1 in eng.done and 0 not in eng.done
    assert eng.block_leaks() == 0

    eng.submit(_req(2, 60, 8))
    eng.submit(_req(3, 9, 8))
    eng.step()
    assert eng._jobs
    out = eng.drain_requests()
    assert sorted(r.rid for r in out) == [2, 3]
    assert not eng._jobs and eng.block_leaks() == 0


@pytest.mark.parametrize("arch,kv", [(SMOLLM, "paged"), (MAMBA, "dense")])
def test_warm_admission_leaves_state_clean(arch, kv):
    """The chunk warm-up writes only the scratch block (paged) and zeroes
    the SSM rows it advanced; a request served after it matches one served
    without it."""
    kw = dict(kv=kv, prefill="chunked", prefill_chunk=16)
    cold = _engine(arch, **kw)
    cold.submit(_req(0, 20, 5))
    cold.run()
    eng = _engine(arch, **kw)
    eng.warm_admission()
    for leaf in eng.state["cache"]:
        for k, v in leaf.items():
            if k in ("conv", "ssd"):
                assert not v.any(), k
            elif k in ("kp", "vp"):
                assert not v[:, 1:].any(), k     # only block 0 written
    eng.submit(_req(0, 20, 5))
    eng.run()
    assert eng.done[0].tokens == cold.done[0].tokens


def test_chunked_prefix_hit_starts_the_job_past_the_shared_blocks():
    """An identical prompt maps the first request's three shareable blocks
    copy-free, so its job starts at position 48: one 16-token chunk
    instead of four, and the same tokens bitwise."""
    eng = _engine(SMOLLM, slots=1, max_len=96, prefill="chunked",
                  prefill_chunk=16)
    prompt = np.arange(2, 42).astype(np.int32)           # bucket 64
    eng.submit(Request(0, prompt, max_new_tokens=5))
    eng.run()
    assert eng.prefill_chunks == 4
    eng.submit(Request(1, prompt.copy(), max_new_tokens=5))
    eng.run()
    assert eng.prefill_chunks == 4 + 1
    assert eng.prefix_hit_tokens == 3 * 16
    assert eng.done[1].tokens == eng.done[0].tokens
    assert eng.block_leaks() == 0
