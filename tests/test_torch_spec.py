"""Speculative decoding in the port: the paged verify kernel's module, the
verify forward and the draft-and-verify engine, against the JAX package
and, bitwise, against the port's own spec="off" path
(tests/test_spec_decode.py mirrored).

Everything runs on the CPU: the kernel wrappers run their plain versions
for CPU tensors.  Tolerances: the verify attention against the JAX kernel
(interpret mode) and oracle at atol 2e-2, rtol 0, as
tests/test_spec_decode.py holds them (f32 inputs; the port's plain version
rounds q, k, p and v to bf16 as the kernel does, the JAX f32 path does
not).  Layer outputs and logits on bridged parameters at rtol = atol =
1e-2, the tolerance of tests/test_torch_model.py; pools at 2e-2 (one bf16
ulp of values up to ~4).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels.paged_attention.ops import (
    paged_verify_attention as jax_verify)
from repro.kernels.paged_attention.ref import paged_verify_attention_ref
from repro.models import attention as jattn
from repro.models.api import build_model as jax_build
from repro.models.api import init_decode_state as jax_state
from repro.serving.engine import _install_slot_paged as jax_install
from repro.serving.engine import spec_ineligible_reason as jax_reason
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as tbase
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention_plain, paged_verify_attention)
from repro_torch.launch.serve import expected_tokens, make_trace, serve_direct
from repro_torch.models import attention as attn
from repro_torch.models.api import build_model, init_decode_state
from repro_torch.serving.engine import (
    Request, ServeEngine, _install_slot_paged, spec_ineligible_reason)

ARCH = "smollm-360m"
VERIFY_TOL = dict(rtol=0, atol=2e-2)
LOGIT_TOL = dict(rtol=1e-2, atol=1e-2)
POOL_TOL = dict(rtol=2e-2, atol=2e-2)


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(attn_impl="pallas"):
    kw = dict(attn_impl=attn_impl, norm_impl="pallas")
    return (dataclasses.replace(tbase.get_smoke_config(ARCH), **kw),
            dataclasses.replace(jbase.get_smoke_config(ARCH), **kw))


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.key(0)))
    bundle = build_model(cfg)
    return cfg, bundle, params_from_numpy(tree, cfg, device="cpu"), tree


# ---------------------------------------------------------------------------
# the verify kernel's module against the JAX kernel and oracle
# ---------------------------------------------------------------------------

def _verify_inputs(B, S, H, K, Dh, bs, mb, seed, off=None):
    rng = np.random.default_rng(seed)
    nb = B * mb + 1
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, S, H, Dh), (nb, bs, K, Dh), (nb, bs, K, Dh))]
    tables = (1 + np.arange(B * mb).reshape(B, mb)).astype(np.int32)
    if off is None:
        off = rng.integers(0, mb * bs - S, size=(B,))
    return arrs + [tables, np.asarray(off, np.int32)]


@pytest.mark.parametrize("B,S,H,K,Dh,bs,mb,off", [
    (2, 5, 4, 2, 16, 8, 4, None),
    (3, 3, 4, 4, 8, 16, 2, None),
    (1, 5, 8, 1, 32, 8, 3, None),           # MQA-style grouping
    (3, 5, 4, 2, 16, 8, 4, [30, 31, 29]),   # positions past mb*bs = 32
])
def test_paged_verify_matches_jax(B, S, H, K, Dh, bs, mb, off):
    arrs = _verify_inputs(B, S, H, K, Dh, bs, mb, seed=len(str(off)), off=off)
    out = paged_verify_attention(*(torch.from_numpy(a) for a in arrs))
    jargs = [jnp.asarray(a) for a in arrs]
    assert np.isfinite(_f(out)).all()
    np.testing.assert_allclose(
        _f(out), _f(jax_verify(*jargs, interpret=True)), **VERIFY_TOL)
    np.testing.assert_allclose(
        _f(out), _f(paged_verify_attention_ref(*jargs)), **VERIFY_TOL)


def test_paged_verify_query_is_a_decode():
    """Query s of the verify is the paged decode at cache_len =
    min(q_off + s + 1, mb*bs), bitwise; rows past every frontier hold NaN
    and are never read; the CPU path launches no kernel."""
    B, S, H, K, Dh, bs, mb = 3, 5, 3, 1, 20, 16, 4
    q, kp, vp, tables, off = (torch.from_numpy(a) for a in _verify_inputs(
        B, S, H, K, Dh, bs, mb, seed=4, off=[0, 17, mb * bs - 2]))
    q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
    T = mb * bs
    for b in range(B):
        reach = min(int(off[b]) + S, T)
        for p in range(reach, T):
            kp[tables[b, p // bs], p % bs] = float("nan")
            vp[tables[b, p // bs], p % bs] = float("nan")
    before = paged_verify_attention.launches
    out = paged_verify_attention(q, kp, vp, tables, off)
    assert paged_verify_attention.launches == before
    assert torch.isfinite(out.float()).all()
    for s in range(S):
        one = paged_decode_attention_plain(q[:, s], kp, vp, tables,
                                           torch.clamp(off + s + 1, max=T))
        assert torch.equal(out[:, s], one), s


# ---------------------------------------------------------------------------
# the verify forward on bridged parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["pallas", "chunked"])
def test_attention_verify_matches_jax(attn_impl):
    """One verify burst of S = 5 queries per row, two rows at ragged
    positions, one of them overflowing the table: output and the written
    pools against the reference's `attention_verify`."""
    cfg, jcfg = _cfgs(attn_impl)
    jp = jattn.init_attention(jax.random.key(1), jcfg)
    p = {k: torch.from_numpy(np.array(v, np.float32)).to(torch.bfloat16)
         for k, v in jp.items()}
    B, S, bs, mb = 2, 5, 16, 2
    nb = B * mb + 1
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(2)
    pools = {k: (rng.normal(size=(nb, bs, K, Dh)) * 0.5).astype(np.float32)
             for k in ("kp", "vp")}
    pools = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in pools.items()}
    tables = np.array([[3, 1], [2, 4]], np.int32)
    pos = np.array([9, 2 * bs - 2], np.int32)
    x = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jpools = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
              for k, v in pools.items()}
    out, new = attn.attention_verify(
        x, p, cfg, {k: v.clone() for k, v in pools.items()},
        torch.from_numpy(pos), block_tables=torch.from_numpy(tables))
    jout, jnew = jattn.attention_verify(jx, jp, jcfg, jpools, jnp.asarray(pos),
                                        block_tables=jnp.asarray(tables))
    np.testing.assert_allclose(_f(out), _f(jout), **LOGIT_TOL)
    for key in ("kp", "vp"):                # scratch block 0 excepted
        np.testing.assert_allclose(_f(new[key][1:]), _f(jnew[key][1:]),
                                   **POOL_TOL)


SLOTS, MAX_LEN, BS = 2, 64, 16
PROMPTS = [(0, 23), (1, 9)]                 # (slot, prompt length)
ROWS = [[3, 7, 1, 5], [6, 2, 8, 4]]         # permuted physical blocks


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _slot, n in PROMPTS:
        toks = np.zeros((16 if n <= 16 else 32,), np.int32)
        toks[-n:] = rng.integers(0, vocab, size=n)   # left-padded
        out.append(toks)
    return out, rng


def _port_state(cfg, bundle, params, prompts):
    state = init_decode_state(cfg, SLOTS, MAX_LEN, block_size=BS, device="cpu")
    for (slot, plen), toks in zip(PROMPTS, prompts):
        _, cache = bundle.prefill(params, {"tokens": torch.from_numpy(toks[None])})
        _install_slot_paged(state, cache, slot, len(toks), 0, ROWS[slot], 0, BS)
    return state


def test_lm_verify_logits_match_jax(model):
    """Prefill two ragged rows, then one verify of [pending, 4 forced
    tokens]: the port's (B, 5, V) logits against the reference's."""
    cfg, bundle, params, tree = model
    _, jcfg = _cfgs()
    prompts, rng = _prompts(cfg.vocab_size)
    tokens = rng.integers(0, cfg.vocab_size, size=(SLOTS, 5)).astype(np.int32)
    state = _port_state(cfg, bundle, params, prompts)
    logits, _ = bundle.verify(params, torch.from_numpy(tokens), state)

    jb = jax_build(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    jst = jax_state(jcfg, SLOTS, MAX_LEN, kv="paged", block_size=BS)
    for (slot, _), toks in zip(PROMPTS, prompts):
        _, cache = jax.jit(jb.prefill)(jparams, {"tokens": jnp.asarray(toks[None])})
        jst = jax_install(jst, cache, slot, len(toks), 0, ROWS[slot], 0, BS)
    jlogits, _ = jax.jit(jb.verify)(jparams, jnp.asarray(tokens), jst)
    assert logits.shape == (SLOTS, 5, cfg.vocab_size)
    np.testing.assert_allclose(_f(logits), _f(jlogits), **LOGIT_TOL)


@pytest.mark.parametrize("attn_impl", ["pallas", "chunked"])
def test_verify_is_bitwise_sequential_decode(model, attn_impl):
    """Inside the port: one verify of [pending, 4 forced tokens] gives, at
    every position, bitwise the logits of the 5 sequential decode steps it
    replaces — the property that makes spec tokens equal spec="off"
    tokens.  The projections run at M = B*S rows in verify and M = B in
    decode; the CPU's bf16 matmul, RoPE and norms give a row the same bits
    at both."""
    _, _, params, _ = model
    cfg = dataclasses.replace(model[0], attn_impl=attn_impl)
    bundle = build_model(cfg)
    prompts, rng = _prompts(cfg.vocab_size, seed=3)
    tokens = rng.integers(0, cfg.vocab_size, size=(SLOTS, 5)).astype(np.int32)
    state = _port_state(cfg, bundle, params, prompts)
    vlogits, _ = bundle.verify(params, torch.from_numpy(tokens),
                               {**state, "cache": [
                                   {k: v.clone() for k, v in leaf.items()}
                                   for leaf in state["cache"]]})
    steps = []
    for s in range(5):
        state["token"] = torch.from_numpy(tokens[:, s:s + 1].copy())
        logits, state = bundle.decode(params, state)
        steps.append(logits[:, 0])
    assert torch.equal(vlogits, torch.stack(steps, dim=1))


# ---------------------------------------------------------------------------
# the engine: spec tokens == spec="off" tokens, bitwise
# ---------------------------------------------------------------------------

def _reqs(n=5, vocab=500):
    rng = np.random.default_rng(0)
    lens = [7, 20, 3, 31, 12, 25]
    buds = [9, 13, 17, 5, 11, 7]
    return [Request(rid=i, prompt=rng.integers(1, vocab, size=lens[i % 6])
                    .astype(np.int32), max_new_tokens=buds[i % 6])
            for i in range(n)]


def _engine(model, **kw):
    cfg, bundle, params, _ = model
    return ServeEngine(cfg, params, slots=kw.pop("slots", 3),
                       max_len=kw.pop("max_len", 64), bundle=bundle,
                       device="cpu", **kw)


@pytest.mark.parametrize("draft", ["self", "cold"])
def test_spec_tokens_bitwise_equal_off(model, draft):
    """Self-draft (acceptance high) and a cold random draft (acceptance ~0)
    both commit exactly the spec="off" greedy tokens."""
    cfg = model[0]
    base = _engine(model)
    for r in _reqs():
        base.submit(r)
    base.run()
    draft_cfg = (None if draft == "self"
                 else dataclasses.replace(cfg, num_layers=1))
    eng = _engine(model, spec="draft", spec_k=4, draft_cfg=draft_cfg)
    assert eng.spec == "draft", eng.spec_fallback_reason
    for r in _reqs():
        eng.submit(r)
    stats = eng.run()
    for rid in range(5):
        assert eng.done[rid].tokens == base.done[rid].tokens, rid
    assert stats["d2h_transfers"] == stats["decode_steps"]
    assert stats["spec"] == "draft" and stats["spec_k"] == 4
    assert stats["draft_overhead_s"] > 0
    if draft == "self":
        assert stats["acceptance_rate"] > 0.5
        assert stats["tokens_per_step"] > 1.0
    else:
        assert stats["acceptance_rate"] < 0.2
    assert eng.block_leaks() == 0


def test_spec_step_writes_the_draft_cache_in_place(model):
    """`_spec_step` writes the draft's shadow pools in place: the cache,
    its layers' dicts and their tensors stay the objects (and the storage)
    the spec pair's CUDA graphs are captured over, and the draft KV in them
    changes."""
    cfg = model[0]
    eng = _engine(model, slots=2, spec="draft", spec_k=4,
                  draft_cfg=dataclasses.replace(cfg, num_layers=1))
    assert eng.spec == "draft", eng.spec_fallback_reason
    cache = eng._draft_cache
    held = [(leaf, k, t, t.data_ptr()) for leaf in cache
            for k, t in leaf.items()]
    for r in _reqs(2):
        eng.submit(r)
    eng.step()                             # admissions + the first step
    after_admission = [t.clone() for _, _, t, _ in held]
    eng.run()
    assert eng._draft_cache is cache
    assert all(leaf[k] is t and t.data_ptr() == ptr
               for leaf, k, t, ptr in held)
    assert any(not torch.equal(t, was)
               for (_, _, t, _), was in zip(held, after_admission))


def test_spec_one_transfer_per_step(model, monkeypatch):
    """The packed (k+3, slots) verify return is the ONLY device->host read
    of a speculative step: one .cpu(), and no .item()/.tolist()/int()/
    bool() on a tensor; the draft chain reads nothing back."""
    eng = _engine(model, slots=2, spec="draft", spec_k=4)
    for i in range(2):
        eng.submit(Request(rid=i, prompt=(np.arange(9) + 3 * i + 1).astype(
            np.int32), max_new_tokens=10))
    eng.step()                             # admissions + first step
    calls = []

    def spy(name):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, **k):
            calls.append(name)
            return orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    for name in ("cpu", "item", "tolist", "__int__", "__bool__", "__float__",
                 "__index__"):
        spy(name)
    steps = 0
    while eng._live:
        eng.step()
        steps += 1
    monkeypatch.undo()
    assert steps > 0
    assert calls == ["cpu"] * steps, calls
    assert eng.d2h_transfers == eng.steps


def test_cancel_mid_verify_releases_every_block(model):
    """Admit, speculate a few steps (the verify frontier is up to k past
    the committed one in both pools), cancel mid-flight, repeat: every
    block comes back exactly once (the allocator raises on a double free)
    and only prefix pins remain between rounds."""
    eng = _engine(model, slots=2, spec="draft", spec_k=4)
    rng = np.random.default_rng(3)
    rid = 0
    for _ in range(4):
        for _ in range(2):
            eng.submit(Request(rid=rid, prompt=rng.integers(
                1, 500, size=17).astype(np.int32), max_new_tokens=20))
            rid += 1
        eng.step()
        eng.step()
        for r in (rid - 2, rid - 1):
            if r in eng._live:
                assert eng.cancel(r) is not None
        eng.done.clear()
        assert not eng._live
        assert eng.allocator.allocated_blocks == len(eng.prefix._map)
    assert eng.block_leaks() == 0


def test_spec_rollback_never_corrupts_shared_prefix(model):
    """Two slots share a prompt-prefix block and decode speculatively: the
    shared block's contents stay bitwise untouched in the target and the
    draft pools, and both streams agree."""
    eng = _engine(model, slots=2, spec="draft", spec_k=4)
    prompt = np.random.default_rng(7).integers(1, 500, size=30).astype(np.int32)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=12))
    eng.submit(Request(rid=1, prompt=prompt.copy(), max_new_tokens=12))
    eng._admit()
    ids = torch.tensor(sorted(set(eng._slot_blocks[0])
                              & set(eng._slot_blocks[1])))
    assert len(ids), "prompts must share a prefix block"
    pools = lambda: [leaf[k][:, ids].clone()                 # noqa: E731
                     for cache in (eng.state["cache"], eng._draft_cache)
                     for leaf in cache for k in ("kp", "vp")]
    before = pools()
    eng.run()
    assert all(torch.equal(a, b) for a, b in zip(before, pools()))
    assert eng.done[0].tokens == eng.done[1].tokens
    assert eng.block_leaks() == 0


def _port_cfg(jcfg):
    """The port's ArchConfig with the reference config's fields."""
    specs = {"moe": tbase.MoESpec, "mla": tbase.MLASpec, "ssm": tbase.SSMSpec}
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if f.name in specs and v is not None:
            v = specs[f.name](**dataclasses.asdict(v))
        kw[f.name] = v
    return tbase.ArchConfig(**kw)


@pytest.mark.parametrize("arch", jbase.list_archs())
def test_spec_ineligible_reason_matches_reference(arch):
    jcfg = jbase.get_smoke_config(arch)
    for kv in ("paged", "dense"):
        assert spec_ineligible_reason(_port_cfg(jcfg), kv) == \
            jax_reason(jcfg, kv), (arch, kv)


def test_spec_falls_back_with_a_reason(model):
    """Where speculation cannot roll back (dense KV) or cannot propose
    target ids (another vocab), the engine serves spec="off" and says
    why; its tokens are the plain engine's."""
    cfg = model[0]
    eng = _engine(model, kv="dense", spec="draft")
    assert eng.spec == "off" and "paged" in eng.spec_fallback_reason
    base = _engine(model, kv="dense")
    for e in (eng, base):
        for r in _reqs(3):
            e.submit(r)
    stats = eng.run()
    base.run()
    assert all(eng.done[i].tokens == base.done[i].tokens for i in range(3))
    assert stats["spec"] == "off" and stats["acceptance_rate"] == 0.0
    assert stats["spec_fallback_reason"] == eng.spec_fallback_reason
    other = dataclasses.replace(cfg, vocab_size=cfg.vocab_size * 2)
    eng = _engine(model, spec="draft", draft_cfg=other)
    assert eng.spec == "off" and "vocab" in eng.spec_fallback_reason


def test_serve_direct_speculative_cold_draft():
    """The serve entry point with a cold 1-layer draft from its own seed:
    every request finishes with its full count, one transfer per step, no
    leaked block, and the streams equal spec="off"."""
    cfg = tbase.get_smoke_config(ARCH)
    kw = dict(prompt_len=(5, 40), max_new_tokens=6, device="cpu")
    off = serve_direct(cfg, 4, 2, 64, **kw)
    stats = serve_direct(cfg, 4, 2, 64, spec="draft", spec_k=4,
                         draft_cfg=dataclasses.replace(cfg, num_layers=1),
                         draft_seed=1, **kw)
    trace = make_trace(cfg.vocab_size, 4, max_len=64, prompt_len=(5, 40),
                       max_new_tokens=6)
    assert stats["spec"] == "draft"
    assert stats["tokens_per_request"] == {
        e["rid"]: expected_tokens(e, 64) for e in trace}
    assert stats["d2h_transfers"] == stats["decode_steps"] > 0
    assert stats["block_leaks"] == 0
    assert stats["streams"] == off["streams"]


def test_draft_chain_leaves_the_bonus_position_to_the_target(model):
    """As in the reference (`make_draft_step`), the draft chain decodes k
    tokens and writes draft KV at pos..pos+k-1 only.  After a step that
    accepts every draft (a = k+1) the target wrote position pos+k and the
    draft pool never does: the draft's later proposals attend a stale row
    there, which is why self-draft acceptance stays below 1 (ROADMAP
    Queue 3)."""
    eng = _engine(model, slots=1, spec="draft", spec_k=4)
    eng.submit(Request(rid=0, prompt=np.arange(1, 8).astype(np.int32),
                       max_new_tokens=40))
    assert eng.step() == 5                   # bucket 16, all 4 drafts kept
    assert eng._host_pos[0] == 16 + 5
    blk, off = eng._slot_blocks[0][1], 20 % 16       # position 20
    target = eng.state["cache"][0]["kp"][:, blk, off]
    draft = eng._draft_cache[0]["kp"][:, blk, off]
    assert not bool((target == 0).all()) and bool((draft == 0).all())
    assert bool((eng._draft_cache[0]["kp"][:, blk, off - 1] != 0).any())
