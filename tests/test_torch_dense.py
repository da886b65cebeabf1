"""The dense-KV ablation in the port: the dense flash-decode kernel's
module against the JAX package (tests/test_kernels.py mirrored), and the
engine invariant paged == dense, bitwise, at the attention layer and on
token streams (tests/test_paged_kv.py mirrored).

Everything runs on the CPU: the kernel wrappers run their plain versions
for CPU tensors.  Tolerances: decode attention against the JAX kernel
(interpret mode) and oracle at rtol 5e-2, atol 2e-2, as
tests/test_kernels.py holds them (the port's plain version rounds q, k, p
and v to bf16 as the kernel does); logits on bridged parameters at rtol =
atol = 1e-2, the tolerance of tests/test_torch_model.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke
from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.models.api import build_model as jax_build
from repro.models.api import init_decode_state as jax_state
from repro.serving.engine import _install_slot as jax_install
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_smoke_config
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.launch.serve import expected_tokens, make_trace, serve_direct
from repro_torch.models import attention as attn
from repro_torch.models.api import build_model, init_decode_state
from repro_torch.serving.engine import Request, ServeEngine, _install_slot

ARCH = "smollm-360m"
ATTN_TOL = dict(rtol=5e-2, atol=2e-2)
LOGIT_TOL = dict(rtol=1e-2, atol=1e-2)


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _cfgs(attn_impl="pallas"):
    kw = dict(attn_impl=attn_impl, norm_impl="pallas")
    return (dataclasses.replace(get_smoke_config(ARCH), **kw),
            dataclasses.replace(jax_smoke(ARCH), **kw))


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.key(0)))
    return cfg, build_model(cfg), params_from_numpy(tree, cfg, device="cpu"), tree


# ---------------------------------------------------------------------------
# the dense decode kernel's module against the JAX kernel and oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,H,K,Dh,lens", [
    (2, 256, 4, 2, 64, None),
    (1, 512, 8, 8, 128, None),
    (3, 160, 6, 3, 32, None),
    (2, 128, 4, 1, 64, None),                # MQA
    (5, 160, 4, 2, 32, [160, 1, 33, 97, 17]),  # ragged, off the tiles
])
def test_decode_attention_matches_jax(B, T, H, K, Dh, lens):
    q, kc, vc = _rand((B, H, Dh), 7), _rand((B, T, K, Dh), 8), \
        _rand((B, T, K, Dh), 9)
    if lens is None:
        lens = ([T, T // 3, 1][:B] + [T] * max(0, B - 3))
    lens = np.asarray(lens, np.int32)
    out = decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc, lens)))
    jargs = [jnp.asarray(a) for a in (q, kc, vc, lens)]
    np.testing.assert_allclose(
        _f(out), _f(jax_decode(*jargs, block_t=32, interpret=True)), **ATTN_TOL)
    np.testing.assert_allclose(_f(out), _f(decode_attention_ref(*jargs)),
                               **ATTN_TOL)


def test_decode_attention_rows_are_independent():
    """Changing the OTHER rows' lengths leaves a row's output bitwise
    unchanged; ring rows past a row's length hold NaN and are never read;
    the CPU path launches no kernel."""
    B, T, H, K, Dh = 5, 160, 4, 2, 32
    q, kc, vc = (torch.from_numpy(_rand(s, i)).to(torch.bfloat16) for i, s in
                 enumerate([(B, H, Dh), (B, T, K, Dh), (B, T, K, Dh)]))
    lens = torch.tensor([160, 1, 33, 97, 17], dtype=torch.int32)
    for b in range(B):
        kc[b, int(lens[b]):] = float("nan")
        vc[b, int(lens[b]):] = float("nan")
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, lens)
    assert decode_attention.launches == before
    assert torch.isfinite(out.float()).all()
    out2 = decode_attention(q, kc, vc,
                            torch.tensor([160, 1, 2, 5, 17], dtype=torch.int32))
    assert torch.equal(out[0], out2[0]) and torch.equal(out[4], out2[4])


def test_dense_decode_equals_paged_decode_of_the_same_rows():
    """A ring's rows scattered into a permuted pool: the dense and the
    paged decode give bitwise the same output (the kernels share a block
    body on the card; the plain versions share `decode_attention_plain`)."""
    B, H, K, Dh, bs, mb = 3, 3, 1, 20, 16, 4
    T = mb * bs
    kc, vc = (torch.from_numpy(_rand((B, T, K, Dh), s)).to(torch.bfloat16)
              for s in (1, 2))
    q = torch.from_numpy(_rand((B, H, Dh), 3)).to(torch.bfloat16)
    lens = torch.tensor([1, T, 37], dtype=torch.int32)
    ids = np.random.default_rng(0).permutation(np.arange(1, B * mb + 1))
    tables = torch.from_numpy(ids.reshape(B, mb).astype(np.int32))
    pools = []
    for c in (kc, vc):
        pool = torch.zeros((B * mb + 1, bs, K, Dh), dtype=torch.bfloat16)
        pool[tables.reshape(-1).long()] = c.reshape(B * mb, bs, K, Dh)
        pools.append(pool)
    assert torch.equal(decode_attention(q, kc, vc, lens),
                       paged_decode_attention(q, *pools, tables, lens))


# ---------------------------------------------------------------------------
# paged == dense, bitwise: attention layer and engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["pallas", "chunked"])
def test_attention_decode_paged_bitwise_equals_dense(attn_impl):
    """Scatter a dense cache's rows into a permuted block pool: the paged
    decode (write + attend) reproduces the dense ring decode bit for bit,
    output and written rows."""
    cfg, _ = _cfgs(attn_impl)
    gen = torch.Generator().manual_seed(1)
    p = attn.init_attention(gen, cfg)
    B, T, bs = 3, 32, 16
    mb = T // bs
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    dense = {k: (torch.randn((B, T, K, Dh), generator=gen) * 0.1).to(
        torch.bfloat16) for k in ("k", "v")}
    nb = B * mb + 1
    perm = np.random.default_rng(0).permutation(np.arange(1, nb))
    bt = torch.from_numpy(perm.reshape(B, mb).astype(np.int32))
    paged = {}
    for dk, pk in (("k", "kp"), ("v", "vp")):
        pool = torch.zeros((nb, bs, K, Dh), dtype=torch.bfloat16)
        pool[bt.reshape(-1).long()] = dense[dk].reshape(B * mb, bs, K, Dh)
        paged[pk] = pool
    x = torch.randn((B, 1, cfg.d_model), generator=gen).to(torch.bfloat16)
    pos = torch.tensor([2, 17, 30], dtype=torch.int32)
    out_d, new_d = attn.attention_decode(x, p, cfg, dense, pos)
    out_p, new_p = attn.attention_decode(x, p, cfg, paged, pos,
                                         block_tables=bt)
    assert torch.equal(out_d, out_p)
    for dk, pk in (("k", "kp"), ("v", "vp")):
        assert torch.equal(new_d[dk], attn.gather_kv(new_p[pk], bt))


def _req(rid, plen, max_new, vocab=512):
    rng = np.random.default_rng(rid)
    return Request(rid=rid, prompt=rng.integers(0, vocab, size=plen).astype(
        np.int32), max_new_tokens=max_new)


def _engine(model, **kw):
    cfg, bundle, params, _ = model
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    return ServeEngine(cfg, params, bundle=bundle, device="cpu", **kw)


def test_engine_paged_tokens_bitwise_equal_dense(model):
    """The same trace on both layouts, with a refill mid-decode: the token
    streams are bitwise equal; the paged engine returns every block, the
    dense one has none."""
    reqs = [(7, 6), (20, 4), (4, 8), (33, 9)]

    def run(kv):
        eng = _engine(model, kv=kv)
        for i, (pl, mn) in enumerate(reqs):
            eng.submit(_req(i, pl, mn))
        stats = eng.run()
        assert stats["completed"] == len(reqs)
        assert stats["d2h_transfers"] == stats["decode_steps"]
        return eng, stats

    engd, sd = run("dense")
    engp, sp = run("paged")
    for i in range(len(reqs)):
        assert engd.done[i].tokens == engp.done[i].tokens, i
    assert (engd.kv, engp.kv, sd["kv"]) == ("dense", "paged", "dense")
    assert engd.allocator is None and engd.block_leaks() == 0
    assert engp.block_leaks() == 0
    assert sd["kv_capacity_tokens"] == 2 * 64
    assert sd["kv_pool_bytes"] == sum(
        t.numel() * t.element_size() for leaf in engd.state["cache"]
        for t in leaf.values())


def test_dense_engine_one_transfer_per_step_and_cancel(model, monkeypatch):
    """One .cpu() per dense decode step and no other read-back; a cancel
    mid-decode frees the slot for the next request."""
    eng = _engine(model, kv="dense")
    eng.submit(_req(0, 7, 30))
    eng.submit(_req(1, 4, 30))
    eng.step()
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
    for _ in range(4):
        eng.step()
    monkeypatch.undo()
    assert calls == ["cpu"] * 4, calls
    assert len(eng.cancel(0).tokens) == 6
    eng.submit(_req(2, 9, 3))
    stats = eng.run()
    assert sorted(eng.done) == [1, 2] and len(eng.done[2].tokens) == 4
    assert stats["d2h_transfers"] == stats["decode_steps"]


def test_dense_decode_logits_match_jax(model):
    """Two prefills installed into a dense state, then 4 teacher-forced
    decode steps: the port's logits and ring rows against the
    reference's dense path."""
    cfg, bundle, params, tree = model
    _, jcfg = _cfgs()
    rng = np.random.default_rng(5)
    prompts = [np.zeros((32,), np.int32), np.zeros((16,), np.int32)]
    prompts[0][-23:] = rng.integers(0, cfg.vocab_size, size=23)
    prompts[1][-9:] = rng.integers(0, cfg.vocab_size, size=9)
    forced = rng.integers(0, cfg.vocab_size, size=(4, 2)).astype(np.int32)

    state = init_decode_state(cfg, 2, 64, kv="dense", device="cpu")
    assert "block_tables" not in state
    assert state["cache"][0]["k"].shape == (cfg.num_layers, 2, 64,
                                            cfg.num_kv_heads, cfg.head_dim)
    jb = jax_build(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    jst = jax_state(jcfg, 2, 64, kv="dense")
    for slot, toks in enumerate(prompts):
        _, cache = bundle.prefill(params, {"tokens": torch.from_numpy(toks[None])})
        _install_slot(state, cache, slot, len(toks), 0)
        _, jcache = jax.jit(jb.prefill)(jparams, {"tokens": jnp.asarray(toks[None])})
        jst = jax_install(jst, jcache, slot, len(toks), 0)
    decode = jax.jit(jb.decode)
    for t in range(4):
        state["token"] = torch.from_numpy(forced[t][:, None].copy())
        logits, state = bundle.decode(params, state)
        jlogits, jst = decode(jparams, {**jst, "token": jnp.asarray(
            forced[t][:, None])})
        np.testing.assert_allclose(_f(logits), _f(jlogits), **LOGIT_TOL)
    np.testing.assert_array_equal(state["pos"].numpy(), np.asarray(jst["pos"]))
    for mine, ref in zip(state["cache"], jst["cache"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(_f(mine[key]), _f(ref[key]),
                                       rtol=2e-2, atol=2e-2)


def test_serve_direct_dense_answers_a_trace():
    cfg = get_smoke_config(ARCH)
    kw = dict(prompt_len=(5, 40), max_new_tokens=6, device="cpu")
    paged = serve_direct(cfg, 4, 2, 64, **kw)
    stats = serve_direct(cfg, 4, 2, 64, kv="dense", **kw)
    trace = make_trace(cfg.vocab_size, 4, max_len=64, prompt_len=(5, 40),
                       max_new_tokens=6)
    assert stats["kv"] == "dense"
    assert stats["tokens_per_request"] == {
        e["rid"]: expected_tokens(e, 64) for e in trace}
    assert stats["d2h_transfers"] == stats["decode_steps"] > 0
    assert stats["block_leaks"] == 0
    assert stats["streams"] == paged["streams"]
