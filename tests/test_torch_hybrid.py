"""The port's hybrid jamba-v0.1-52b (seven Mamba-2 SSM slots and one
attention slot a group, MoE on every other slot) against the JAX package:
prefill and teacher-forced decode on the paged and the dense layouts,
chained prefill chunks, the loss and every gradient leaf; and, inside the
port, the engine's invariants (paged = dense, a chunked admission beside a
decoding slot = its idle run, no speculation, no prefix cache) and the
serve entry points.

The smoke config is run at ``num_layers`` 16: two groups of eight, so the
stacking of every slot's leaves across groups is covered.  Inputs are made
with numpy from a seed; parameters are the reference's own (key 0),
bridged.  The port runs the serve entry's kernel flags (``attn_impl``,
``norm_impl``, ``ssm_impl`` "pallas", ``moe_impl`` "gmm"), whose wrappers
run their plain versions on CPU tensors; the JAX side runs its plain path.
The loss runs the plain paths on both sides, as training does.

Tolerances, and why:

* At f32 compute (f32 weights, plain paths), logits and every cache
  leaf: rtol = atol = 5e-3.  The same f32 math summed in other orders,
  but attention still rounds q, k, p and v to bf16, as the reference's
  does at every compute dtype, so an f32 difference of 1e-5 can flip one
  bf16 rounding in the first group's attention: logits within 4e-4, the
  second group's K/V pools within 2.7e-3.
* At bf16 compute, the serve dtype: logits rtol = atol = 5e-2
  (``DEEP_TOL``, the rtol of chip_smoke.py's ``LOGIT_TOL``); the first
  layer's SSM rows 2e-2 (one bf16 ulp at |x| ~ 4, tests/test_torch_archs.py's
  ``POOL_TOL``).  The two packages round bf16 activations at the same
  points, but the reference's compiler keeps a gated MLP's ``act(g) * u``
  in f32 where torch rounds ``act(g)`` first (0.5 % apart after one MLP),
  and over 16 layers these differences compound: logits of |x| ~ 0.5
  differ by up to 0.035 (0.016 at 8 layers, 0.005 over mamba2-smoke's 2),
  and deeper layers' caches by up to 5 % in norm, while the same runs at
  f32 compute agree to 6e-5: rounding, not a different function.  So the
  deep caches are held at f32 compute.
* The loss 2e-3, the MoE aux loss 1e-2 relative; gradient leaves
  ||g - g_ref|| / ||g_ref|| < 5e-3 at f32 compute: tests/test_torch_train.py's.
* Inside the port: streams bitwise.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.configs.base import get_smoke_config as jax_smoke
from repro.models.api import build_model as jax_build
from repro.models.api import init_decode_state as jax_state
from repro.serving.engine import _install_slot as jax_install
from repro.serving.engine import _install_slot_paged as jax_install_paged
from repro.serving.engine import spec_ineligible_reason as jax_spec_reason
from repro_torch import tree
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.images import ExecutableRegistry, PayloadImage
from repro_torch.launch.serve import expected_tokens, make_trace, serve_direct
from repro_torch.models.api import build_model, init_decode_state
from repro_torch.models.transformer import layer_slots
from repro_torch.serving.engine import (
    Request, ServeEngine, _install_slot, _install_slot_paged)

ARCH = "jamba-v0.1-52b"
LAYERS = 16
KERNELS = dict(attn_impl="pallas", norm_impl="pallas", ssm_impl="pallas",
               moe_impl="gmm")
PLAIN = dict(attn_impl="chunked", norm_impl="jnp", ssm_impl="chunked",
             moe_impl="einsum")
F32_TOL = dict(rtol=5e-3, atol=5e-3)
DEEP_TOL = dict(rtol=5e-2, atol=5e-2)
POOL_TOL = dict(rtol=2e-2, atol=2e-2)
LOSS_TOL = 2e-3
AUX_TOL = 1e-2
GRAD_TOL = 5e-3
CPU = "cpu"
SLOTS, MAX_LEN, BS, STEPS = 2, 128, 16, 6
PROMPTS = [(0, 23, 64), (1, 60, 64)]          # (slot, tokens, bucket)


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(port=KERNELS, ref=PLAIN):
    """(port cfg, reference cfg) at ``LAYERS`` layers."""
    return (dataclasses.replace(get_smoke_config(ARCH), num_layers=LAYERS,
                                **port),
            dataclasses.replace(jax_smoke(ARCH), num_layers=LAYERS, **ref))


@pytest.fixture(scope="module")
def model():
    """(cfg, jcfg, the reference's f32 tree (numpy), port params (bf16
    serve layout), jax params)."""
    cfg, jcfg = _cfgs()
    t = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.key(0)))
    return (cfg, jcfg, t, params_from_numpy(t, cfg, device=CPU),
            jax.tree.map(jnp.asarray, t))


def _prompt(vocab, n, plen, seed):
    """A left-padded prompt of ``n`` tokens in a bucket of ``plen``."""
    toks = np.zeros((plen,), np.int32)
    toks[-n:] = np.random.default_rng(seed).integers(0, vocab, size=n)
    return toks


def _forced(vocab):
    return np.random.default_rng(11).integers(
        0, vocab, size=(STEPS, SLOTS)).astype(np.int32)


_ROWS = [list(range(1 + s * (MAX_LEN // BS), 1 + (s + 1) * (MAX_LEN // BS)))
         [::-1] for s in range(SLOTS)]


_JIT: dict = {}


def _jax_fns(jcfg, compute):
    """The reference bundle's jitted prefill, decode and prefill_chunk at
    ``compute``, built once for the file."""
    if compute not in _JIT:
        b = jax_build(jcfg, compute=compute)
        _JIT[compute] = {n: jax.jit(getattr(b, n))
                         for n in ("prefill", "decode", "prefill_chunk")}
    return _JIT[compute]


def _jax_run(model, kv, compute=jnp.bfloat16, tree=None):
    _, jcfg, _, _, jparams = model
    jparams = jparams if tree is None else tree
    fns = _jax_fns(jcfg, compute)
    state = jax_state(jcfg, SLOTS, MAX_LEN, kv=kv, block_size=BS,
                      dtype=compute)
    pre, dec = [], []
    for slot, n, plen in PROMPTS:
        toks = _prompt(jcfg.vocab_size, n, plen, seed=slot)
        logits, cache = fns["prefill"](jparams,
                                       {"tokens": jnp.asarray(toks[None])})
        pre.append(_f(logits[0, -1]))
        state = (jax_install_paged(state, cache, slot, plen, 0, _ROWS[slot],
                                   0, BS) if kv == "paged"
                 else jax_install(state, cache, slot, plen, 0))
    for t in _forced(jcfg.vocab_size):
        state = {**state, "token": jnp.asarray(t[:, None])}
        logits, state = fns["decode"](jparams, state)
        dec.append(_f(logits[:, 0]))
    return np.stack(pre), np.stack(dec), state


def _port_run(model, kv, cfg=None, params=None, compute=torch.bfloat16):
    cfg = cfg or model[0]
    params = model[3] if params is None else params
    bundle = build_model(cfg, compute=compute)
    state = init_decode_state(cfg, SLOTS, MAX_LEN, kv=kv, block_size=BS,
                              device=CPU, dtype=compute)
    pre, dec = [], []
    with torch.no_grad():
        for slot, n, plen in PROMPTS:
            toks = _prompt(cfg.vocab_size, n, plen, seed=slot)
            logits, cache = bundle.prefill(
                params, {"tokens": torch.from_numpy(toks[None])})
            pre.append(_f(logits[0, -1]))
            if kv == "paged":
                _install_slot_paged(state, cache, slot, plen, 0, _ROWS[slot],
                                    0, BS)
            else:
                _install_slot(state, cache, slot, plen, 0)
        for t in _forced(cfg.vocab_size):
            state["token"] = torch.from_numpy(t[:, None].copy())
            logits, state = bundle.decode(params, state)
            dec.append(_f(logits[:, 0]))
    return np.stack(pre), np.stack(dec), state


# ---------------------------------------------------------------------------
# config and layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_copies_the_reference(smoke):
    mine = (get_smoke_config if smoke else get_config)(ARCH)
    ref = (jax_smoke if smoke else jax_config)(ARCH)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()


def test_slot_layout_is_the_references():
    """Seven SSM slots and one attention slot at index 7, MoE on every odd
    slot; the params and both caches stack two groups."""
    cfg, _ = _cfgs()
    slots = layer_slots(cfg)
    assert [s["mixer"] for s in slots] == ["ssm"] * 7 + ["attn"]
    assert [s["ffn"] for s in slots] == ["dense", "moe"] * 4
    params = build_model(cfg).init(0, device=CPU)
    assert params.n_groups == 2
    paged = init_decode_state(cfg, 2, 64, kv="paged", device=CPU)["cache"]
    dense = init_decode_state(cfg, 2, 64, kv="dense", device=CPU)["cache"]
    assert set(paged[7]) == {"kp", "vp"} and set(dense[7]) == {"k", "v"}
    for c in (paged, dense):
        assert all(set(c[i]) == {"conv", "ssd"} for i in range(7))
        assert all(v.shape[0] == 2 for leaf in c for v in leaf.values())


# ---------------------------------------------------------------------------
# prefill, decode, chunks, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_prefill_and_decode_match_jax(model, kv):
    """Two left-padded prompts prefilled into their slots, then ``STEPS``
    teacher-forced decode steps in bf16: every logit, the positions and
    every cache leaf (the attention slot's pool or ring, the SSM rows), on
    the kernel flags' plain versions against the reference's plain
    path."""
    pp, pd, pstate = _port_run(model, kv)
    jp, jd, jstate = _jax_run(model, kv)
    np.testing.assert_allclose(pp, jp, **DEEP_TOL)
    np.testing.assert_allclose(pd, jd, **DEEP_TOL)
    np.testing.assert_array_equal(pstate["pos"].numpy(),
                                  np.asarray(jstate["pos"]))
    for mine, ref in zip(pstate["cache"], jstate["cache"]):
        assert set(mine) == set(ref)
        assert all(v.shape == ref[k].shape for k, v in mine.items())
    for key in ("conv", "ssd"):            # the first layer's rows
        np.testing.assert_allclose(_f(pstate["cache"][0][key][0]),
                                   _f(jstate["cache"][0][key][0]), **POOL_TOL)


def _close_trees(mine, ref, tol):
    for leaf, rleaf in zip(mine, ref, strict=True):
        assert set(leaf) == set(rleaf)
        for k, v in leaf.items():
            got, want = _f(v), _f(rleaf[k])
            if k in ("kp", "vp"):          # scratch block 0: free-slot writes
                got, want = got[:, 1:], want[:, 1:]
            np.testing.assert_allclose(got, want, **tol, err_msg=k)


def test_prefill_and_decode_match_jax_at_f32(model):
    """The same run on the paged layout at f32 compute and f32 weights,
    plain paths on both sides: the logits and every cache leaf (each SSM
    slot's rows, the attention slot's pools) of both groups."""
    t = model[2]
    cfg, _ = _cfgs(port=PLAIN)
    params = params_from_numpy(t, cfg, device=CPU,
                               matrix_dtype=torch.float32)
    pp, pd, ps = _port_run(model, "paged", cfg, params, torch.float32)
    jp, jd, js = _jax_run(model, "paged", jnp.float32, t)
    np.testing.assert_allclose(pp, jp, **F32_TOL)
    np.testing.assert_allclose(pd, jd, **F32_TOL)
    _close_trees(ps["cache"], js["cache"], F32_TOL)


def test_paged_decode_equals_dense_bitwise(model):
    """Inside the port, the same prefills and decodes on the paged and the
    dense layouts give the same logits bit for bit."""
    _, pd, _ = _port_run(model, "paged")
    _, dd, _ = _port_run(model, "dense")
    np.testing.assert_array_equal(pd, dd)


def _chain(model, C, jax_side, kv, n=96, compute="bf16"):
    """Chunks of ``C`` tokens of an ``n``-token prompt into row 1 of a
    2-slot state; each chunk's logits and the state.  ``compute`` "f32":
    f32 compute, f32 weights, plain paths."""
    cfg, jcfg, t, params, jparams = model
    jdt, tdt = jnp.bfloat16, torch.bfloat16
    if compute == "f32":
        jdt, tdt = jnp.float32, torch.float32
        cfg = _cfgs(port=PLAIN)[0]
        params = params_from_numpy(t, cfg, device=CPU,
                                   matrix_dtype=torch.float32)
        jparams = t
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=n).astype(np.int32)
    mb = MAX_LEN // BS
    row = np.zeros((mb,), np.int32)
    if kv == "paged":
        row[:] = np.arange(1 + mb, 1 + 2 * mb)
    kw = dict(block_size=BS) if kv == "paged" else {}
    out = []
    if jax_side:
        state = jax_state(jcfg, 2, MAX_LEN, kv=kv, dtype=jdt, **kw)
        chunk = _jax_fns(jcfg, jdt)["prefill_chunk"]
        for off in range(0, n, C):
            logits, state = chunk(jparams, state,
                                  jnp.asarray(prompt[None, off:off + C]),
                                  jnp.asarray(row), jnp.int32(1),
                                  jnp.int32(off))
            out.append(_f(logits))
        return np.concatenate(out), state
    bundle = build_model(cfg, compute=tdt)
    state = init_decode_state(cfg, 2, MAX_LEN, kv=kv, device=CPU, dtype=tdt,
                              **kw)
    with torch.no_grad():
        for off in range(0, n, C):
            logits, _ = bundle.prefill_chunk(
                params, state, torch.from_numpy(prompt[None, off:off + C]),
                torch.from_numpy(row), 1, off)
            out.append(_f(logits))
    return np.concatenate(out), state


@pytest.mark.parametrize("compute", ["bf16", "f32"])
def test_lm_prefill_chunk_chained_matches_jax(model, compute):
    """A 96-token prompt in three 32-token chunks into row 1 of a paged
    state: every chunk's logits and (at f32 compute) every cache leaf
    after the last (the SSM rows carried across chunks, the pool's
    blocks); row 0's SSM state untouched."""
    got, state = _chain(model, 32, False, "paged", compute=compute)
    want, jstate = _chain(model, 32, True, "paged", compute=compute)
    if compute == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
        _close_trees(state["cache"], jstate["cache"], F32_TOL)
    else:
        np.testing.assert_allclose(got, want, **DEEP_TOL)
    assert not state["cache"][0]["ssd"][:, 0].any()


def _train_batch(vocab):
    rng = np.random.default_rng(0)
    return {k: rng.integers(0, vocab, (2, 64)).astype(np.int32)
            for k in ("tokens", "targets")}


def test_loss_and_every_gradient_leaf_match_jax(model):
    """``bundle.loss`` on the plain paths at f32 compute, f32 master
    weights: the loss, the MoE aux loss, and every leaf of the gradient
    (the SSM mixers', the attention slot's, the experts' and routers')
    against ``jax.grad`` of the reference's, at two groups."""
    t = model[2]
    cfg, jcfg = _cfgs(port=PLAIN)
    nb = _train_batch(cfg.vocab_size)
    jnb = jax.tree.map(jnp.asarray, nb)
    jb = jax_build(jcfg, compute=jnp.float32)
    (jloss, jm), grads = jax.jit(jax.value_and_grad(
        lambda p: jb.loss(p, jnb), has_aux=True))(t)
    params = params_from_numpy(t, cfg, device=CPU,
                               matrix_dtype=torch.float32).requires_grad_(True)
    loss, m = build_model(cfg, compute=torch.float32).loss(
        params, {k: torch.from_numpy(v) for k, v in nb.items()})
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < LOSS_TOL
    aux = float(m["aux"].detach())
    assert abs(aux - float(jm["aux"])) < AUX_TOL * float(jm["aux"])
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, grads))
    mine = tree.leaves(params.live())
    assert len(mine) == len(want)
    names = set()
    for (path, g), p in zip(want, mine):
        name = jax.tree_util.keystr(path)
        names.add(name.split("['")[-1])
        got = p.grad.numpy()
        assert got.shape == g.shape and np.isfinite(got).all(), name
        if np.abs(g).max() == 0:
            assert np.abs(got).max() == 0, name
            continue
        rel = float(np.linalg.norm(got - g) / np.linalg.norm(g))
        assert rel < GRAD_TOL, (name, rel)
    assert {"A_log']", "conv_w']", "wq']", "router']", "gate']"} <= names


# ---------------------------------------------------------------------------
# the engine and the entry points (inside the port, bitwise)
# ---------------------------------------------------------------------------

def _reqs(vocab, lens, max_new=8):
    return [Request(rid=i, prompt=np.random.default_rng(100 + i).integers(
        0, vocab, size=n).astype(np.int32), max_new_tokens=max_new)
        for i, n in enumerate(lens)]


def _streams(model, lens, **kw):
    cfg, params = model[0], model[3]
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 128)
    eng = ServeEngine(cfg, params, device=CPU, **kw)
    for r in _reqs(cfg.vocab_size, lens):
        eng.submit(r)
    stats = eng.run()
    assert stats["d2h_transfers"] == stats["decode_steps"] > 0
    assert eng.block_leaks() == 0
    return eng, {rid: r.tokens for rid, r in eng.done.items()}


LENS = [9, 40, 70]


def test_engine_pages_attention_without_prefix_cache_or_speculation(model):
    """The engine pages the attention slot and keeps the SSM slots' rows,
    has no prefix cache, and falls back from speculation with the SSM
    reason the reference gives; its paged streams equal the dense
    engine's, and a speculative request's equal spec-off's."""
    jcfg = model[1]
    eng, paged = _streams(model, LENS)
    assert eng.kv == "paged" and eng.prefix is None
    assert set(eng.state["cache"][7]) == {"kp", "vp"}
    assert set(eng.state["cache"][0]) == {"conv", "ssd"}
    _, dense = _streams(model, LENS, kv="dense")
    assert paged == dense and len(paged) == len(LENS)
    spec, got = _streams(model, LENS, spec="draft")
    assert spec.spec == "off" and got == paged
    assert spec.spec_fallback_reason == jax_spec_reason(jcfg, "paged")
    assert "SSM state rows" in spec.spec_fallback_reason


def test_verify_refuses_the_ssm_mixers(model):
    cfg, _, _, params, _ = model
    state = init_decode_state(cfg, 2, 64, kv="paged", device=CPU)
    with pytest.raises(ValueError, match="SSM state rows"):
        build_model(cfg).verify(params, torch.zeros((2, 3), dtype=torch.int32),
                                state)


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_chunked_admission_beside_a_decoding_slot_is_its_idle_run(model, kv):
    """tests/test_paged_kv.py's jamba case: a request admitted chunk by
    chunk while another slot decodes gives its idle-engine stream bit for
    bit (the SSM rows are zeroed at admission and guarded around every
    decode step until its last chunk); every request completes."""
    cfg, params = model[0], model[3]
    kw = dict(slots=2, max_len=64, kv=kv, prefill="chunked",
              prefill_chunk=16)
    solo = ServeEngine(cfg, params, device=CPU, **kw)
    solo.submit(Request(1, np.random.default_rng(1).integers(
        0, cfg.vocab_size, 30).astype(np.int32), 3))
    solo.run()
    eng = ServeEngine(cfg, params, device=CPU, **kw)
    for i, (n, m) in enumerate([(20, 12), (30, 3), (7, 4)]):
        eng.submit(Request(i, np.random.default_rng(i).integers(
            0, cfg.vocab_size, n).astype(np.int32), m))
    guarded = []
    while eng.queue or eng._live or eng._jobs:
        if eng._jobs:
            guarded.append(eng._guard_rows())
        eng.step()
    assert guarded and all(g is not None for g in guarded)
    assert eng.prefill_chunks >= 3
    assert [len(eng.done[i].tokens) for i in range(3)] == [13, 4, 5]
    assert eng.done[1].tokens == solo.done[1].tokens
    assert eng.block_leaks() == 0


def test_serve_direct_and_the_serve_image():
    """The serve entry point answers a trace on the smoke config with every
    request's full token count (paged, spec off), and the serve image
    pulls and builds an engine."""
    cfg = get_smoke_config(ARCH)
    stats = serve_direct(cfg, 4, 2, 128, prompt_len=(5, 100),
                         max_new_tokens=6, device=CPU)
    trace = make_trace(cfg.vocab_size, 4, max_len=128, prompt_len=(5, 100),
                       max_new_tokens=6)
    assert stats["tokens_per_request"] == {
        e["rid"]: expected_tokens(e, 128) for e in trace}
    assert stats["kv"] == "paged" and stats["spec"] == "off"
    exe = ExecutableRegistry().pull(PayloadImage(ARCH, "smoke", "serve"), CPU)
    eng = exe.fn(exe.make_inputs(0), slots=2, max_len=64)
    assert eng.kv == "paged" and eng.prefix is None
