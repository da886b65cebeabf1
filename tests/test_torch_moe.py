"""The port's MoE slice against the JAX package: the grouped-matmul kernel
module, the MoE FFN (capacity dispatch and the dense-gated decode path),
and granite-moe-3b-a800m's smoke model, bridged, through prefill, paged
decode, verify and the serve engine.

Inputs are made with numpy from a seed and handed to both packages; the
parameters are the reference's own (``init_moe`` / ``build_model(cfg).init``
with a ``jax.random`` key), bridged (matrices bf16, norm scales and the
router f32).  On the CPU the port's kernel wrapper runs its plain version;
the JAX grouped matmul runs in Pallas interpret mode, as tests/test_kernels.py
runs it.

Tolerances, and why:

* grouped matmul: rtol = atol = 5e-2, those of tests/test_kernels.py for
  the same function (f32 sums of bf16 products in another order).
* MoE FFN outputs and model logits: rtol = atol = 1e-2, that of
  tests/test_torch_model.py.  The outputs are bf16 (one ulp at |y| in
  [1, 2) is 7.8e-3) and both packages round at the same points.  The
  einsum path rounds each expert product to bf16 on both sides and sums
  in another order (one ulp measured); the gmm path keeps the products in
  f32 and rounds once.
* Routing (top-k indices, positions, ``keep`` masks): identical.  Both
  sides take f32 router logits of the same bf16 inputs, and exact ties go
  to the lower expert index.
* Inside the port: paged == dense and spec == off token streams, and
  verify == sequential decode logits, bitwise.
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
from repro.kernels.grouped_matmul.ops import bucket_matmul as jax_bucket
from repro.kernels.grouped_matmul.ops import grouped_matmul as jax_gmm
from repro.kernels.grouped_matmul.ref import grouped_matmul_ref
from repro.models import moe as jmoe
from repro.models.api import build_model as jax_build
from repro.models.api import init_decode_state as jax_state
from repro.serving.engine import ServeEngine as JaxEngine
from repro.serving.engine import _install_slot_paged as jax_install
from repro.serving.engine import make_engine_step as jax_make_step
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.kernels.grouped_matmul.ops import (
    bucket_matmul, grouped_matmul, grouped_matmul_plain, pad_group_sizes)
from repro_torch.launch.serve import _on_kernels, make_trace
from repro_torch.models import moe
from repro_torch.models.api import build_model, init_decode_state
from repro_torch.serving.engine import (
    Request, ServeEngine, _install_slot_paged, admit_buckets)

ARCH = "granite-moe-3b-a800m"
GMM_TOL = dict(rtol=5e-2, atol=5e-2)
TOL = dict(rtol=1e-2, atol=1e-2)
KERNELS = dict(attn_impl="pallas", norm_impl="pallas", moe_impl="gmm")
MARGIN = 2e-2


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bf16_pair(rng, shape, scale=1.0):
    """The same bf16 values as a torch tensor and a jax array."""
    t = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale)
    t = t.to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _cfgs(**kw):
    return (dataclasses.replace(get_smoke_config(ARCH), **kw),
            dataclasses.replace(jax_smoke(ARCH), **kw))


# ---------------------------------------------------------------------------
# config and capacity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_copies_the_reference(smoke):
    mine = (get_smoke_config if smoke else get_config)(ARCH)
    ref = (jax_smoke if smoke else jax_config)(ARCH)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("max_len", [256, 1024])
def test_capacity_matches_reference_for_every_admit_bucket(max_len):
    for cfg, jcfg in ((get_config(ARCH), jax_config(ARCH)), _cfgs()):
        for S in admit_buckets(max_len):
            assert moe._capacity(cfg, S) == jmoe._capacity(jcfg, S), (
                cfg.name, S)
    if max_len == 1024:      # granite's capacities at buckets 16 ... 1023
        assert [moe._capacity(get_config(ARCH), S)
                for S in admit_buckets(1024)] == [8, 16, 24, 40, 72, 136, 256]


# ---------------------------------------------------------------------------
# grouped matmul: the kernel module against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,D,F,bm,sizes", [
    (4, 64, 128, 32, (64, 32, 96, 32)),
    (2, 128, 256, 64, (128, 64)),
    (8, 32, 64, 16, (16,) * 8),
    (3, 96, 96, 32, (0, 64, 32)),        # empty group
])
def test_grouped_matmul_matches_jax(E, D, F, bm, sizes):
    """The four cases of tests/test_kernels.py, with bm tail rows owned by
    no group: the plain version and the wrapper's CPU path against the
    JAX wrapper (Pallas interpret mode) and its f32 oracle.  The tail rows
    are exactly 0."""
    rng = np.random.default_rng(15)
    T = sum(sizes) + bm
    x, xj = _bf16_pair(rng, (T, D))
    x[sum(sizes):] = 0
    xj = xj.at[sum(sizes):].set(0)
    w, wj = _bf16_pair(rng, (E, D, F), scale=0.1)
    gs = torch.tensor(sizes, dtype=torch.int32)
    want = _f(jax_gmm(xj, wj, jnp.asarray(sizes, jnp.int32), block_m=bm,
                      block_n=32))
    oracle = _f(grouped_matmul_ref(xj, wj, jnp.asarray(sizes, jnp.int32)))
    before = grouped_matmul.launches
    for got in (grouped_matmul_plain(x, w, gs),
                grouped_matmul(x, w, gs, block_m=bm, block_n=32)):
        assert got.dtype == torch.float32 and got.shape == (T, F)
        np.testing.assert_allclose(_f(got), want, **GMM_TOL)
        np.testing.assert_allclose(_f(got), oracle, **GMM_TOL)
        assert not got[sum(sizes):].any()
    assert grouped_matmul.launches == before          # CPU: no kernel


@pytest.mark.parametrize("G,C", [(8, 8), (8, 24), (16, 40)])
def test_bucket_matmul_matches_jax(G, C):
    """Capacity buckets (G, C, D), bucket g on expert g % E: G = E is the
    reference's layout, G = 2E two examples' buckets in one call; C = 24
    and 40 are capacities no 16-row tile divides."""
    E, D, F = 8, 64, 32
    rng = np.random.default_rng(G + C)
    b, bj = _bf16_pair(rng, (G, C, D))
    w, wj = _bf16_pair(rng, (E, D, F), scale=0.1)
    got = _f(bucket_matmul(b, w))
    want = np.concatenate([_f(jax_bucket(bj[i:i + E], wj))
                           for i in range(0, G, E)])
    np.testing.assert_allclose(got, want, **GMM_TOL)


def test_pad_group_sizes_matches_reference():
    from repro.kernels.grouped_matmul.ops import pad_group_sizes as jax_pad
    sizes = np.array([0, 1, 16, 17, 40], np.int32)
    np.testing.assert_array_equal(
        pad_group_sizes(torch.from_numpy(sizes), 16).numpy(),
        np.asarray(jax_pad(jnp.asarray(sizes), 16)))


def test_grouped_matmul_refuses_bad_groups_and_devices():
    x = torch.zeros((16, 8), dtype=torch.bfloat16)
    w = torch.zeros((4, 8, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of E"):
        grouped_matmul(x, w, torch.tensor([8, 8, 0], dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel"):
        grouped_matmul(x.to("meta"), w.to("meta"),
                       torch.zeros(4, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        bucket_matmul(x.reshape(4, 4, 8).to("meta"), w.to("meta"))


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_params():
    """The reference's ``init_moe`` parameters and their bridged copies
    (router f32, expert matrices bf16, as ``params_from_numpy`` stores
    them)."""
    _, jcfg = _cfgs()
    jp = jmoe.init_moe(jax.random.key(3), jcfg)
    p = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k == "router" else torch.bfloat16)
        for k, v in jp.items()}
    return jp, p


def _x(seed, shape):
    return _bf16_pair(np.random.default_rng(seed), shape)


@pytest.mark.parametrize("moe_impl", ["einsum", "gmm"])
def test_apply_moe_matches_jax(moe_params, moe_impl):
    """Capacity dispatch of two examples of 40 tokens (C = 32, so some
    assignments drop), each expert path against its reference path."""
    cfg, jcfg = _cfgs(moe_impl=moe_impl)
    jp, p = moe_params
    x, xj = _x(0, (2, 40, cfg.d_model))
    out, aux = moe.apply_moe(x, p, cfg)
    jout, jaux = jmoe.apply_moe(xj, jp, jcfg)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    np.testing.assert_allclose(_f(out), _f(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_apply_moe_dense_matches_jax(moe_params):
    cfg, jcfg = _cfgs()
    jp, p = moe_params
    x, xj = _x(1, (3, 5, cfg.d_model))
    out, aux = moe.apply_moe_dense(x, p, cfg)
    jout, _ = jmoe.apply_moe_dense(xj, jp, jcfg)
    np.testing.assert_allclose(_f(out), _f(jout), **TOL)
    assert float(aux) == 0.0


def _jax_routing(xj, jp, jcfg, C):
    probs = jmoe.router_probs(xj, jp["router"])
    wts, idx = jax.lax.top_k(probs, jcfg.moe.top_k)
    E = jcfg.moe.num_experts
    metas = [jmoe._dispatch_one(xj[b], idx[b], wts[b], E, C)[1]
             for b in range(xj.shape[0])]
    return (np.asarray(idx), np.stack([np.asarray(m[1]) for m in metas]),
            np.stack([np.asarray(m[2]) for m in metas]))


def _left_padded(cfg, n_pad, n_real, seed):
    """Hidden rows of a left-padded prompt as the first MoE layer sees
    them: the pad rows (token 0) are identical."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n_real + 1, cfg.d_model)).astype(np.float32)
    x = np.concatenate([np.repeat(rows[:1], n_pad, 0), rows[1:]])[None]
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("case", ["random", "zero_router", "left_padded"])
def test_routing_and_drops_match_jax(moe_params, case):
    """Identical top-k indices, capacity positions and keep masks.  The
    zeroed router makes every probability equal (ties go to the lower
    expert).  The left-padded prompt has 56 identical pad rows against
    C = 48: the pads pick the same k experts, come first in the cumsum,
    fill those experts, and every later assignment to them (pad or real
    token) is dropped — the reference's behaviour, kept."""
    cfg, jcfg = _cfgs()
    jp, p = moe_params
    if case == "left_padded":
        x, xj = _left_padded(cfg, 56, 8, seed=4)
    else:
        x, xj = _x(2, (2, 64, cfg.d_model))
    if case == "zero_router":
        p = {**p, "router": torch.zeros_like(p["router"])}
        jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    S, k = x.shape[1], cfg.moe.top_k
    C = moe._capacity(cfg, S)
    _, idx = moe.top_k(moe.router_probs(x, p["router"]), k)
    _, (_, pos_c, keep) = moe._dispatch(x, idx, cfg.moe.num_experts, C)
    j_idx, j_pos, j_keep = _jax_routing(xj, jp, jcfg, C)
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    np.testing.assert_array_equal(pos_c.numpy(), j_pos)
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    if case == "zero_router":
        assert (idx == torch.arange(k)).all()
    if case == "left_padded":
        assert C == 48 and not keep.all()
        pad_experts = set(idx[0, 0].tolist())
        assert all(set(r.tolist()) == pad_experts for r in idx[0, :56])
        kept = keep[0].reshape(S, k)
        assert kept[:48].all() and not kept[48:56].any()
        for s in range(56, S):           # real tokens on the pads' experts
            for j in range(k):
                if int(idx[0, s, j]) in pad_experts:
                    assert not kept[s, j]


def test_aux_loss_uniform_router_is_the_aux_weight(moe_params):
    """With a zeroed router the Switch aux loss is router_aux_weight (the
    reference's test_moe_aux_loss_uniform_router_is_one), and equal to the
    reference's."""
    cfg, jcfg = _cfgs()
    jp, p = moe_params
    p = {**p, "router": torch.zeros_like(p["router"])}
    jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    x, xj = _x(5, (1, 64, cfg.d_model))
    _, aux = moe.apply_moe(x, p, cfg)
    _, jaux = jmoe.apply_moe(xj, jp, jcfg)
    np.testing.assert_allclose(float(aux), cfg.moe.router_aux_weight,
                               rtol=0.15)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_router_stays_f32_in_the_port_init():
    params = build_model(get_smoke_config(ARCH)).init(0, device="cpu")
    ffn = params.layers[0]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert {ffn[k].dtype for k in ("up", "gate", "down")} == {torch.bfloat16}
    assert tuple(ffn["up"].shape) == (2, 8, 64, 32)      # (n_groups, E, D, F)


def test_serve_entry_runs_the_kernels():
    cfg = _on_kernels(get_config(ARCH))
    assert (cfg.attn_impl, cfg.norm_impl, cfg.moe_impl) == (
        "pallas", "pallas", "gmm")


# ---------------------------------------------------------------------------
# the model: bridge, prefill + teacher-forced paged decode, verify
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_tree():
    _, jcfg = _cfgs(**KERNELS)
    return jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.key(0)))


def test_bridge_round_trip_is_exact_and_router_stays_f32(ref_tree):
    """The router and norm scales come back bit for bit (f32 both ways);
    a tree of bf16 matrices round-trips exactly."""
    cfg, _ = _cfgs(**KERNELS)
    params = params_from_numpy(ref_tree, cfg, device="cpu")
    ffn = params.layers[0]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["up"].dtype == torch.bfloat16
    back = params_to_numpy(params)
    np.testing.assert_array_equal(back["layers"][0]["ffn"]["router"],
                                  ref_tree["layers"][0]["ffn"]["router"])
    bf16_tree = jax.tree_util.tree_map_with_path(
        lambda path, a: a if (a.ndim == 1 or "router" in
                              jax.tree_util.keystr(path))
        else np.asarray(jnp.asarray(a, jnp.bfloat16)), ref_tree)
    again = params_to_numpy(params_from_numpy(bf16_tree, cfg, device="cpu"))
    assert jax.tree.structure(again) == jax.tree.structure(bf16_tree)
    for got, want in zip(jax.tree.leaves(again), jax.tree.leaves(bf16_tree)):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


SLOTS, MAX_LEN, BS = 2, 64, 16
PROMPTS = [(0, 23), (1, 9)]                 # (slot, prompt length)
ROWS = [[3, 7, 1, 5], [6, 2, 8, 4]]         # permuted physical blocks


def _forced(vocab, steps, seed=0):
    rng = np.random.default_rng(seed)
    prompts = []
    for _slot, n in PROMPTS:
        plen = 16 if n <= 16 else 32                 # admit_length buckets
        toks = np.zeros((plen,), np.int32)
        toks[-n:] = rng.integers(0, vocab, size=n)   # left-padded
        prompts.append(toks)
    return {"prompts": prompts,
            "decode": rng.integers(0, vocab, size=(steps, SLOTS)).astype(np.int32)}


def _port_state(cfg, bundle, params, forced):
    state = init_decode_state(cfg, SLOTS, MAX_LEN, block_size=BS, device="cpu")
    logits = []
    for (slot, plen), toks in zip(PROMPTS, forced["prompts"]):
        lg, cache = bundle.prefill(params, {"tokens": torch.from_numpy(toks[None])})
        logits.append(_f(lg[0, -1]))
        _install_slot_paged(state, cache, slot, len(toks), 0, ROWS[slot], 0, BS)
    return state, logits


def _run_port(cfg, tree, steps, forced):
    bundle = build_model(cfg)
    params = params_from_numpy(tree, cfg, device="cpu")
    state, prefill_logits = _port_state(cfg, bundle, params, forced)
    out = []
    for t in range(steps):
        state["token"] = torch.from_numpy(forced["decode"][t][:, None].copy())
        logits, state = bundle.decode(params, state)
        out.append(_f(logits[:, 0]))
    return np.stack(prefill_logits), np.stack(out)


def _run_jax(jcfg, tree, steps, forced):
    bundle = jax_build(jcfg)
    params = jax.tree.map(jnp.asarray, tree)
    state = jax_state(jcfg, SLOTS, MAX_LEN, kv="paged", block_size=BS)
    prefill = jax.jit(bundle.prefill)
    prefill_logits = []
    for (slot, _n), toks in zip(PROMPTS, forced["prompts"]):
        logits, cache = prefill(params, {"tokens": jnp.asarray(toks[None])})
        prefill_logits.append(_f(logits[0, -1]))
        state = jax_install(state, cache, slot, len(toks), 0, ROWS[slot], 0, BS)
    decode = jax.jit(bundle.decode)
    out = []
    for t in range(steps):
        state = {**state, "token": jnp.asarray(forced["decode"][t][:, None])}
        logits, state = decode(params, state)
        out.append(_f(logits[:, 0]))
    return np.stack(prefill_logits), np.stack(out)


def test_slice_logits_match_jax(ref_tree):
    """Prefill of two left-padded prompts (capacity dispatch through the
    grouped matmul) plus 8 teacher-forced paged decode steps (dense-gated
    MoE): the port's logits match the reference's, with the kernel paths
    (attn/norm "pallas", moe "gmm") selected on both sides."""
    cfg, jcfg = _cfgs(**KERNELS)
    forced = _forced(cfg.vocab_size, 8)
    pp, pd = _run_port(cfg, ref_tree, 8, forced)
    jp, jd = _run_jax(jcfg, ref_tree, 8, forced)
    np.testing.assert_allclose(pp, jp, **TOL)
    np.testing.assert_allclose(pd, jd, **TOL)


def test_verify_is_bitwise_sequential_decode(ref_tree):
    """One verify forward of [pending, 4 forced tokens] gives at every
    position bitwise the logits of the 5 decode steps it replaces: the
    dense-gated MoE runs every expert on B*S rows in verify and on B rows
    in decode, and the CPU's matmuls give a row the same bits at both."""
    cfg, _ = _cfgs(**KERNELS)
    bundle = build_model(cfg)
    params = params_from_numpy(ref_tree, cfg, device="cpu")
    forced = _forced(cfg.vocab_size, 0, seed=3)
    state, _ = _port_state(cfg, bundle, params, forced)
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(SLOTS, 5)).astype(np.int32)
    snap = {**state, "cache": [{k: v.clone() for k, v in leaf.items()}
                               for leaf in state["cache"]]}
    vlogits, _ = bundle.verify(params, torch.from_numpy(tokens), snap)
    steps = []
    for s in range(5):
        state["token"] = torch.from_numpy(tokens[:, s:s + 1].copy())
        logits, state = bundle.decode(params, state)
        steps.append(logits[:, 0])
    assert torch.equal(vlogits, torch.stack(steps, dim=1))


# ---------------------------------------------------------------------------
# the serve engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_model():
    cfg, jcfg = _cfgs(**KERNELS)
    jparams = jax_build(jcfg).init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return cfg, jcfg, params, jparams


def _margin(row):
    top = np.sort(np.asarray(row, np.float32))[-2:]
    return float(top[1] - top[0])


def test_engine_token_streams_match_jax(engine_model, record_property):
    """An 8-request trace through both engines (2 slots, max_len 64):
    streams compared up to each request's first position whose JAX top-2
    logit margin is below 2e-2 (tests/test_torch_engine.py's rule)."""
    cfg, jcfg, params, jparams = engine_model
    trace = make_trace(cfg.vocab_size, 8, max_len=64, seed=0)
    port = ServeEngine(cfg, params, slots=2, max_len=64, device="cpu")
    port.run_trace(trace)

    jb = jax_build(jcfg)
    base_step = jax_make_step(jb, 64)
    decode, prefill = jax.jit(jb.decode), jax.jit(jb.prefill)
    margins: dict[int, list[float]] = {}
    holder = {}

    def prefill_fn(p, batch):
        logits, cache = prefill(p, batch)
        margins[holder["eng"].queue[0].rid] = [_margin(logits[0, -1])]
        return logits, cache

    def step_fn(p, state, active, budget):
        logits, _ = decode(p, state)
        rows = np.asarray(logits[:, -1], np.float32)
        for si, m in enumerate(holder["eng"].slot_meta):
            if m.active:
                margins[m.rid].append(_margin(rows[si]))
        return base_step(p, state, active, budget)

    jeng = JaxEngine(jcfg, jparams, slots=2, max_len=64, bundle=jb,
                     step_fn=step_fn, prefill_fn=prefill_fn)
    holder["eng"] = jeng
    jeng.run_trace(trace)
    compared = 0
    for rid, jreq in jeng.done.items():
        mine = port.done[rid].tokens
        assert len(mine) == len(jreq.tokens) == len(margins[rid])
        n = next((j for j, m in enumerate(margins[rid]) if m < MARGIN),
                 len(mine))
        assert mine[:n] == jreq.tokens[:n], (rid, n)
        compared += n
    record_property("positions_compared", compared)
    assert compared > 0


def _reqs(n=5, vocab=500):
    rng = np.random.default_rng(0)
    lens = [7, 20, 3, 31, 12, 25]
    buds = [9, 13, 17, 5, 11, 7]
    return [Request(rid=i, prompt=rng.integers(1, vocab, size=lens[i % 6])
                    .astype(np.int32), max_new_tokens=buds[i % 6])
            for i in range(n)]


def _streams(engine_model, **kw):
    cfg, _, params, _ = engine_model
    eng = ServeEngine(cfg, params, slots=3, max_len=64, device="cpu", **kw)
    for r in _reqs():
        eng.submit(r)
    stats = eng.run()
    assert eng.d2h_transfers == eng.steps and eng.block_leaks() == 0
    return {rid: r.tokens for rid, r in eng.done.items()}, stats


@pytest.mark.parametrize("variant", ["dense", "spec_self"])
def test_engine_variants_bitwise_equal_paged_spec_off(engine_model, variant):
    """On the MoE model: dense-KV decode gives the paged engine's streams
    bitwise, and self-draft speculation gives spec="off" streams (greedy
    acceptance; verify is bitwise the sequential decode)."""
    base, _ = _streams(engine_model)
    if variant == "dense":
        got, stats = _streams(engine_model, kv="dense")
        assert stats["kv"] == "dense"
    else:
        got, stats = _streams(engine_model, spec="draft", spec_k=4)
        assert stats["spec"] == "draft" and stats["acceptance_rate"] > 0.5
    assert got == base
