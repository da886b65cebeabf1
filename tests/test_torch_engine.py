"""The port's serve engine: parity with the JAX engine and the invariants
the JAX tests assert bitwise (tests/test_serving_continuous.py,
tests/test_paged_kv.py), held inside the port.

Everything runs on the CPU (``device="cpu"``) at ``smollm-360m``'s smoke
config with ``attn_impl="pallas"``, ``norm_impl="pallas"`` — the kernel
wrappers' plain versions.

Engine parity tolerance: the two engines' logits differ by up to ~3e-3
(tests/test_torch_model.py holds them within 1e-2), so a greedy token can
only flip where the top-2 margin of the JAX logits is below 2e-2.  Token
streams are compared up to the first such position of each request.  The
trace has 8 requests: a random smoke model's top-2 margins are often a few
bf16 ulps, and 3 requests left only 2 positions to compare.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke
from repro.models.api import build_model as jax_build
from repro.serving.engine import ServeEngine as JaxEngine
from repro.serving.engine import make_engine_step as jax_make_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_smoke_config
from repro_torch.launch.serve import expected_tokens, make_trace
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Request, ServeEngine

ARCH = "smollm-360m"
KW = dict(attn_impl="pallas", norm_impl="pallas")
MARGIN = 2e-2


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_smoke_config(ARCH), **KW)
    jcfg = dataclasses.replace(jax_smoke(ARCH), **KW)
    jparams = jax_build(jcfg).init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return cfg, jcfg, params, jparams


def _engine(model, **kw):
    cfg, _, params, _ = model
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    return ServeEngine(cfg, params, device="cpu", **kw)


def _req(rid, plen, max_new, vocab=512, prompt=None):
    rng = np.random.default_rng(rid)
    if prompt is None:
        prompt = rng.integers(0, vocab, size=plen).astype(np.int32)
    return Request(rid=rid, prompt=prompt, max_new_tokens=max_new)


def _margin(logits_row):
    top = np.sort(np.asarray(logits_row, np.float32))[-2:]
    return float(top[1] - top[0])


# ---------------------------------------------------------------------------
# parity with the JAX engine
# ---------------------------------------------------------------------------

def test_engine_token_streams_match_jax(model, record_property):
    cfg, jcfg, params, jparams = model
    trace = make_trace(cfg.vocab_size, 8, max_len=64, seed=0)
    port = _engine(model)
    port_stats = port.run_trace(trace)

    # the JAX engine, with its prefill and step wrapped to record the top-2
    # margin of every logits row that produces a token
    jb = jax_build(jcfg)
    base_step = jax_make_step(jb, 64)
    decode = jax.jit(jb.decode)
    prefill = jax.jit(jb.prefill)
    margins: dict[int, list[float]] = {}
    holder = {}

    def prefill_fn(p, batch):
        logits, cache = prefill(p, batch)
        rid = holder["eng"].queue[0].rid          # the request being admitted
        margins[rid] = [_margin(logits[0, -1])]
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
    jax_stats = jeng.run_trace(trace)
    assert port_stats["completed"] == jax_stats["completed"] == 8

    compared = 0
    for rid, jreq in jeng.done.items():
        mine = port.done[rid].tokens
        assert len(mine) == len(jreq.tokens) == len(margins[rid])
        n = next((j for j, m in enumerate(margins[rid]) if m < MARGIN),
                 len(mine))
        assert mine[:n] == jreq.tokens[:n], (rid, n)
        compared += n
    record_property("positions_compared", compared)
    print(f"compared {compared} token positions")
    assert compared > 0


# ---------------------------------------------------------------------------
# invariants inside the port (bitwise)
# ---------------------------------------------------------------------------

def test_slot_isolation_mid_decode_admission(model):
    """A request's tokens are identical solo and beside a mid-flight
    admission."""
    solo = _engine(model)
    solo.submit(_req(0, 7, 12))
    solo.run()
    eng = _engine(model)
    eng.submit(_req(0, 7, 12))
    for _ in range(5):
        eng.step()
    eng.submit(_req(1, 13, 9))
    eng.run()
    assert eng.done[0].tokens == solo.done[0].tokens
    assert len(eng.done[1].tokens) == 10


def test_one_host_transfer_per_decode_step(model, monkeypatch):
    """The decode step reads nothing back but the packed (2, slots) tensor:
    one .cpu() per step, and no .item()/.tolist()/int()/bool() on a tensor
    inside it."""
    eng = _engine(model)
    eng.submit(_req(0, 7, 30))
    eng.submit(_req(1, 4, 30))
    eng.step()                       # admissions (prefill argmax) land here
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
    before = eng.steps
    for _ in range(6):
        eng.step()
    monkeypatch.undo()
    assert eng.steps - before == 6
    assert calls == ["cpu"] * 6, calls
    assert eng.d2h_transfers == eng.steps


def test_cancel_returns_blocks(model):
    """Cancelling a decoding request returns every block it held: after the
    engine drains, block_leaks() is 0."""
    eng = _engine(model)
    eng.submit(_req(0, 20, 30))
    eng.submit(_req(1, 5, 6))
    eng.step()
    eng.step()
    req = eng.cancel(0)
    assert req is not None and len(req.tokens) == 3
    eng.run()
    assert 1 in eng.done and 0 not in eng.done
    assert eng.block_leaks() == 0
    assert eng.cancel(0) is None


def test_drain_requests_returns_all(model):
    eng = _engine(model, slots=1)
    for i in range(3):
        eng.submit(_req(i, 5, 8))
    eng.step()
    out = eng.drain_requests()
    assert sorted(r.rid for r in out) == [0, 1, 2]
    assert eng.block_leaks() == 0


def test_prefix_hit_gives_same_tokens(model):
    """A second identical prompt maps the first's full blocks copy-free and
    yields the same tokens; the shared blocks are not written."""
    eng = _engine(model, slots=1, max_len=96)
    prompt = np.arange(2, 42).astype(np.int32)          # bucket 64
    eng.submit(_req(0, 0, 5, prompt=prompt))
    eng.run()
    hits = eng.prefix.hits
    eng.submit(_req(1, 0, 5, prompt=prompt.copy()))
    eng.step()
    assert eng.prefix.hits > hits
    shared = [b for b in eng._slot_blocks[0] if eng.allocator.refcount(b) > 1]
    assert shared
    ids = torch.tensor(shared)
    before = [leaf[k][:, ids].clone() for leaf in eng.state["cache"]
              for k in ("kp", "vp")]
    eng.run()
    after = [leaf[k][:, ids] for leaf in eng.state["cache"] for k in ("kp", "vp")]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert eng.done[0].tokens == eng.done[1].tokens
    assert eng.block_leaks() == 0


def test_max_len_eviction_and_rejection(model):
    eng = _engine(model, max_len=32)
    eng.submit(_req(0, 5, 500))          # bucket 16: evicted at pos 32
    eng.submit(_req(1, 5, 3))
    eng.submit(_req(2, 5, 4))            # refills slot 1
    stats = eng.run()
    assert len(eng.done[0].tokens) == 1 + (32 - 16)
    assert [len(eng.done[i].tokens) for i in (1, 2)] == [4, 5]
    assert stats["d2h_transfers"] == stats["decode_steps"]
    with pytest.raises(ValueError, match="admission cap"):
        eng.submit(_req(3, 32, 4))


def test_pool_pressure_defers_admission(model):
    eng = _engine(model, num_blocks=7, prefix_sharing=False)
    for i in range(4):
        eng.submit(_req(i, 12, 40))
    stats = eng.run()
    assert stats["completed"] == 4 and stats["blocked_admissions"] > 0
    assert eng.block_leaks() == 0


def test_serve_direct_answers_a_trace():
    """The serve entry point on the CPU: every request finishes with its
    full token count, one transfer per step, no leaked block."""
    from repro_torch.launch.serve import serve_direct
    cfg = get_smoke_config(ARCH)
    stats = serve_direct(cfg, 4, 2, 64, prompt_len=(5, 40), max_new_tokens=6,
                         device="cpu")
    trace = make_trace(cfg.vocab_size, 4, max_len=64, prompt_len=(5, 40),
                       max_new_tokens=6)
    assert stats["tokens_per_request"] == {
        e["rid"]: expected_tokens(e, 64) for e in trace}
    assert stats["d2h_transfers"] == stats["decode_steps"] > 0
    assert stats["block_leaks"] == 0


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_step_writes_its_state_in_place(model, kv):
    """A decode step leaves ``state["token"]``, ``state["pos"]``,
    ``active`` and ``budget`` the same tensor objects, written in place:
    the addresses a captured CUDA graph of the step replays."""
    eng = _engine(model, kv=kv)
    eng.submit(_req(0, 7, 4))
    eng.submit(_req(1, 13, 9))
    held = (eng.state, eng.state["token"], eng.state["pos"], eng.active,
            eng.budget, eng.state.get("block_tables"))
    pos0 = eng.state["pos"].clone()
    for _ in range(6):
        eng.step()
    now = (eng.state, eng.state["token"], eng.state["pos"], eng.active,
           eng.budget, eng.state.get("block_tables"))
    assert all(a is b for a, b in zip(held, now))
    assert not torch.equal(eng.state["pos"], pos0)
    assert eng.active.tolist() == [False, True]     # request 0 finished
    assert eng.budget.tolist() == [0, 9 - 6]


@pytest.mark.parametrize("kw", [dict(), dict(spec="draft")])
def test_step_graph_true_without_a_card_raises(model, kw):
    """``step_graph`` covers every function the reference compiles, the
    spec pair's draft chain and verify step included: a CUDA graph needs a
    CUDA device, so ``step_graph=True`` on the CPU raises for a spec="off"
    and a spec="draft" engine alike, and nothing runs eagerly in its
    place.  The CPU default captures nothing."""
    with pytest.raises(ValueError, match="step_graph=True needs a CUDA"):
        _engine(model, step_graph=True, **kw)
    eng = _engine(model, **kw)                      # the CPU default
    assert not eng.step_graph and eng._admit_pool is None
    assert eng._graph is None and eng._spec_graphs is None
    assert eng.spec == kw.get("spec", "off")


@pytest.mark.parametrize("kw", [dict(mesh=((2, 1), ("cpu", "cpu")))])
def test_later_slices_raise(model, kw):
    """A mesh whose data axis is above 1 serves: the engine holds a copy
    of its params and state on the second data row (more paths:
    tests/test_torch_tp.py)."""
    from repro_torch.runtime.mesh import serve_mesh
    eng = _engine(model, mesh=serve_mesh(*kw["mesh"]))
    held = eng.device_bytes()
    assert held["params"][0] == held["params"][1]
    assert held["state"][0] == held["state"][1]
    assert len(eng.params.replicas) == len(eng.state_replicas) == 1


def test_engine_rejects_params_on_another_device(model):
    cfg = model[0]
    params = build_model(cfg).init(0, device="cpu")
    with pytest.raises(ValueError, match="params live on"):
        ServeEngine(cfg, params.to("meta"), device="cpu")
