"""The port's disaggregated prefill/decode serving: every test of
tests/test_disagg.py for smollm-360m (GQA) and minicpm3-4b (MLA) inside
the port, the port's handoffs against the JAX package's, and wave
admission.

Everything runs on the CPU at the smoke configs with the serve entry's
kernel flags (``attn_impl="pallas"``, ``norm_impl="pallas"``: the port's
wrappers on their plain versions, the reference's kernels in Pallas
interpret mode).

Tolerances, and why:

* Inside the port: streams bitwise (a decode-role engine that imports a
  prefill-role engine's handoff holds exactly the state a unified engine
  holds after admission), pools after an import bitwise.
* The port's export against the reference's, on bridged parameters and
  the same prompts: ``rid``, ``plen``, ``first_token`` and
  ``block_hashes`` exactly; each KV buffer within rtol = atol = 2e-2
  (``POOL_TOL``, the KV-write tolerance of tests/test_torch_model.py and
  tests/test_torch_mla.py: one bf16 ulp at |x| ~ 4, the rows being bf16
  products of the two libraries' flash paths).
* A reference handoff carried into the port (`handoff_from_reference`)
  and imported by a decode-role engine: the pool rows bitwise equal to
  the reference's buffers.
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke
from repro.models.api import build_model as jax_build
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch.bridge import handoff_from_reference, params_from_numpy
from repro_torch.configs.base import get_smoke_config
from repro_torch.core.images import ExecutableRegistry, PayloadImage
from repro_torch.launch.serve import (
    build_engine, make_bursty_schedule, make_trace, serve_disagg,
    serve_disagg_schedule)
from repro_torch.models.api import build_model
from repro_torch.serving.dispatch import DisaggRouter, FleetDispatcher
from repro_torch.serving.engine import (
    Request, ServeEngine, handoff_ineligible_reason)

ARCHS = ["smollm-360m", "minicpm3-4b"]        # GQA and MLA families
KW = dict(attn_impl="pallas", norm_impl="pallas")
POOL_TOL = dict(rtol=2e-2, atol=2e-2)
CPU = "cpu"

_MODELS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_op():
    """The fleets here run four engines on pilot threads in this process,
    beside the test run's other workers: at smoke widths an op gains
    nothing from intra-op threads, and four servers x every core
    oversubscribe the CPU into ticks longer than the 0.5 s lease (a
    replacement server's warm-up beside them most of all), so leases
    expire until a request's attempt budget runs out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_params(arch):
    """The port's smoke config on the kernel flags and its seed-0 params
    (cached per arch: engines never write their params)."""
    if arch not in _MODELS:
        cfg = dataclasses.replace(get_smoke_config(arch), **KW)
        _MODELS[arch] = (cfg, build_model(cfg).init(0, device=CPU))
    return _MODELS[arch]


def _engine(arch, **kw):
    cfg, params = _cfg_params(arch)
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    return ServeEngine(cfg, params, device=CPU, **kw)


def _reqs(vocab, n, seed=0, plen_lo=4, plen_hi=28, mnt=(5, 9)):
    # plen < 29 keeps the admission bucket <= 32, so bucket + budget fits
    # max_len=64 and every stream runs its FULL decode budget
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(plen_lo, plen_hi))
        out.append((i, rng.integers(0, vocab, size=plen,
                                    dtype=np.int64).astype(np.int32),
                    int(rng.choice(mnt))))
    return out


def _submit_all(eng, reqs, cls=Request, **kw):
    for rid, prompt, mnt in reqs:
        eng.submit(cls(rid=rid, prompt=prompt, max_new_tokens=mnt, **kw))


def _unified_streams(arch, reqs, **kw):
    uni = _engine(arch, **kw)
    _submit_all(uni, reqs)
    uni.run()
    return {rid: uni.done[rid].tokens for rid, _, _ in reqs}


def _disagg_streams(pf, dc, reqs) -> dict[int, list]:
    """Drive requests through a prefill-role engine, carry every exported
    handoff into a decode-role engine, and return the resumed streams."""
    exported0, imported0 = pf.prefills_exported, dc.handoffs_imported
    _submit_all(pf, reqs)
    pf.run()
    assert pf.prefills_exported - exported0 == len(reqs)
    for rid, prompt, mnt in reqs:
        h = pf.done[rid].handoff
        assert h is not None and h.first_token == pf.done[rid].tokens[0]
        dc.submit(Request(rid=rid, prompt=prompt, max_new_tokens=mnt,
                          handoff=h))
    dc.run()
    assert dc.handoffs_imported - imported0 == len(reqs)
    return {rid: dc.done[rid].tokens for rid, _, _ in reqs}


# ---------------------------------------------------------------------------
# the reference's engine-pair tests, in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefill", ["oneshot", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_disagg_bitwise_parity_vs_unified(arch, prefill):
    """A chunked prefill role exports at its last chunk, bitwise the
    unified chunked engine's streams."""
    cfg, _ = _cfg_params(arch)
    reqs = _reqs(cfg.vocab_size, 6, seed=1)
    ref = _unified_streams(arch, reqs, prefill=prefill)
    pf = _engine(arch, role="prefill", prefill=prefill)
    dc = _engine(arch, role="decode")
    got = _disagg_streams(pf, dc, reqs)
    assert got == ref                      # bitwise: same tokens, all rids
    for rid, _, mnt in reqs:
        assert len(got[rid]) == mnt + 1    # admission token + decode budget
    assert pf.block_leaks() == 0 and dc.block_leaks() == 0
    assert pf.steps == 0 and dc.prefill_chunks == 0
    assert pf._graph is None and pf._step_fn is None
    assert dc._prefill is None and dc._chunk_fn is None


@pytest.mark.parametrize("arch", ARCHS)
def test_refcount_balance_and_zero_leaks_after_churn(arch):
    """Shared prefixes crossing the handoff, several waves of churn: every
    block returns to both pools (the exporter frees at export, the
    importer at eviction; the prefix caches hold only reclaimable refs)."""
    cfg, _ = _cfg_params(arch)
    pf = _engine(arch, role="prefill")
    dc = _engine(arch, role="decode")
    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab_size, size=40,
                          dtype=np.int64).astype(np.int32)
    rid = 0
    for wave in range(3):
        reqs = []
        for i in range(4):
            if i % 2 == 0:                 # shared 40-token prefix + tail
                tail = rng.integers(0, cfg.vocab_size, size=4,
                                    dtype=np.int64).astype(np.int32)
                prompt = np.concatenate([shared, tail])
            else:
                prompt = rng.integers(0, cfg.vocab_size, size=9,
                                      dtype=np.int64).astype(np.int32)
            reqs.append((rid, prompt, 5))
            rid += 1
        _disagg_streams(pf, dc, reqs)
    assert pf.block_leaks() == 0
    assert dc.block_leaks() == 0
    assert pf.allocator.available_blocks == pf.allocator.capacity_blocks
    assert dc.allocator.available_blocks == dc.allocator.capacity_blocks


@pytest.mark.parametrize("arch", ARCHS)
def test_imported_blocks_republish_into_decode_prefix_cache(arch):
    """The handoff's chain-hash keys let the decode pool republish the
    imported full blocks: a second stream with the same prompt prefix HITS
    in the decode pool's own PrefixCache, bitwise all the same."""
    cfg, _ = _cfg_params(arch)
    rng = np.random.default_rng(11)
    shared = rng.integers(0, cfg.vocab_size, size=40,
                          dtype=np.int64).astype(np.int32)
    reqs = [(i, shared.copy(), 5) for i in range(3)]
    ref = _unified_streams(arch, reqs)
    pf = _engine(arch, role="prefill")
    dc = _engine(arch, role="decode")
    got = _disagg_streams(pf, dc, reqs)
    assert got == ref
    assert dc.prefix is not None and dc.prefix.hits > 0
    assert dc.block_leaks() == 0 and pf.block_leaks() == 0


def test_handoff_fingerprint_mismatch_rejected():
    """A GQA pool's handoff does not scatter into an MLA pool (different
    paged leaves entirely): submit refuses it on the fingerprint."""
    gqa_cfg, _ = _cfg_params("smollm-360m")
    pf = _engine("smollm-360m", role="prefill")
    reqs = _reqs(gqa_cfg.vocab_size, 1, seed=2)
    _submit_all(pf, reqs)
    pf.run()
    h = pf.done[0].handoff
    dc = _engine("minicpm3-4b", role="decode")
    with pytest.raises(ValueError, match="fingerprint"):
        dc.submit(Request(rid=0, prompt=reqs[0][1], max_new_tokens=4,
                          handoff=h))
    assert pf.block_leaks() == 0


def test_role_validation_and_spec_forced_off():
    cfg, _ = _cfg_params("smollm-360m")
    pf = _engine("smollm-360m", role="prefill")
    dc = _engine("smollm-360m", role="decode")
    # a decode-role engine only accepts handoff-carrying requests
    with pytest.raises(ValueError, match="handoff"):
        dc.submit(Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                          max_new_tokens=2))
    # a prefill-role engine never imports
    _submit_all(pf, _reqs(cfg.vocab_size, 1, seed=3))
    pf.run()
    h = pf.done[0].handoff
    with pytest.raises(ValueError):
        pf.submit(Request(rid=1, prompt=np.arange(4, dtype=np.int32),
                          max_new_tokens=2, handoff=h))
    # and neither does a unified one
    with pytest.raises(ValueError, match="only role='decode'"):
        _engine("smollm-360m").submit(Request(
            rid=1, prompt=np.arange(4, dtype=np.int32), max_new_tokens=2,
            handoff=h))
    # draft KV does not ride the handoff: spec is forced off per role
    for role in ("prefill", "decode"):
        sp = _engine("smollm-360m", role=role, spec="draft")
        assert sp.spec == "off" and "role" in sp.spec_fallback_reason
    with pytest.raises(ValueError, match="role must be"):
        _engine("smollm-360m", role="both")
    with pytest.raises(ValueError, match="admission must be"):
        _engine("smollm-360m", admission="static")
    # a prefill role has no step to capture, but its admissions are
    # graphed on a card like any engine's: on the CPU step_graph=True raises
    with pytest.raises(ValueError, match="needs a CUDA device"):
        _engine("smollm-360m", role="prefill", step_graph=True)


@pytest.mark.parametrize("arch, kw, why", [
    ("mamba2-370m", {}, "SSM state rows"),
    ("jamba-v0.1-52b", {}, "SSM state rows"),
    ("mixtral-8x7b", {}, "SWA ring rows"),
    ("whisper-small", {}, "enc-dec"),
    ("smollm-360m", dict(kv="dense"), "kv='dense'"),
], ids=["mamba2", "jamba", "mixtral", "whisper", "dense"])
@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_split_roles_refused(arch, kw, why, role):
    """Per-row state (SSM rows, SWA rings), an encoder-decoder and the
    dense layout have no block chain to hand off: a split role raises
    with the reference's reason, and the unified role does not need it."""
    cfg = get_smoke_config(arch)
    kv = kw.get("kv", "paged")
    assert why in handoff_ineligible_reason(cfg, kv)
    params = build_model(cfg).init(0, device=CPU)
    with pytest.raises(ValueError, match="needs the KV block handoff"):
        ServeEngine(cfg, params, slots=2, max_len=64, role=role,
                    device=CPU, **kw)
    assert handoff_ineligible_reason(_cfg_params("smollm-360m")[0],
                                     "paged") is None


def test_payload_image_role_in_key_and_factory():
    img_u = PayloadImage("smollm-360m", "smoke", "serve", flags=tuple(
        KW.items()))
    img_p = dataclasses.replace(img_u, role="prefill")
    img_d = dataclasses.replace(img_u, role="decode")
    assert len({img_u.key(), img_p.key(), img_d.key()}) == 3
    reg = ExecutableRegistry()
    exe = reg.pull(img_p, CPU)
    eng = exe.fn(exe.make_inputs(0))
    # a prefill-only image never wires the decode step
    assert eng.role == "prefill"
    assert eng._step_fn is None and eng._prefill is not None
    assert eng._graph is None
    exe.warm()
    exe_d = reg.pull(img_d, CPU)
    eng_d = exe_d.fn(exe_d.make_inputs(0))
    assert eng_d.role == "decode"
    assert eng_d._prefill is None and eng_d._step_fn is not None
    exe_d.warm()                 # the import scatter and the step
    # the kernels each role's image loads on a card
    from repro_torch.core.images import _kernel_sources
    cfg = img_u.config()
    assert _kernel_sources(cfg, "prefill") == ["flash_prefill", "rmsnorm"]
    assert _kernel_sources(cfg, "decode") == ["paged_decode", "rmsnorm"]
    mla = dataclasses.replace(get_smoke_config("minicpm3-4b"), **KW)
    assert _kernel_sources(mla, "decode") == ["rmsnorm"]


def test_decode_warm_install_runs_dummy_handoffs():
    """A decode server warms through zero-KV handoffs of every bucket,
    then zeroes its metrics and holds no block."""
    dc = _engine("smollm-360m", role="decode")
    dc.warm_admission()                    # nothing to warm: no prefill
    dc.warm_install()
    st = dc._stats(0, 1.0)
    assert st["handoffs_imported"] == 0 and st["decode_steps"] == 0
    assert st["handoff_import_ms"] == [] and not dc.done
    assert dc.block_leaks() == 0


# ---------------------------------------------------------------------------
# the handoff's one host pull, and the import's in-place writes
# ---------------------------------------------------------------------------

def test_export_makes_one_host_pull(monkeypatch):
    """Each export gathers every layer into one device buffer and pulls it
    to the host once (one ``Tensor.cpu`` call), whatever the layer count;
    its ``nbytes`` is the true wire size of the pools' bf16 bits."""
    cfg, _ = _cfg_params("smollm-360m")
    pf = _engine("smollm-360m", role="prefill")
    real = torch.Tensor.cpu
    pulls = []

    def counting(self, *a, **kw):
        pulls.append(tuple(self.shape))
        return real(self, *a, **kw)

    reqs = _reqs(cfg.vocab_size, 3, seed=4)
    _submit_all(pf, reqs)
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    pf.run()
    monkeypatch.undo()
    assert len(pulls) == len(reqs)
    for rid, prompt, _ in reqs:
        h = pf.done[rid].handoff
        kv = pf.state["cache"][0]["kp"]
        per_block = kv[:, 0].numel() * kv.element_size()
        assert h.nbytes == 2 * per_block * h.n_prompt_blocks
        assert all(b.dtype == np.int16 for leaf in h.blocks
                   for b in leaf.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_import_writes_in_place(arch):
    """The import writes the decode engine's pools, block table, token and
    position in place (a captured step replays their addresses): every
    leaf keeps its storage, and the written rows hold the handoff's bits."""
    cfg, _ = _cfg_params(arch)
    pf = _engine(arch, role="prefill")
    dc = _engine(arch, role="decode")
    reqs = _reqs(cfg.vocab_size, 1, seed=5)
    _submit_all(pf, reqs)
    pf.run()
    h = pf.done[0].handoff
    leaves = [t for leaf in dc.state["cache"] for t in leaf.values()]
    leaves += [dc.state[k] for k in ("token", "pos", "block_tables")]
    leaves += [dc.active, dc.budget]
    before = [(t, t.data_ptr()) for t in leaves]
    dc.submit(Request(rid=0, prompt=reqs[0][1], max_new_tokens=reqs[0][2],
                      handoff=h))
    dc._admit()
    assert all(t is u and t.data_ptr() == p
               for (t, p), u in zip(before, leaves))
    si = next(i for i, m in enumerate(dc.slot_meta) if m.rid == 0)
    row = dc._slot_blocks[si][:h.n_prompt_blocks]
    for leaf, hb in zip(dc.state["cache"], h.blocks):
        for k, buf in hb.items():
            got = leaf[k][:, row].view(torch.int16).numpy()
            np.testing.assert_array_equal(got, buf)
    assert int(dc.state["pos"][si]) == h.plen
    assert int(dc.state["token"][si, 0]) == h.first_token
    assert dc.state["block_tables"][si, :len(row)].tolist() == row


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

_REF: dict = {}


def _ref_model(arch):
    """(cfg, jcfg, bridged port params, jax params) from jax key 0."""
    if arch not in _REF:
        cfg, _ = _cfg_params(arch)
        jcfg = dataclasses.replace(jax_smoke(arch), **KW)
        jparams = jax_build(jcfg).init(jax.random.key(0))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   device=CPU)
        _REF[arch] = (cfg, jcfg, params, jparams)
    return _REF[arch]


def _ref_exports(arch, reqs):
    cfg, jcfg, params, jparams = _ref_model(arch)
    jpf = JaxEngine(jcfg, jparams, slots=2, max_len=64, role="prefill")
    _submit_all(jpf, reqs, cls=JaxRequest)
    jpf.run()
    return {rid: jpf.done[rid].handoff for rid, _, _ in reqs}


@pytest.mark.parametrize("arch", ARCHS)
def test_export_matches_reference(arch):
    cfg, jcfg, params, _ = _ref_model(arch)
    reqs = _reqs(cfg.vocab_size, 3, seed=6)
    want = _ref_exports(arch, reqs)
    pf = ServeEngine(cfg, params, slots=2, max_len=64, role="prefill",
                     device=CPU)
    _submit_all(pf, reqs)
    pf.run()
    for rid, _, _ in reqs:
        got, ref = pf.done[rid].handoff, want[rid]
        assert (got.rid, got.plen, got.first_token, got.block_hashes) == \
            (ref.rid, ref.plen, ref.first_token, ref.block_hashes)
        assert got.fingerprint == handoff_from_reference(ref).fingerprint
        for leaf, jleaf in zip(got.blocks, ref.blocks):
            assert leaf.keys() == jleaf.keys()
            for k, buf in leaf.items():
                mine = torch.from_numpy(buf).view(torch.bfloat16).float()
                np.testing.assert_allclose(
                    mine.numpy(), np.asarray(jleaf[k], np.float32),
                    **POOL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_handoff_imports_bitwise(arch):
    """A reference handoff, carried in by `handoff_from_reference` and
    imported by a port decode-role engine, leaves the pool rows bitwise
    the reference's buffers; the stream resumes from its first token."""
    cfg, _, params, _ = _ref_model(arch)
    reqs = _reqs(cfg.vocab_size, 2, seed=8)
    want = _ref_exports(arch, reqs)
    dc = ServeEngine(cfg, params, slots=2, max_len=64, role="decode",
                     device=CPU)
    for rid, prompt, mnt in reqs:
        h = handoff_from_reference(want[rid])
        assert h.nbytes == want[rid].nbytes
        dc.submit(Request(rid=rid, prompt=prompt, max_new_tokens=mnt,
                          handoff=h))
    dc._admit()
    for si, m in enumerate(dc.slot_meta):
        ref = want[m.rid]
        row = dc._slot_blocks[si][:ref.n_prompt_blocks]
        for leaf, jleaf in zip(dc.state["cache"], ref.blocks):
            for k, jbuf in jleaf.items():
                got = leaf[k][:, row].view(torch.int16).numpy()
                np.testing.assert_array_equal(
                    got, np.asarray(jbuf).view(np.int16))
    dc.run()
    for rid, _, mnt in reqs:
        toks = dc.done[rid].tokens
        assert toks[0] == want[rid].first_token and len(toks) == mnt + 1
    assert dc.block_leaks() == 0


# ---------------------------------------------------------------------------
# DisaggRouter: two-stage leases with manual fake servers
# ---------------------------------------------------------------------------

def test_router_forwards_handoff_with_original_submit_time():
    r = DisaggRouter(name="pt-fwd", lease_ttl=1.0)
    try:
        r.submit({"rid": 0, "prompt": [1, 2, 3], "max_new_tokens": 4})
        r.seal()
        (e,) = r.prefill.fetch("pf-0", max_n=1, timeout=2.0)
        h = object()                       # sentinel handoff payload
        assert r.prefill.complete("pf-0", 0, [7], first_token_s=0.01,
                                  handoff=h)
        (d,) = r.decode.fetch("dc-0", max_n=1, timeout=2.0)
        assert d["rid"] == 0
        assert d["handoff"] is h           # the payload rides the arena
        # end-to-end TTFT: the ORIGINAL submit time, not the forward's
        assert d["submitted_s"] == e["submitted_s"]
        assert d["prefill_server"] == "pf-0"
        assert r.decode.complete("dc-0", 0, [7, 8, 9])
        assert r.wait_all(timeout=10.0)
        assert r.results() == {0: [7, 8, 9]}
        st = r.stats()
        assert st["prefill"]["completed"] == 1
        assert st["decode"]["completed"] == 1
    finally:
        r.close()


def test_router_decode_requeue_replays_from_handoff():
    """A dead decode pilot's lease expires and the SAME handoff re-leases
    to a survivor: the prompt is never prefilled again."""
    r = DisaggRouter(name="pt-requeue", lease_ttl=0.25)
    try:
        r.submit({"rid": 0, "prompt": [1, 2, 3], "max_new_tokens": 4})
        r.seal()
        r.prefill.fetch("pf-0", max_n=1, timeout=2.0)
        h = object()
        r.prefill.complete("pf-0", 0, [5], handoff=h)
        (d1,) = r.decode.fetch("dc-dead", max_n=1, timeout=2.0)
        assert d1["handoff"] is h
        got = []
        deadline = time.monotonic() + 10.0
        while not got and time.monotonic() < deadline:
            got = r.decode.fetch("dc-live", max_n=1, timeout=0.2)
        assert got, "expired decode lease never requeued"
        assert got[0]["rid"] == 0 and got[0]["handoff"] is h
        r.decode.complete("dc-live", 0, [5, 6])
        assert r.wait_all(timeout=10.0)
        assert r.results() == {0: [5, 6]}
        assert r.prefill.stats()["completed"] == 1     # prefilled once
    finally:
        r.close()


def test_pool_pressure_reports_per_label():
    p = FleetDispatcher(name="pt-labels", lease_ttl=5.0)
    try:
        p.announce("s-pf", labels={"pool": "prefill"})
        p.announce("s-dc", labels={"pool": "decode"})
        p.submit({"rid": 0, "prompt": [1], "max_new_tokens": 1})
        p.submit({"rid": 1, "prompt": [2], "max_new_tokens": 1})
        (e0,) = p.fetch("s-pf", max_n=1, timeout=2.0)
        (e1,) = p.fetch("s-dc", max_n=1, timeout=2.0)
        p.complete("s-pf", e0["rid"], [9], first_token_s=0.01)
        p.complete("s-dc", e1["rid"], [9], first_token_s=1.0)
        p.report_telemetry("s-pf", {"kv_memory_utilization": 0.9,
                                    "blocked_admissions": 3, "slots": 2,
                                    "prefills_exported": 5})
        p.report_telemetry("s-dc", {"kv_memory_utilization": 0.2,
                                    "blocked_admissions": 0, "slots": 4,
                                    "handoffs_imported": 5})
        pp = p.pool_pressure()
        bl = pp["by_label"]
        assert set(bl) == {"prefill", "decode"}
        assert bl["prefill"]["ttft_p99_s"] == pytest.approx(0.01)
        assert bl["decode"]["ttft_p99_s"] == pytest.approx(1.0)
        assert bl["prefill"]["kv_memory_utilization"] == 0.9
        assert bl["decode"]["kv_memory_utilization"] == 0.2
        assert bl["prefill"]["blocked_by_server"] == {"s-pf": 3}
        assert bl["decode"]["blocked_by_server"] == {"s-dc": 0}
        assert bl["prefill"]["slots_per_server"] == 2.0
        assert bl["decode"]["slots_per_server"] == 4.0
        assert bl["prefill"]["prefills_exported"] == 5
        assert bl["decode"]["handoffs_imported"] == 5
        assert pp["kv_memory_utilization"] == 0.9
    finally:
        p.close()


# ---------------------------------------------------------------------------
# role-split autoscaling
# ---------------------------------------------------------------------------

class _StubFleet:
    def __init__(self, n):
        self.n = n
        self.sim = SimpleNamespace(repo=SimpleNamespace(
            stats=lambda: {"queued": 0, "leased": 0, "pilots": 0},
            scheduler_metrics=lambda: {"match_p50_us": 0,
                                       "match_p99_us": 0}))

    def size(self):
        return self.n

    def draining(self):
        return 0

    def scale_up(self, n):
        self.n += n
        return [object()] * n

    def scale_down(self, n):
        self.n -= n
        return []


def test_autoscaler_pool_label_sizes_roles_independently():
    """Same pool snapshot, two scalers: only the role whose label slice
    shows KV pressure scales up; the blended view would grow both."""
    from repro_torch.core.autoscaler import AutoscalePolicy, FleetAutoscaler

    slice_ = dict(blocked_admissions=0, blocked_by_server={},
                  sick_servers=0, slots_per_server=2.0, tokens_per_step=0.0)
    pp = {
        "queued": 4, "leased": 0, "sick_servers": 0,
        "kv_memory_utilization": 0.99, "blocked_admissions": 3,
        "blocked_by_server": {"s-pf": 3}, "slots_per_server": 2.0,
        "tokens_per_step": 0.0, "acceptance_rate": 0.0,
        "by_label": {
            "prefill": {**slice_, "kv_memory_utilization": 0.99,
                        "blocked_admissions": 3,
                        "blocked_by_server": {"s-pf": 3}},
            "decode": {**slice_, "kv_memory_utilization": 0.10},
        },
    }
    pool = SimpleNamespace(name="stub", pool_pressure=lambda: dict(pp))
    policy = AutoscalePolicy(min_pilots=0, max_pilots=8, slots_per_pilot=2,
                             kv_high_water=0.92)
    scalers = {}
    for label in ("prefill", "decode"):
        fleet = _StubFleet(2)              # util = 4 / (2*2): in band
        scalers[label] = (fleet, FleetAutoscaler(
            fleet, None, pool=pool, pool_label=label, policy=policy,
            clock=lambda: 100.0))
    d_pf = scalers["prefill"][1].tick()
    d_dc = scalers["decode"][1].tick()
    assert d_pf is not None and d_pf.direction == "up"
    assert "kv pressure" in d_pf.reason
    assert d_dc is None
    assert scalers["prefill"][0].n == 3
    assert scalers["decode"][0].n == 2


# ---------------------------------------------------------------------------
# the fleets: kill one pilot per stage, bitwise replay; two autoscalers
# ---------------------------------------------------------------------------

def _fleet_reference(arch, trace):
    """The unified single engine over the same trace, built as a fleet
    image builds its engines (smoke, the kernel flags, seed 0)."""
    eng = build_engine(get_smoke_config(arch), 2, 64, seed=0, device=CPU)
    eng.run_trace(trace)
    return {r.rid: r.tokens for r in eng.done.values()}


@pytest.mark.parametrize("arch", ARCHS)
def test_fleet_disagg_kill_replay_bitwise(arch):
    cfg, _ = _cfg_params(arch)
    trace = make_trace(cfg.vocab_size, 10, max_len=64, seed=3)
    out = serve_disagg(arch, 10, prefill_pilots=2, decode_pilots=2,
                       slots=2, max_len=64, lease_ttl=0.5,
                       fail_prefill_at=2, fail_decode_at=4, trace=trace,
                       smoke=True, device=CPU)
    assert out["drained"]
    assert out["leaked_blocks"] == 0
    assert len(out["results"]) == 10
    assert len(out["failed_pilots"]["prefill"]) <= 1
    assert len(out["failed_pilots"]["decode"]) <= 1
    for role in ("prefill", "decode"):
        for row in out["servers"][role]:
            if row["serve"].get("fleet"):
                assert row["exitcode"] == 0 and row["serve"]["role"] == role
    assert {rid: list(t) for rid, t in out["results"].items()} == \
        _fleet_reference(arch, trace)


def test_disagg_fleets_serve_their_own_role():
    """Each role's fleet is labelled with its pool, so its pilots run only
    that role's servers (a killed server's task replays on its own
    fleet), and each stage's kill takes one pilot of that stage's fleet.
    Unlabelled, a decode-fleet pilot could run a prefill server, and the
    prefill kill found no lease holder in the prefill fleet."""
    arch = ARCHS[0]
    cfg, _ = _cfg_params(arch)
    trace = make_trace(cfg.vocab_size, 10, max_len=64, seed=3)
    out = serve_disagg(arch, 10, prefill_pilots=2, decode_pilots=2,
                       slots=2, max_len=64, lease_ttl=0.5,
                       fail_prefill_at=2, fail_decode_at=4, trace=trace,
                       smoke=True, device=CPU)
    assert out["drained"] and len(out["results"]) == 10
    for role in ("prefill", "decode"):
        mine = set(out["pilots"][role])
        assert len(mine) == 2
        assert len(out["failed_pilots"][role]) == 1
        assert set(out["failed_pilots"][role]) <= mine
        assert {r["pilot"] for r in out["servers"][role]} <= mine


def test_disagg_schedule_two_autoscalers():
    """`serve_disagg_schedule`: each role pool under its own autoscaler,
    reading its own label's slice; every request completes, bitwise the
    unified engine's."""
    from repro_torch.core.autoscaler import AutoscalePolicy
    arch = "smollm-360m"
    cfg, _ = _cfg_params(arch)
    trace = make_trace(cfg.vocab_size, 8, max_len=64, seed=5)
    schedule = make_bursty_schedule(trace, bursts=2, burst_s=0.3,
                                    gap_s=0.3)
    policy = AutoscalePolicy(min_pilots=1, max_pilots=2, slots_per_pilot=2,
                             up_cooldown=0.1, interval=0.05)
    out = serve_disagg_schedule(arch, schedule, slots=2, max_len=64,
                                prefill_policy=policy, decode_policy=policy,
                                initial_pilots=1, lease_ttl=1.0, smoke=True,
                                device=CPU)
    assert out["drained"]
    assert set(out["autoscale"]) == {"prefill", "decode"}
    assert all(1 <= out["peak_pilots"][r] <= 2 for r in out["autoscale"])
    assert out["stats"]["prefill"]["completed"] == 8
    assert {rid: list(t) for rid, t in out["results"].items()} == \
        _fleet_reference(arch, trace)


# ---------------------------------------------------------------------------
# wave admission
# ---------------------------------------------------------------------------

def test_wave_admission_streams_and_refills():
    """``admission="wave"`` streams are bitwise the continuous engine's,
    and no slot refills until every slot is free."""
    arch = "smollm-360m"
    cfg, _ = _cfg_params(arch)
    trace = make_trace(cfg.vocab_size, 7, max_len=64, seed=2)
    cont = _engine(arch)
    cont.run_trace(trace)
    wave = _engine(arch, admission="wave")
    admitted = []
    real = wave._admit_into

    def spy(si, req):
        admitted.append(sum(m.rid != -1 for m in wave.slot_meta))
        return real(si, req)

    wave._admit_into = spy
    st = wave.run_trace(trace)
    assert st["completed"] == 7
    assert {r: q.tokens for r, q in wave.done.items()} == \
        {r: q.tokens for r, q in cont.done.items()}
    # each admission lands in a wave that started with every slot free:
    # the k-th admission of a wave sees k - 1 busy slots
    waves = []
    for busy in admitted:
        if busy == 0:
            waves.append(0)
        assert busy == waves[-1], admitted
        waves[-1] += 1
    assert len(waves) > 1 and cont.steps < wave.steps
