"""Tensor-parallel serving on the port: a (data, model) mesh over one
process's devices, held against the JAX package's rules and against the
port's own single-device engine.

The reference's host tests (tests/test_tp_serving.py) run here against
JAX: mesh-shape parsing, image and registry keys per mesh, prefetch
single-flight per (image, mesh), a mesh server as one capacity unit, the
pool's pressure; and the shard-factor mirrors for every leaf of every
registered arch's smoke params and state.  The reference's device battery
(two forced XLA devices) runs on a mesh of two CPU ranks,
``serve_mesh((1, 2), devices=("cpu", "cpu"))``: each rank's part on the
CPU, the kernels' plain versions.  Its gates are the reference's: streams
bitwise the single-device engine's, one device->host copy a step,
per-rank KV bytes at most 0.6 of the total (1.0 where a rule falls back
to replication), no leaked block, prefix hits on the shared prompts.  The
paths the rank loop also runs (dense rings, chunked admission, wave
admission, MLA speculation; the MoE, SSM and hybrid families; (2, 1) and
(2, 2) meshes, whose data rows split the MoE decode experts; the split
roles between mesh and one-device engines), a column leaf kept whole, the
pilot's late binding of a mesh image and a mesh fleet are held to the
single-device engine the same way; granite's and jamba's sharded prefill
also to JAX's, and a (2, 2) mesh's bytes on each device to the dry run.
"""

from __future__ import annotations

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke
from repro.models.api import build_model as jax_build
from repro.models.api import init_decode_state as jax_init_state
from repro.runtime import mesh as jax_mesh
from repro.runtime import sharding as jax_sharding
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs.base import get_smoke_config, list_archs
from repro_torch.core.autoscaler import AutoscalePolicy, FleetAutoscaler
from repro_torch.core.cluster import ClusterSim
from repro_torch.core.images import (
    Executable, ExecutableRegistry, PayloadImage)
from repro_torch.core.pilot import PilotConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_verify_attention)
from repro_torch.launch.serve import (
    KERNEL_FLAGS, make_trace, serve_direct, serve_fleet)
from repro_torch.models.api import build_model, init_decode_state
from repro_torch.runtime import mesh as port_mesh
from repro_torch.runtime import sharding
from repro_torch.runtime.mesh import MODEL_AXIS, serve_mesh
from repro_torch.serving.dispatch import FleetDispatcher
from repro_torch.serving.engine import Request, ServeEngine

CPU = "cpu"
MESH = serve_mesh((1, 2), devices=(CPU, CPU))


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_op():
    """At smoke widths an op gains nothing from intra-op threads, and the
    test run's other workers share the cores (as tests/test_torch_fleet.py
    does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# --mesh AxB parsing and the mesh's axes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", ["1x2", "2x4", "4", "2x3x4", "ax2", "0x2",
                                  ""])
def test_parse_mesh_shape_matches_jax(text):
    """The same shape, or the same ValueError, as the reference's."""
    try:
        want = jax_mesh.parse_mesh_shape(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_mesh.parse_mesh_shape(text)
        assert str(got.value) == str(e)
        return
    assert port_mesh.parse_mesh_shape(text) == want
    assert port_mesh.serve_mesh_spec(text) == port_mesh.MeshSpec(
        want, ("data", "model"))


def test_mesh_axes_match_jax():
    """A (1, 1) mesh (the one CPU device JAX has here) reads as the
    reference's; a (2, 4) one over CPU ranks has its axes' sizes."""
    jm = jax_mesh.serve_mesh((1, 1))
    pm = serve_mesh((1, 1), devices=(CPU,))
    for fn in ("batch_axes", "batch_parallelism", "model_parallelism"):
        assert getattr(port_mesh, fn)(pm) == getattr(jax_mesh, fn)(jm), fn
    assert port_mesh.mesh_axis_size(pm, "pod") == jax_mesh.mesh_axis_size(
        jm, "pod") == 1
    wide = serve_mesh("2x4", devices=[CPU] * 8)
    assert wide.devices.shape == (2, 4)
    assert port_mesh.batch_parallelism(wide) == 2
    assert port_mesh.model_parallelism(wide) == 4
    assert len(wide.model_devices) == 4


def test_serve_mesh_never_wraps_ranks_onto_fewer_cards():
    """With no devices, `serve_mesh` takes cuda:0..N-1 and raises, naming
    the count, when the machine has fewer cards; devices must be one per
    rank."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"needs {have + 1} CUDA"):
        serve_mesh((1, have + 1))
    with pytest.raises(ValueError, match="takes 2 devices"):
        serve_mesh((1, 2), devices=(CPU,))


# ---------------------------------------------------------------------------
# serve image key + registry: one build per (image, mesh)
# ---------------------------------------------------------------------------

def _img(**kw):
    return PayloadImage(arch="smollm-360m", shape="smoke", mode="serve",
                        smoke=True, **kw)


def test_payload_image_key_includes_mesh_shape():
    assert _img().key() != _img(mesh_shape=(1, 2)).key()
    assert _img(mesh_shape=(1, 2)).key() != _img(mesh_shape=(2, 1)).key()


def test_registry_key_distinguishes_mesh():
    img = _img()
    k_dev = ExecutableRegistry._key(img, CPU)
    k_mesh = ExecutableRegistry._key(img, serve_mesh((1, 1), devices=(CPU,)))
    assert k_dev != k_mesh
    assert k_mesh != ExecutableRegistry._key(img, MESH)


def test_registry_prefetch_single_flight_per_image_mesh(monkeypatch):
    """Two prefetches of the same (image, mesh) join one worker; a
    different mesh for the same image is a different build."""
    reg = ExecutableRegistry()
    gate = threading.Event()
    keys = []

    def fake_pull(image, where=None):
        keys.append(ExecutableRegistry._key(image, where))
        gate.wait(10)
        return Executable(image=image, fn=None, make_inputs=None,
                          compile_seconds=0.0)

    monkeypatch.setattr(reg, "pull", fake_pull)
    img = _img()
    e1 = reg.prefetch(img, MESH)
    e2 = reg.prefetch(img, MESH)        # joins the in-flight prefetch
    e3 = reg.prefetch(img, CPU)         # distinct key -> its own worker
    assert e1 is e2
    gate.set()
    assert e1.wait(10) and e3.wait(10)
    assert reg.stats["prefetches"] == 2
    assert len(set(keys)) == 2


# ---------------------------------------------------------------------------
# capacity accounting: a mesh-bound server is ONE capacity unit
# ---------------------------------------------------------------------------

class _StubFleet:
    def __init__(self, n: int = 0):
        self.n = n
        self.draining_n = 0

    def size(self):
        return self.n

    def draining(self):
        return self.draining_n

    def scale_up(self, n):
        self.n += n
        return [object()] * n

    def scale_down(self, n):
        self.n -= n
        return []


def test_autoscaler_mesh_server_is_one_capacity_unit():
    """demand 8 against 2-slot sharded servers needs 4 servers — the 4
    devices backing each server must never multiply into capacity."""
    sig = {"demand": 8, "pool_slots_per_server": 2.0,
           "pool_mesh_devices": 4}
    fleet = _StubFleet(0)
    sc = FleetAutoscaler(fleet, None,
                         policy=AutoscalePolicy(slots_per_pilot=1),
                         signals_fn=lambda: dict(sig),
                         clock=lambda: 1000.0)
    sc.tick()
    assert fleet.size() == 4, fleet.size()


def test_pool_pressure_reports_per_server_slots_and_mesh():
    pool = FleetDispatcher(name="tp-test")
    for sid, slots in (("s1", 2), ("s2", 4)):
        pool.announce(sid)
        pool.report_telemetry(sid, {"slots": slots, "mesh_devices": 2,
                                    "kv_memory_utilization": 0.1})
    pp = pool.pool_pressure()
    assert pp["slots_per_server"] == pytest.approx(3.0)
    assert pp["mesh_devices"] == 2


# ---------------------------------------------------------------------------
# partition rules: the pure mirrors against the reference's
# ---------------------------------------------------------------------------

def _port_leaves(tree, path=()):
    """(path, leaf) in JAX's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (i,))
    else:
        yield path, tree


def _factors_match(jtree, ptree, jfn, pfn):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    pl = list(_port_leaves(ptree))
    assert len(jl) == len(pl)
    n = 0
    for (jp, jleaf), (pp, pleaf) in zip(jl, pl):
        assert tuple(jleaf.shape) == tuple(pleaf.shape), (jp, pp)
        for m in (1, 2, 4):
            want = jfn(jp, tuple(jleaf.shape), m)
            assert pfn(pp, tuple(pleaf.shape), m) == want, (pp, m)
            n += want > 1
    return n


@pytest.mark.parametrize("arch", list_archs())
def test_shard_factors_match_jax(arch):
    """`serve_param_shard_factor` and `serve_state_shard_factor` give the
    reference's divisor for every leaf of the arch's smoke params and of
    its decode state in each layout, at model sizes 1, 2 and 4."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    jparams = jax.eval_shape(
        lambda: jax_build(jcfg).init(jax.random.key(0)))
    params = build_model(cfg).init(0, device=CPU).tree()
    split = _factors_match(jparams, params,
                           jax_sharding.serve_param_shard_factor,
                           sharding.serve_param_shard_factor)
    assert split > 0                      # the embedding at least
    for kv in (("dense",) if cfg.is_encdec else ("paged", "dense")):
        jstate = jax.eval_shape(lambda: jax_init_state(
            jcfg, 2, 64, kv=kv, num_blocks=9, block_size=8))
        state = init_decode_state(cfg, 2, 64, kv=kv, num_blocks=9,
                                  block_size=8, device="meta")
        _factors_match(jstate, state, jax_sharding.serve_state_shard_factor,
                       sharding.serve_state_shard_factor)


def test_partition_rules_and_placement():
    """The reference battery's rule checks, and the placement they give:
    pools split on the head dim (each rank half the heads), tables and
    scalars one copy, row-parallel ``wo``/``down`` replicated,
    column-parallel ``wq`` split."""
    cfg = get_smoke_config("starcoder2-3b")
    state = init_decode_state(cfg, 2, 64, kv="paged", num_blocks=9,
                              block_size=8, device=CPU)
    dims = sharding.serve_state_shardings(state, MESH)
    assert all(d["kp"] == 3 and d["vp"] == 3 for d in dims["cache"])
    assert dims["block_tables"] is None and dims["pos"] is None
    params = build_model(cfg).init(0, device=CPU)
    pd = sharding.serve_param_shardings(params.tree(), MESH)
    for slot in pd["layers"]:
        assert slot["mixer"]["wo"] is None and slot["ffn"]["down"] is None
        assert slot["mixer"]["wq"] == 2
    placed = init_decode_state(cfg, 2, 64, kv="paged", num_blocks=9,
                               block_size=8, mesh=MESH)
    kp = placed["cache"][0]["kp"]
    assert isinstance(kp, sharding.Shards)
    assert [tuple(p.shape) for p in kp.parts] == [(2, 9, 8, 1, 16)] * 2
    assert tuple(kp.shape) == tuple(state["cache"][0]["kp"].shape)
    assert isinstance(placed["block_tables"], torch.Tensor)
    sp = sharding.shard_params(params, MESH)
    assert isinstance(sp.group(0)[0]["mixer"]["wq"], sharding.Shards)
    assert isinstance(sp.group(0)[0]["mixer"]["wo"], torch.Tensor)
    assert sharding.tp_heads(MESH, 2, 4) and not sharding.tp_heads(MESH, 5, 15)
    assert not sharding.tp_heads(None, 2, 4)
    assert sharding.tp_heads(MESH, 2, 4) == jax_sharding_tp_heads(2, 4)


def jax_sharding_tp_heads(k, h):
    """The reference's ``tp_heads`` on a stand-in of a 2-way model axis."""
    from repro.kernels.paged_attention.ops import tp_heads

    class Stand:
        shape = {MODEL_AXIS: 2}
    return tp_heads(Stand(), k, h)


# ---------------------------------------------------------------------------
# the kernels on each rank's head slice
# ---------------------------------------------------------------------------

def _paged_case(seed=7, B=2, nb=9, bs=8, K=2, G=2, Dh=16, S=None):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)
    q = r(B, K * G, Dh) if S is None else r(B, S, K * G, Dh)
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    return q, r(nb, bs, K, Dh), r(nb, bs, K, Dh), tables


def _ranks(q, kp, vp, qdim):
    return (sharding.split(q, sharding.Shards([q, q], qdim)),
            sharding.split(kp, sharding.Shards([kp, kp], -2)),
            sharding.split(vp, sharding.Shards([vp, vp], -2)))


@pytest.mark.parametrize("kind", ["decode", "verify", "dense"])
def test_kernel_on_each_rank_is_the_whole_calls_slice(kind):
    """The paged decode, paged verify and dense decode wrappers on each
    rank's heads (q and pools split on their heads, the tables and lengths
    whole), through the rank loop, bitwise the whole call's heads."""
    if kind == "verify":
        q, kp, vp, tables = _paged_case(S=3)
        lens = torch.tensor([11, 24], dtype=torch.int32)
        fn, qdim = paged_verify_attention, -2
    else:
        q, kp, vp, tables = _paged_case()
        lens = torch.tensor([13, 27], dtype=torch.int32)
        fn, qdim = paged_decode_attention, -2
    if kind == "dense":
        kp = kp[tables.long()].reshape(2, 32, 2, 16)
        vp = vp[tables.long()].reshape(2, 32, 2, 16)

        def fn(q, k, v, tables, lens):
            return decode_attention(q, k, v, lens)
    whole = fn(q, kp, vp, tables, lens)
    qs, ks, vs = _ranks(q, kp, vp, qdim)
    got = sharding.on_ranks(fn, qs, ks, vs, tables, lens, dim=qdim)
    assert all(torch.equal(a, b) for a, b in zip(
        got.parts, torch.chunk(whole, 2, dim=qdim)))
    assert torch.equal(sharding.gather(got), whole)


# ---------------------------------------------------------------------------
# the battery: sharded streams are the single-device engine's
# ---------------------------------------------------------------------------

def _run(cfg, mesh, **kw):
    """The reference battery's run: 6 trace requests (30% repeats), then
    6 requests sharing a 40-token prompt (2 full blocks: prefix hits,
    refcounts and evictions on the pools)."""
    params = build_model(cfg).init(0, device=CPU)
    eng = ServeEngine(cfg, params, slots=2, max_len=64, mesh=mesh,
                      device=CPU, **kw)
    eng.run_trace(make_trace(cfg.vocab_size, 6, max_len=64, seed=0,
                             dup_rate=0.3))
    base = (np.arange(40) % (cfg.vocab_size - 2) + 2).astype(np.int32)
    for i in range(6):
        eng.submit(Request(rid=1000 + i, prompt=base.copy(),
                           max_new_tokens=4))
    eng.run()
    return eng, {r.rid: list(r.tokens) for r in eng.done.values()}


PALLAS = {"attn_impl": "pallas"}
KERNELS = dict(KERNEL_FLAGS)
MOE_ARCH = "granite-moe-3b-a800m"
BATTERY = {
    "gqa": ("starcoder2-3b", PALLAS, {}, True),
    # the router and dispatch on the lead device, up/gate per rank through
    # the grouped matmul's plain version, down whole after the gather
    "moe": (MOE_ARCH, KERNELS, {}, True),
    "gqa_spec": ("starcoder2-3b", PALLAS, {"spec": "draft", "spec_k": 3},
                 True),
    "mla": ("minicpm3-4b", {}, {}, True),
    # K = 5 heads do not split over 2 ranks: the pools replicate and
    # attention runs whole on the lead device
    "fallback": ("smollm-360m", PALLAS, {}, False),
}


@pytest.mark.parametrize("name", sorted(BATTERY))
def test_tp_serving_battery(name):
    arch, flags, kw, sharded = BATTERY[name]
    cfg = dataclasses.replace(get_smoke_config(arch), **flags)
    e1, t1 = _run(cfg, None, **kw)
    e2, t2 = _run(cfg, MESH, **kw)
    assert t1 == t2                                   # bitwise tokens
    assert e2.d2h_transfers == e2.steps               # one copy a step
    kvb = e2.kv_pool_bytes()
    share = kvb["kv_pool_bytes_per_device"] / kvb["kv_pool_bytes"]
    assert share <= 0.6 if sharded else share == 1.0
    assert kvb["kv_pool_bytes"] == e1.kv_pool_bytes()["kv_pool_bytes"]
    assert e2.block_leaks() == 0                      # refcounts balance
    assert e2.prefix_hit_tokens > 0                   # churn hit the cache
    stats = e2._stats(0, 1.0)
    assert stats["mesh_shape"] == (1, 2) and stats["mesh_devices"] == 2
    assert e2.kv_pressure()["mesh_devices"] == 2
    if kw.get("spec"):
        assert e2.spec == "draft" and e2.spec_accepted > 0


MORE_PATHS = {
    "gqa_dense": ("starcoder2-3b", PALLAS, {"kv": "dense"}),
    "gqa_chunked": ("starcoder2-3b", PALLAS,
                    {"prefill": "chunked", "prefill_chunk": 16}),
    "dense_chunked": ("starcoder2-3b", PALLAS,
                      {"kv": "dense", "prefill": "chunked",
                       "prefill_chunk": 16}),
    "mla_chunked": ("minicpm3-4b", {},
                    {"prefill": "chunked", "prefill_chunk": 16}),
    "mla_spec": ("minicpm3-4b", {}, {"spec": "draft", "spec_k": 3}),
    "wave": ("starcoder2-3b", PALLAS, {"admission": "wave"}),
    "plain_attention": ("starcoder2-3b", {}, {}),
    "moe_spec": (MOE_ARCH, KERNELS, {"spec": "draft", "spec_k": 3}),
    "moe_chunked": (MOE_ARCH, KERNELS,
                    {"prefill": "chunked", "prefill_chunk": 16}),
    # SSM mixers and their state replicate: they run once on the lead
    # device; only the tied embedding (the head) splits
    "ssm": ("mamba2-370m", KERNELS, {}),
    # jamba: attention and MoE columns split, SSM slots on the lead
    "hybrid": ("jamba-v0.1-52b", KERNELS, {}),
    # a data axis: every data row a copy, each computing its slice of the
    # experts in decode
    "data_2x1": (MOE_ARCH, KERNELS, {}, (2, 1)),
    "data_2x2": (MOE_ARCH, KERNELS, {}, (2, 2)),
}


def _cpu_mesh(shape):
    return serve_mesh(shape, devices=(CPU,) * (shape[0] * shape[1]))


@pytest.mark.parametrize("name", sorted(MORE_PATHS))
def test_mesh_paths_bitwise(name):
    """The other paths the rank loop runs, each bitwise its single-device
    run, with the battery's gates; on a data axis above 1 every data row
    computes its slice of the experts."""
    arch, flags, kw, *shape = MORE_PATHS[name]
    shape = shape[0] if shape else (1, 2)
    cfg = dataclasses.replace(get_smoke_config(arch), **flags)
    e1, t1 = _run(cfg, None, **kw)
    e2, t2 = _run(cfg, _cpu_mesh(shape), **kw)
    assert t1 == t2
    assert e2.d2h_transfers == e2.steps and e2.block_leaks() == 0
    # the KV pools (not an SSM slot's replicated state) split evenly
    kv = e2.device_bytes()["kv_pool"]
    assert kv == [[kv[0][0]] * shape[1]] * shape[0]
    assert e2.params.whole_leaves == ()
    assert e2.params.expert_rows == shape[0]
    assert len(e2.state_replicas) == shape[0] - 1
    if kw.get("spec"):
        assert e2.spec == "draft" and e2.spec_accepted > 0


@pytest.mark.parametrize("arch", ["starcoder2-3b", "minicpm3-4b",
                                  "gemma-2b"])
def test_whole_column_leaves_keep_parity(arch):
    """Every column leaf kept whole on the lead device (the placement for
    a leaf whose slices are not bitwise on the card): each product runs
    whole and its output splits over the ranks; prefill, decode, verify
    and a chunk stay bitwise the single-device forward's."""
    cfg = dataclasses.replace(get_smoke_config(arch), **PALLAS)
    bundle = build_model(cfg)
    params = bundle.init(0, device=CPU)
    sp = sharding.shard_params(params, MESH,
                               whole=sharding._SERVE_TP_SAFE)
    assert "embed" in sp.whole_leaves
    assert isinstance(sp.embed, sharding.Whole)
    toks = torch.randint(0, cfg.vocab_size, (1, 16), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    (l1, c1), (l2, c2) = (bundle.prefill(p, {"tokens": toks})
                          for p in (params, sp))
    assert torch.equal(l1, l2)
    for a, b in zip(c1, c2):
        for k in a:
            assert torch.equal(a[k], sharding.gather(b[k])), k
    outs = []
    for p, mesh in ((params, None), (sp, MESH)):
        st = init_decode_state(cfg, 2, 64, device=CPU, mesh=mesh)
        st["block_tables"][0] = torch.arange(1, 5)
        st["block_tables"][1] = torch.arange(5, 9)
        st["pos"][:] = torch.tensor([3, 9])
        st["token"][:, 0] = torch.tensor([5, 7])
        got = []
        for _ in range(3):
            lg, new = bundle.decode(p, st)
            st["token"].copy_(new["token"])
            st["pos"].copy_(new["pos"])
            got.append(lg)
        got.append(bundle.verify(p, torch.ones((2, 4), dtype=torch.int32),
                                 st)[0])
        got.append(bundle.prefill_chunk(p, st, toks, st["block_tables"][0],
                                        0, 16)[0])
        outs.append(got)
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_slice_check_keeps_a_differing_leaf_whole():
    """`slices_exact` compares each part's product with the whole
    product's columns; a leaf whose parts are not its columns (here: the
    parts swapped) is caught."""
    params = build_model(get_smoke_config("starcoder2-3b")).init(0,
                                                                device=CPU)
    up = params.tree()["layers"][0]["ffn"]["up"]
    parts = torch.chunk(up, 2, dim=-1)
    assert sharding.slices_exact("up", up, parts, rows=(1, 8, 64))
    assert not sharding.slices_exact("up", up, parts[::-1], rows=(8,))
    # an embedding with its own head is only looked up: never checked,
    # always split (minicpm3-4b is untied)
    mla = build_model(get_smoke_config("minicpm3-4b")).init(0, device=CPU)
    sp = sharding.shard_params(mla, MESH, rows=(1, 8))
    assert sp.whole_leaves == () and isinstance(sp.embed, sharding.Shards)


def test_moe_column_check_runs_the_engines_products(monkeypatch):
    """A stacked MoE ``up`` (G, E, D, F) is checked on the products the
    engine runs with group 0's (E, D, F): the decode product (1, M, D) @
    (E, D, F) and the capacity-bucket product through `bucket_matmul`
    (the grouped matmul's plain version on the CPU), at every row count;
    a part-swapped ``up`` is caught."""
    from repro_torch.kernels.grouped_matmul import ops as gops
    params = build_model(get_smoke_config(MOE_ARCH)).init(0, device=CPU)
    up = params.tree()["layers"][0]["ffn"]["up"]
    G, E, D, F = up.shape
    parts = [c.contiguous() for c in torch.chunk(up, 2, dim=-1)]
    seen = {"decode": [], "bucket": []}
    decode, bucket = sharding._decode_product, gops.bucket_matmul

    def spy_decode(x, w):
        seen["decode"].append((tuple(x.shape), tuple(w.shape)))
        return decode(x, w)

    def spy_bucket(x, w):
        seen["bucket"].append((tuple(x.shape), tuple(w.shape)))
        return bucket(x, w)
    monkeypatch.setattr(sharding, "_decode_product", spy_decode)
    monkeypatch.setattr(gops, "bucket_matmul", spy_bucket)
    assert sharding.slices_exact("up", up, parts, rows=(2, 24))
    for m in (2, 24):
        for w in ((E, D, F), (E, D, F // 2)):
            assert ((1, m, D), w) in seen["decode"]
            assert ((E, m, D), w) in seen["bucket"]
    assert not sharding.slices_exact("up", up, parts[::-1], rows=(2,))
    assert not sharding.experts_exact(up, [up], rows=(2,), n=3)


def test_mesh_remainder_raises_naming_item_8():
    """Every decoder family and role now serves on a mesh (the battery and
    the paths above); what an engine still refuses is a mesh whose lead
    device is not its own."""
    cfg = get_smoke_config("starcoder2-3b")
    with pytest.raises(ValueError, match="lead device"):
        ServeEngine(cfg, build_model(cfg).init(0, device=CPU), slots=2,
                    max_len=64, device=CPU,
                    mesh=serve_mesh((1, 2), devices=("meta", "meta")))


# ---------------------------------------------------------------------------
# the split roles on a mesh: handoffs in the one-device wire layout
# ---------------------------------------------------------------------------

ROLE_PAIRINGS = {"roles_mesh_to_mesh": (MESH, MESH),
                 "roles_mesh_to_one": (MESH, None),
                 "roles_one_to_mesh": (None, MESH)}


def _role_reqs(vocab, n=4, seed=3):
    """Prompts of 4-27 tokens (bucket <= 32, so bucket + budget fits
    max_len 64 and each stream runs its whole budget)."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=int(rng.integers(4, 28)))
             .astype(np.int32), int(rng.integers(5, 10))) for i in range(n)]


@pytest.mark.parametrize("arch", ["starcoder2-3b", "minicpm3-4b"])
@pytest.mark.parametrize("pairing", sorted(ROLE_PAIRINGS))
def test_mesh_roles_bitwise(pairing, arch, monkeypatch):
    """A prefill-role engine and a decode-role engine, each on the mesh or
    on one device: the streams are the unified one-device engine's
    bitwise; each export is the one-device prefill engine's handoff
    byte for byte (the same wire layout) in one host pull; the import
    writes every rank's pool part in place; no block leaks."""
    pf_mesh, dc_mesh = ROLE_PAIRINGS[pairing]
    cfg = dataclasses.replace(get_smoke_config(arch), **PALLAS)
    params = build_model(cfg).init(0, device=CPU)

    def engine(mesh, **kw):
        return ServeEngine(cfg, params, slots=2, max_len=64, mesh=mesh,
                           device=CPU, **kw)

    def serve(eng, reqs, handoffs=None):
        for rid, prompt, mnt in reqs:
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=mnt,
                               handoff=(handoffs or {}).get(rid)))
        eng.run()
        return {rid: eng.done[rid] for rid, _, _ in reqs}

    reqs = _role_reqs(cfg.vocab_size)
    want = {rid: r.tokens for rid, r in serve(engine(None), reqs).items()}
    one = serve(engine(None, role="prefill"), reqs)
    pf = engine(pf_mesh, role="prefill")
    real, pulls = torch.Tensor.cpu, []

    def counting(self, *a, **kw):
        pulls.append(tuple(self.shape))
        return real(self, *a, **kw)
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    exported = serve(pf, reqs)
    monkeypatch.undo()
    assert len(pulls) == len(reqs)                    # one pull an export
    for rid, _, _ in reqs:
        h, h1 = exported[rid].handoff, one[rid].handoff
        assert h.nbytes == h1.nbytes
        for a, b in zip(h.blocks, h1.blocks):
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) for k in a)
    dc = engine(dc_mesh, role="decode")
    pools = [p for leaf in dc.state["cache"] for t in leaf.values()
             for p in sharding.parts(t)]
    ptrs = [p.data_ptr() for p in pools]
    got = serve(dc, reqs, {rid: r.handoff for rid, r in exported.items()})
    assert {rid: r.tokens for rid, r in got.items()} == want
    assert [p.data_ptr() for p in pools] == ptrs
    assert pf.block_leaks() == 0 and dc.block_leaks() == 0
    assert dc.handoffs_imported == len(reqs) and dc.d2h_transfers == dc.steps


# ---------------------------------------------------------------------------
# the MoE and hybrid families on the mesh against JAX
# ---------------------------------------------------------------------------

# the tolerances of tests/test_torch_moe.py (granite, 1e-2) and
# tests/test_torch_hybrid.py (jamba, 5e-2); JAX runs its plain paths (its
# Pallas kernels in interpret mode take seconds here)
JAX_PLAIN = {"attn_impl": "chunked", "norm_impl": "jnp",
             "ssm_impl": "chunked", "moe_impl": "einsum"}
JAX_HOLD = {MOE_ARCH: dict(rtol=1e-2, atol=1e-2),
            "jamba-v0.1-52b": dict(rtol=5e-2, atol=5e-2)}


@pytest.mark.parametrize("arch", sorted(JAX_HOLD))
def test_sharded_prefill_holds_to_jax(arch):
    """``bundle.prefill`` on `shard_params` of bridged weights (seeded,
    as numpy) is the one-device prefill bitwise, logits and cache, and
    within the family's tolerance of JAX's on the same weights."""
    tol = JAX_HOLD[arch]
    cfg = dataclasses.replace(get_smoke_config(arch), **KERNELS)
    jcfg = dataclasses.replace(jax_smoke(arch), **JAX_PLAIN)
    tree = params_to_numpy(build_model(cfg).init(0, device=CPU))
    params = params_from_numpy(tree, cfg, device=CPU)
    toks = np.zeros((1, 32), np.int32)
    toks[0, -23:] = np.random.default_rng(0).integers(0, cfg.vocab_size, 23)
    sp = sharding.shard_params(params, MESH, rows=(1, 16, 32))
    bundle = build_model(cfg)
    (l1, c1), (l2, c2) = (bundle.prefill(p, {"tokens": torch.from_numpy(
        toks)}) for p in (params, sp))
    assert torch.equal(l1, l2)
    for a, b in zip(c1, c2):
        for k in a:
            assert torch.equal(a[k], sharding.gather(b[k])), k
    jl, _ = jax.jit(jax_build(jcfg).prefill)(
        jax.tree.map(jax.numpy.asarray, tree), {"tokens": toks})
    np.testing.assert_allclose(l2.float().numpy(),
                               np.asarray(jl, np.float32), **tol)


# ---------------------------------------------------------------------------
# a (2, 2) mesh: what each of the four devices holds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_data_mesh_device_bytes_match_the_dry_run(kv):
    """On a (2, 2) mesh of four CPU ranks the bytes of parameters, state
    and KV pools the engine places on each device equal `run_serve_cell`'s
    prediction with the leaves the engine kept whole: each data row holds
    row 0's placement, the model ranks their parts."""
    from repro_torch.launch.dryrun import run_serve_cell
    cfg = dataclasses.replace(get_smoke_config(MOE_ARCH), **KERNELS)
    eng = ServeEngine(cfg, build_model(cfg).init(0, device=CPU), slots=2,
                      max_len=64, kv=kv, mesh=_cpu_mesh((2, 2)), device=CPU)
    pred = run_serve_cell(MOE_ARCH, mesh_shape=(2, 2), slots=2, max_len=64,
                          kv=kv, smoke=True, param_dtype=torch.bfloat16,
                          whole=eng.params.whole_leaves)
    held = eng.device_bytes()
    for k in ("params", "state", "kv_pool"):
        assert held[k] == pred[f"{k}_bytes_by_device"], k
        assert held[k][0] == pred[f"{k}_bytes_per_rank"], k
    assert held["kv_pool"][0][0] * 2 == pred["kv_pool_bytes"] > 0


# ---------------------------------------------------------------------------
# the pool's bytes: the reference's dict
# ---------------------------------------------------------------------------

def test_kv_pool_bytes_matches_jax():
    """With no mesh, `kv_pool_bytes` is the reference engine's dict on the
    same (bridged) weights: the total and the per-device bytes, equal."""
    arch = "smollm-360m"
    cfg = dataclasses.replace(get_smoke_config(arch), **PALLAS)
    jcfg = dataclasses.replace(jax_smoke(arch), **PALLAS)
    jparams = jax_build(jcfg).init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device=CPU)
    for kv in ("paged", "dense"):
        port = ServeEngine(cfg, params, slots=2, max_len=64, kv=kv,
                           device=CPU)
        ref = JaxEngine(jcfg, jparams, slots=2, max_len=64, kv=kv)
        assert port.kv_pool_bytes() == ref.kv_pool_bytes(), kv
        got = port.kv_pool_bytes()
        assert got["kv_pool_bytes_per_device"] == got["kv_pool_bytes"]


# ---------------------------------------------------------------------------
# late binding: a pilot binds a mesh image onto the slice it holds; a fleet
# ---------------------------------------------------------------------------

TP_ARCH = "starcoder2-3b"


def test_pilot_late_binds_a_mesh_image_onto_its_slice():
    """One pilot holding a slice of two CPU ranks binds the (1, 2) serve
    image of a trace, then the one-device image of the same trace: both
    exit 0, the streams are equal, and the mesh server reports its shape,
    its two devices and half the pool bytes per rank."""
    sim = ClusterSim(device=CPU)
    trace = make_trace(get_smoke_config(TP_ARCH).vocab_size, 4, max_len=64,
                       seed=0, dup_rate=0.3)
    images = [PayloadImage(TP_ARCH, "smoke", "serve", flags=KERNEL_FLAGS,
                           mesh_shape=m) for m in ((1, 2), None)]
    tids = [sim.repo.submit(img, n_steps=400,
                            payload_spec={"trace": trace, "max_len": 64,
                                          "slots": 2})
            for img in images]
    (s,) = sim.provision(1, mesh=MESH)
    sim.spawn_pilot(s, PilotConfig(max_payloads=3, idle_grace=0.5))
    assert sim.run_until_drained(timeout=120.0)
    sim.join_all(timeout=30.0)
    (tp, one) = (sim.repo.result(t) for t in tids)
    assert tp.exitcode == 0 and one.exitcode == 0, (
        tp.telemetry.get("error"), one.telemetry.get("error"))
    assert tp.telemetry["tokens"] == one.telemetry["tokens"]
    sv = tp.telemetry["serve"]
    assert sv["mesh_shape"] == (1, 2) and sv["mesh_devices"] == 2
    assert sv["kv_pool_bytes_per_device"] * 2 == sv["kv_pool_bytes"]
    assert sv["d2h_transfers"] == sv["decode_steps"]
    assert tp.telemetry["engine"]["block_leaks"] == 0
    assert one.telemetry["serve"]["mesh_shape"] is None


def test_mesh_fleet_serves_bitwise_serve_direct():
    """Two pilots, each slice holding two CPU ranks, serve a trace from
    one pool on (1, 2) servers: every request once, each stream bitwise
    ``serve_direct``'s on one device, every server one capacity unit of
    its slots with two mesh devices."""
    cfg = get_smoke_config(TP_ARCH)
    trace = make_trace(cfg.vocab_size, 6, max_len=64, seed=0)
    out = serve_fleet(TP_ARCH, 6, 2, slots=2, max_len=64, lease_ttl=1.0,
                      mesh_shape=(1, 2), trace=trace, smoke=True,
                      device=CPU)
    direct = serve_direct(cfg, 6, 2, 64, trace=trace, device=CPU)
    assert out["drained"] and out["completed"] == 6
    assert out["results"] == direct["streams"]
    served = [s for s in out["servers"] if s["serve"].get("fleet")]
    assert served
    for s in served:
        assert s["exitcode"] == 0, s["error"]
        assert s["serve"]["mesh_shape"] == (1, 2)
        assert s["serve"]["mesh_devices"] == 2 and s["serve"]["slots"] == 2
        assert s["serve"]["fleet"]["leaked_blocks"] == 0
