"""The port's dry run against the reference's.

The port's meta-device stand-ins (``repro_torch.launch.specs``) against
the reference's ``jax.eval_shape`` leaves for every arch and applicable
shape; the train half of the sharding rules against the reference's for
every leaf of every arch's full-size tree on both production meshes, in
every mode, MoE partition and layout (``param_spec`` through a stand-in
mesh carrying ``axis_names`` and ``devices.shape``, which is all the
reference reads; the rules that build ``NamedSharding``s in a subprocess
with 512 forced host devices, as the reference's dry run runs);
``constrain``'s resolved spec; ``run_serve_cell`` number for number; and
``run_cell``'s record on meta, and its command line.
"""

from __future__ import annotations

import itertools
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.tree_util import DictKey, SequenceKey

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_config
from repro.configs.base import get_smoke_config as ref_smoke
from repro.launch.specs import input_specs as ref_input_specs
from repro.launch.specs import param_specs as ref_param_specs
from repro.models.api import init_decode_state as ref_init_state
from repro.runtime import sharding as ref_shd
from repro_torch.configs.base import (
    SHAPES, applicable_shapes, get_config, get_smoke_config, list_archs)
from repro_torch.launch import dryrun, hw
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.launch.specs import input_specs, param_specs
from repro_torch.models.api import init_decode_state
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.mesh import DeviceMesh, MeshSpec, batch_axes

REPO = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in list_archs() for s in applicable_shapes(get_config(a))]
DECODERS = [a for a in list_archs() if not get_config(a).is_encdec]
MESHES = {"pod16x16": False, "pod2x16x16": True}


def _ref_key(path) -> tuple:
    return tuple(k.key if isinstance(k, DictKey) else
                 k.idx if isinstance(k, SequenceKey) else k.name
                 for k in path)


def _ref_leaves(tree) -> dict:
    return {_ref_key(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree) -> dict:
    out = {}
    shd.map_with_path(lambda p, leaf: out.__setitem__(p, leaf),
                      shd.as_tree(tree))
    return out


class StandInMesh:
    """What the reference's rules read of a mesh: its axis names and its
    devices' shape (no devices behind it)."""

    def __init__(self, spec):
        self.axis_names = spec.axes
        self.devices = np.empty(spec.shape, dtype=object)


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module.  Importing it sets XLA_FLAGS to 512
    host devices, which is inert once JAX has its backend (initialized
    first here); the variable is put back afterwards."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as ref
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return ref


# ---------------------------------------------------------------------------
# input_specs: meta-device stand-ins, leaf for leaf the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    mode = SHAPES[shape].mode
    want = _ref_leaves(ref_input_specs(ref_config(arch), REF_SHAPES[shape],
                                       mode))
    got = _port_leaves(input_specs(get_config(arch), SHAPES[shape], mode))
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert leaf.device.type == "meta", path
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert str(leaf.dtype).removeprefix("torch.") == str(
            want[path].dtype), path


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_input_specs_are_abstract(mode):
    cfg = get_config("gemma-2b")
    specs = input_specs(cfg, SHAPES["decode_32k" if mode == "decode"
                                    else "train_4k"], mode)
    leaves = _port_leaves(specs)
    assert leaves
    for leaf in leaves.values():
        assert leaf.device.type == "meta"


def test_train_specs_shapes():
    cfg = get_config("mixtral-8x7b")
    state, batch = input_specs(cfg, SHAPES["train_4k"], "train")
    assert tuple(batch["tokens"].shape) == (256, 4096)
    n = sum(t.numel() for t in _port_leaves(state["params"]).values())
    assert abs(n - cfg.param_count()) / cfg.param_count() < 0.02


def test_decode_specs_cache_rolling_swa():
    cfg = get_config("mixtral-8x7b")             # SWA window 4096
    _, state = input_specs(cfg, SHAPES["long_500k"], "decode")
    (kv,) = [t for t in _port_leaves(state["cache"]).values()
             if t.dim() == 5][:1]
    assert kv.shape[2] == 4096                   # rolling window, not 524288


# ---------------------------------------------------------------------------
# the train half of the sharding rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_param_spec_matches_the_reference(arch):
    """Every leaf of the full-size tree, on both production meshes, in
    both modes, both MoE partitions and both layouts."""
    ref = _ref_leaves(ref_param_specs(ref_config(arch)))
    port = _port_leaves(param_specs(get_config(arch)))
    assert set(ref) == set(port)
    ref_paths = {_ref_key(p): p for p, _ in
                 jax.tree_util.tree_flatten_with_path(
                     ref_param_specs(ref_config(arch)))[0]}
    for multi, mode, part, layout in itertools.product(
            MESHES.values(), ("train", "serve"), ("tp", "ep"),
            ("2d", "fsdp")):
        mesh = make_production_mesh(multi_pod=multi)
        stand = StandInMesh(mesh)
        for key, leaf in port.items():
            want = tuple(ref_shd.param_spec(
                ref_paths[key], ref[key].shape, stand, mode,
                moe_partition=part, layout=layout))
            got = shd.param_spec(key, tuple(leaf.shape), mesh, mode,
                                 moe_partition=part, layout=layout)
            assert got == want, (key, multi, mode, part, layout)


_DUMP = r'''
import json, sys
import jax
from jax.tree_util import DictKey, SequenceKey
from repro.configs.base import SHAPES, applicable_shapes, get_config, list_archs
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import input_specs
from repro.runtime import sharding as shd

def key(path):
    return "/".join(str(k.key if isinstance(k, DictKey) else
                        k.idx if isinstance(k, SequenceKey) else k.name)
                    for k in path)

def dump(tree):
    return {key(p): [list(e) if isinstance(e, tuple) else e for e in s.spec]
            for p, s in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: hasattr(x, "spec"))[0]}

res = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for arch in list_archs():
        for s in applicable_shapes(get_config(arch)):
            shape = SHAPES[s]
            a, b = input_specs(get_config(arch), shape, shape.mode)
            tag = f"{arch}|{s}|{int(mp)}"
            if shape.mode == "train":
                for part in ("tp", "ep"):
                    for lay in ("2d", "fsdp"):
                        res[f"{tag}|train_state|{part}|{lay}"] = dump(
                            shd.train_state_shardings(
                                a["params"], mesh, moe_partition=part,
                                layout=lay))
            if shape.mode in ("train", "prefill"):
                for lay in ("2d", "fsdp"):
                    res[f"{tag}|batch|{lay}"] = dump(
                        shd.batch_shardings(b, mesh, lay))
            else:
                res[f"{tag}|decode_state"] = dump(
                    shd.decode_state_shardings(b, mesh))
json.dump(res, sys.stdout)
'''


@pytest.fixture(scope="module")
def ref_named_shardings():
    """The reference's NamedSharding-level rules on both production
    meshes, as specs, from one subprocess with 512 forced host devices."""
    env = {**os.environ, "XLA_FLAGS":
           "--xla_force_host_platform_device_count=512",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run([sys.executable, "-c", _DUMP], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout)


def _spec_leaves(tree):
    """A spec tree's leaves keyed as the dump keys them (a spec is a
    tuple, so walk dicts and lists only)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out["/".join(map(str, path))] = [
                list(e) if isinstance(e, tuple) else e for e in t]
    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_named_sharding_rules_match_the_reference(arch, ref_named_shardings):
    """batch_shardings, decode_state_shardings and train_state_shardings
    (every MoE partition and layout) on both production meshes."""
    n = 0
    for s in applicable_shapes(get_config(arch)):
        shape = SHAPES[s]
        a, b = input_specs(get_config(arch), shape, shape.mode)
        for multi in MESHES.values():
            mesh = make_production_mesh(multi_pod=multi)
            tag = f"{arch}|{s}|{int(multi)}"
            got = {}
            if shape.mode == "train":
                for part, lay in itertools.product(("tp", "ep"),
                                                   ("2d", "fsdp")):
                    got[f"{tag}|train_state|{part}|{lay}"] = (
                        shd.train_state_shardings(
                            a["params"], mesh, moe_partition=part,
                            layout=lay))
            if shape.mode in ("train", "prefill"):
                for lay in ("2d", "fsdp"):
                    got[f"{tag}|batch|{lay}"] = shd.batch_shardings(
                        b, mesh, lay)
            else:
                got[f"{tag}|decode_state"] = shd.decode_state_shardings(
                    b, mesh)
            for k, specs in got.items():
                assert _spec_leaves(specs) == ref_named_shardings[k], k
                n += 1
    assert n


def test_meshes_and_their_batch_axes():
    """The production meshes are specs no process holds; the smoke mesh a
    `DeviceMesh`; one `batch_axes` serves the serve mesh and the train
    rules (the model axis joins the batch under "fsdp")."""
    one = make_production_mesh()
    two = make_production_mesh(multi_pod=True)
    assert one == MeshSpec((16, 16), ("data", "model"))
    assert two == MeshSpec((2, 16, 16), ("pod", "data", "model"))
    smoke = make_smoke_mesh(model=2, devices=("cpu", "cpu"))
    assert isinstance(smoke, DeviceMesh) and smoke.spec.shape == (1, 2)
    assert batch_axes(two) == ("pod", "data")
    assert batch_axes(two, "fsdp") == ("pod", "data", "model")
    assert batch_axes(smoke) == ("data",)
    assert batch_axes(smoke, "fsdp") == ("data", "model")
    stand = StandInMesh(two)
    for layout in ("2d", "fsdp"):
        assert batch_axes(two, layout) == ref_shd.batch_axes(stand, layout)
    assert shd.axis_size(smoke, "model") == 2
    assert shd.axis_size(two, ("pod", "data")) == 32


def test_spec_shard_factor():
    mesh = make_production_mesh(multi_pod=True)
    assert shd.spec_shard_factor((), mesh) == 1
    assert shd.spec_shard_factor((None, "model"), mesh) == 16
    assert shd.spec_shard_factor((("pod", "data"), "model"), mesh) == 512
    assert shd.replicated({"a": torch.empty(2, 3, device="meta")},
                          mesh) == {"a": ()}


# ---------------------------------------------------------------------------
# constrain(): the reference's resolved spec; the tensor itself back
# ---------------------------------------------------------------------------

def _ref_resolved(monkeypatch, shape, dims, stand, layout):
    """The spec the reference's ``constrain`` hands to XLA (None where it
    skips), caught at its ``with_sharding_constraint``."""
    seen = []
    monkeypatch.setattr(ref_shd, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    x = jax.ShapeDtypeStruct(shape, np.float32)
    with ref_shd.activation_sharding(stand, layout):
        ref_shd.constrain(x, dims)
    return seen[0] if seen else None


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("layout", ["2d", "fsdp"])
@pytest.mark.parametrize("dims", ["b.", ".m", "d.", "bm", "bd", "b.m", "..",
                                  "mb", "bmd"])
def test_activation_spec_matches_the_reference(monkeypatch, dims, layout,
                                               mesh_name):
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    stand = StandInMesh(mesh)
    for sizes in ((256, 4096, 32), (32, 48, 8), (1, 16, 512), (512, 3, 3)):
        shape = sizes[:len(dims)]
        want = _ref_resolved(monkeypatch, shape, dims, stand, layout)
        assert shd.activation_spec(shape, dims, mesh, layout) == want, shape
        x = torch.empty(shape, device="meta")
        with shd.activation_sharding(mesh, layout):
            assert shd.constrain(x, dims) is x
            assert shd.active_mesh() is mesh
        assert shd.active_mesh() is None


def test_constrain_noop_without_context():
    x = torch.zeros((4, 8))
    assert shd.constrain(x, "b.") is x
    assert shd.constrain_replicated(x) is x


def test_constrain_conflicting_axes_skipped():
    mesh = make_production_mesh()
    x = torch.zeros((16, 16))
    # batch and experts both want "data" -> the constraint is skipped
    assert shd.activation_spec((16, 16), "bd", mesh, "2d") is None
    with shd.activation_sharding(mesh, "2d"):
        assert shd.constrain(x, "bd") is x
    with pytest.raises(ValueError):
        shd.activation_spec((16,), "b.", mesh, "2d")


def test_constrain_replicated_gathers_under_serve():
    from repro_torch.runtime.mesh import serve_mesh
    mesh = serve_mesh((1, 2), devices=("cpu", "cpu"))
    x = shd.Shards([torch.ones(2, 3), torch.zeros(2, 3)], -1)
    with shd.activation_sharding(mesh, "2d"):
        assert shd.constrain_replicated(x) is x
    with shd.activation_sharding(mesh, "serve"):
        got = shd.constrain_replicated(x)
    assert torch.equal(got, torch.cat([torch.ones(2, 3),
                                       torch.zeros(2, 3)], -1))


# ---------------------------------------------------------------------------
# run_serve_cell: the reference's record, number for number
# ---------------------------------------------------------------------------

# the time and fit terms read the hardware constants (a TPU v5e's in the
# reference, an H100's here); every byte and FLOP count is compared as is
_HW_KEYS = ("decode_compute_s", "decode_memory_s", "fits_hbm_per_device")


def _same_serve_record(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        if k not in _HW_KEYS:
            assert port[k] == ref[k], (k, port[k], ref[k])
    assert port["decode_compute_s"] == (port["decode_flops_per_device"]
                                        / hw.PEAK_FLOPS)
    assert port["decode_memory_s"] == (port["bytes_per_device"] / hw.HBM_BW)
    assert port["fits_hbm_per_device"] == (port["bytes_per_device"]
                                           < hw.HBM_BYTES)


@pytest.mark.parametrize("arch", DECODERS)
@pytest.mark.parametrize("mesh_shape", [(1, 1), (1, 2), (1, 4)])
def test_serve_cell_matches_the_reference(arch, mesh_shape, ref_dryrun):
    kw = dict(mesh_shape=mesh_shape, slots=8, max_len=1024)
    _same_serve_record(dryrun.run_serve_cell(arch, **kw),
                       ref_dryrun.run_serve_cell(arch, **kw))


def test_serve_cell_per_shard_accounting(ref_dryrun):
    one = dryrun.run_serve_cell("smollm-360m", mesh_shape=(1, 1), slots=4,
                                max_len=64, smoke=True)
    # a 1-device mesh: per-device == total, everything accounted
    assert one["params_bytes_per_device"] == one["params_bytes"] > 0
    assert one["state_bytes_per_device"] == one["state_bytes"] > 0
    assert 0 < one["kv_pool_bytes"] <= one["state_bytes"]

    two = dryrun.run_serve_cell("minicpm3-4b", mesh_shape=(1, 2), slots=2,
                                max_len=64, smoke=True)
    # MLA paged pools split their latent dim over 2 model shards
    assert two["kv_pool_bytes_per_device"] * 2 == two["kv_pool_bytes"]
    # column-parallel params shard, row-parallel replicate: strictly
    # between the all-replicated and all-sharded extremes
    assert (two["params_bytes"] // 2
            < two["params_bytes_per_device"] < two["params_bytes"])
    assert two["decode_flops_per_device"] * 2 == two["decode_flops"]
    assert two["mesh_devices"] == 2
    for got, args in ((one, ("smollm-360m", (1, 1), 4)),
                      (two, ("minicpm3-4b", (1, 2), 2))):
        _same_serve_record(got, ref_dryrun.run_serve_cell(
            args[0], mesh_shape=args[1], slots=args[2], max_len=64,
            smoke=True))


def test_serve_cell_engine_placement():
    """``whole`` accounts as the engine places a mesh: the named column
    leaves whole on the lead, replicated leaves once on the lead, each
    rank its parts; the per-rank bytes add up to the totals."""
    rec = dryrun.run_serve_cell("starcoder2-3b", mesh_shape=(1, 2), slots=2,
                                max_len=64, smoke=True,
                                param_dtype=torch.bfloat16,
                                whole=("wq", "wk", "wv"))
    assert rec["whole_leaves"] == ["wk", "wq", "wv"]
    for k in ("params", "state", "kv_pool"):
        per_rank = rec[f"{k}_bytes_per_rank"]
        assert len(per_rank) == 2 and sum(per_rank) == rec[f"{k}_bytes"]
        assert per_rank[0] == rec[f"{k}_bytes_per_device"]
    ref_like = dryrun.run_serve_cell("starcoder2-3b", mesh_shape=(1, 2),
                                     slots=2, max_len=64, smoke=True,
                                     param_dtype=torch.bfloat16)
    assert "whole_leaves" not in ref_like
    assert (rec["params_bytes_per_device"]
            > ref_like["params_bytes_per_device"])


def test_serve_shard_factors_mirror_sharding_rules():
    """The pure divisor helpers agree with the serve rules: a leaf's factor
    is the model-axis size exactly when the named rule's dim divides, else
    1 (replication); the reference's helpers give the same factors."""
    cfg = get_smoke_config("minicpm3-4b")
    state = init_decode_state(cfg, 2, 64, kv="paged", device="meta")
    ref_state = jax.eval_shape(lambda: ref_init_state(
        ref_smoke("minicpm3-4b"), 2, 64, kv="paged"))
    ref_paths = {_ref_key(p): p for p, _ in
                 jax.tree_util.tree_flatten_with_path(ref_state)[0]}
    factors = {}
    for path, leaf in _port_leaves(state).items():
        f = shd.serve_state_shard_factor(path, tuple(leaf.shape), 2)
        assert f == ref_shd.serve_state_shard_factor(
            ref_paths[path], tuple(leaf.shape), 2), path
        factors.setdefault(shd._leaf_name(path), set()).add(f)
        assert shd.serve_state_shard_factor(path, tuple(leaf.shape), 1) == 1
    # MLA latent pools split; control leaves replicate
    assert factors["ckvp"] == {2} and factors["kropep"] == {2}
    assert factors["pos"] == {1} and factors["block_tables"] == {1}


# ---------------------------------------------------------------------------
# run_cell: the reference's record from a meta run
# ---------------------------------------------------------------------------

# the record's keys, as the reference's run_cell writes them
REF_RECORD = {"arch", "shape", "mode", "mesh", "flags", "moe_partition",
              "layout", "params", "active_params", "lower_seconds",
              "compile_seconds", "memory", "cost_analysis_raw",
              "collectives_raw", "hlo_cost", "roofline", "fits_hbm"}
REF_MEMORY = {"argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "total_nonalias_bytes"}
REF_HLO_COST = {"flops", "bytes_unfused", "bytes_fused", "transcendentals",
                "collective_bytes", "collective_counts",
                "total_collective_bytes", "top_collectives"}
REF_ROOFLINE = {"compute_s", "memory_s", "collective_s", "dominant",
                "model_flops_global", "model_flops_per_chip",
                "useful_flops_ratio", "roofline_step_s", "roofline_fraction"}


@pytest.mark.parametrize("arch,shape", [("mamba2-370m", "decode_32k"),
                                        ("smollm-360m", "train_4k")])
def test_run_cell_record(arch, shape, ref_dryrun):
    rec = dryrun.run_cell(arch, shape)
    assert REF_RECORD <= set(rec)
    assert REF_MEMORY <= set(rec["memory"])
    assert REF_HLO_COST <= set(rec["hlo_cost"])
    assert REF_ROOFLINE <= set(rec["roofline"])
    assert rec["mesh"] == {"shape": [16, 16], "axes": ["data", "model"]}
    t = rec["roofline"]
    cfg = get_config(arch)
    assert t["model_flops_global"] == ref_dryrun._model_flops(
        ref_config(arch), REF_SHAPES[shape], SHAPES[shape].mode)
    assert t["compute_s"] == rec["hlo_cost"]["flops"] / hw.PEAK_FLOPS > 0
    assert t["memory_s"] == rec["hlo_cost"]["bytes_fused"] / hw.HBM_BW > 0
    assert t["collective_s"] is None and t["dominant"] in ("compute_s",
                                                           "memory_s")
    assert t["roofline_step_s"] == max(t["compute_s"], t["memory_s"])
    assert rec["hlo_cost"]["flops"] * 256 == rec["hlo_cost"]["flops_global"]
    assert 0 < t["useful_flops_ratio"] <= 1.5
    assert isinstance(rec["fits_hbm"], bool)
    assert rec["params"] == cfg.param_count()
    assert any("ideal split" in n for n in rec["notes"])
    m = rec["memory"]
    assert m["total_nonalias_bytes"] == (
        m["argument_size_in_bytes"] + m["output_size_in_bytes"]
        + m["temp_size_in_bytes"] - m["alias_size_in_bytes"])
    assert m["alias_size_in_bytes"] > 0          # state updated in place
    json.dumps(rec)


@pytest.mark.parametrize("flag,value", dryrun.KERNEL_FLAGS)
def test_kernel_flags_refused_on_meta(flag, value):
    with pytest.raises(ValueError, match=flag):
        dryrun.run_cell("smollm-360m", "decode_32k", flags={flag: value})


def test_cli_writes_the_cell_record(tmp_path, monkeypatch, capsys):
    # the port's records go apart from the reference's results/dryrun/
    assert dryrun.RESULTS == REPO / "results" / "dryrun_torch"
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    assert dryrun.main(["--arch", "mamba2-370m", "--shape",
                        "decode_32k"]) == 0
    rec = json.loads((tmp_path / "pod16x16" /
                      "mamba2-370m__decode_32k.json").read_text())
    t = rec["roofline"]
    assert t["compute_s"] > 0 and t["memory_s"] > 0
    assert rec["hlo_cost"]["flops"] > 0
    assert json.loads(capsys.readouterr().out)["cell"] == (
        "mamba2-370m x decode_32k")
    assert dryrun.main(["--arch", "smollm-360m", "--serve-mesh", "1x2",
                        "--smoke"]) == 0
    assert json.loads(capsys.readouterr().out)["mesh_devices"] == 2
