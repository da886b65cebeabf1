"""The port's copies of the reference's JAX-free modules stay copies.

The pilot system's control plane has no JAX in it, and the port keeps its
own copy of each such module instead of importing ``repro``.  Each copy's
source equals the reference's once ``repro.`` is replaced by
``repro_torch.``, except for the lines listed here by number, each with
its reason; a copy of part of a module names the reference lines it
keeps.  A change to either side shows up here, so the copies cannot drift
apart unseen.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# path -> (port lines that are the port's own {line: reason}, the
# reference's kept lines as 1-based inclusive ranges, or None for all)
COPIES = {
    "analysis/locks.py": ({}, None),
    # the port's docstring names no change of the reference's history
    "analysis/fuzz.py": ({16: "the port's docstring"},
                         [(1, 15), (17, 305)]),
    # the exempt path of bare-lock names the port's own analysis package (a
    # slash path, which the copy rule does not rewrite)
    "analysis/lint.py": ({288: "the port's package in the exempt path"},
                         [(1, 287), (289, 340)]),
    "configs/gemma_2b.py": ({}, None),
    "configs/jamba_v01_52b.py": ({}, None),
    "configs/llava_next_mistral_7b.py": ({}, None),
    "configs/minicpm3_4b.py": ({}, None),
    "configs/mixtral_8x7b.py": ({}, None),
    "configs/starcoder2_3b.py": ({}, None),
    "configs/whisper_small.py": ({}, None),
    "core/arena.py": ({}, None),
    "core/proctable.py": ({}, None),
    "core/timerwheel.py": ({}, None),
    "core/taskrepo.py": ({}, None),
    "core/monitor.py": ({}, None),
    "core/chaos.py": ({}, None),
    "core/autoscaler.py": ({}, None),
    "serving/dispatch.py": ({}, None),
    # the port's docstring lines on the handoff's wire format, and its
    # "Invariants:" in place of the reference's line naming its own test
    "serving/blockpool.py": (
        {**{n: "the port's docstring: the handoff's wire format"
            for n in range(2, 7)},
         15: "the port's docstring: no reference test named"},
        [(1, 9), (11, 229)]),
    "runtime/elastic.py": ({}, None),
    # the port's mesh: a docstring of its own, numpy and torch in place of
    # the reference's jax imports, DeviceMesh in place of MeshSpec.build
    # and make_mesh (a JAX Mesh), its own serve_mesh (devices one per
    # rank, never wrapped onto fewer cards), and DeviceMesh in the
    # helpers' annotations
    "runtime/mesh.py": (
        {**{n: "the port's docstring" for n in range(1, 8)},
         **{n: "numpy and torch, not jax" for n in (16, 17)},
         **{n: "DeviceMesh, not MeshSpec.build/make_mesh"
            for n in range(55, 101)},
         **{n: "the port's serve_mesh" for n in range(138, 162)},
         **{n: "DeviceMesh in an annotation" for n in (164, 171, 176, 183)}},
        [(7, 14), (17, 53), (65, 101), (105, 106), (108, 113), (115, 118),
         (120, 125), (127, 127)]),
}


def _as_port(line: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", line)


@pytest.mark.parametrize("path", sorted(COPIES))
def test_copy_equals_the_reference(path):
    own, kept = COPIES[path]
    ref = (REF / path).read_text().splitlines()
    port = (PORT / path).read_text().splitlines()
    if kept is not None:
        ref = [ref[i - 1] for a, b in kept for i in range(a, b + 1)]
    mine = [line for n, line in enumerate(port, 1) if n not in own]
    want = [_as_port(line) for line in ref]
    diff = [(n, a, b) for n, (a, b) in enumerate(zip(mine, want), 1)
            if a != b]
    assert not diff, f"{path}: first differing kept line {diff[0]}"
    assert len(mine) == len(want), (path, len(mine), len(want))


@pytest.mark.parametrize("path", sorted(COPIES))
def test_copy_imports_only_the_port(path):
    text = (PORT / path).read_text()
    assert not re.search(r"^\s*(from|import)\s+(jax|repro)\b", text, re.M)


def test_mesh_spec_behaves_as_the_reference():
    from repro.runtime.mesh import MeshSpec as RefSpec
    from repro_torch.runtime.mesh import MeshSpec
    for shape, axes in (((2, 4), ("data", "model")), ((3,), ("pod",))):
        a, b = MeshSpec(shape, axes), RefSpec(shape, axes)
        assert a.num_devices == b.num_devices
        assert [a.axis_size(n) for n in ("pod", "data", "model")] == \
            [b.axis_size(n) for n in ("pod", "data", "model")]
    with pytest.raises(ValueError):
        MeshSpec((2,), ("rows",))


def test_elastic_plan_matches_the_reference():
    from repro.runtime.elastic import plan_remesh as ref_plan
    from repro_torch.runtime.elastic import NoViableMeshError, plan_remesh
    for n_live in (1, 3, 4, 7):
        a = plan_remesh(None, n_live, 2, 8)
        b = ref_plan(None, n_live, 2, 8)
        assert (a.new_mesh.shape, a.new_per_data, a.actions) == \
            (b.new_mesh.shape, b.new_per_data, b.actions)
    with pytest.raises(NoViableMeshError):
        plan_remesh(None, 0, 1, 8)
