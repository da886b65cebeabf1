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
    "configs/gemma_2b.py": ({}, None),
    "configs/minicpm3_4b.py": ({}, None),
    "configs/mixtral_8x7b.py": ({}, None),
    "configs/starcoder2_3b.py": ({}, None),
    "core/arena.py": ({}, None),
    "core/proctable.py": ({}, None),
    "core/timerwheel.py": ({}, None),
    "core/taskrepo.py": ({}, None),
    "core/monitor.py": ({}, None),
    "core/chaos.py": ({}, None),
    "core/autoscaler.py": ({}, None),
    "serving/dispatch.py": ({}, None),
    "runtime/elastic.py": ({}, None),
    # MeshSpec alone: a docstring of its own; the reference's imports of
    # jax and typing.Sequence, MeshSpec.build and everything after
    # MeshSpec build JAX meshes (ROADMAP.md Queue 1 item 8)
    "runtime/mesh.py": (
        {n: "the port's docstring: MeshSpec alone" for n in range(1, 9)},
        [(9, 12), (17, 52)]),
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
