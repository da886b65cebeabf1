"""Production and smoke meshes of the dry run.

Port of ``repro.launch.mesh``.  ``make_production_mesh()`` is the shape
the dry run accounts for, a `MeshSpec` that no process holds, as the
reference's 512 placeholder host devices back no real chip:

Single pod: (data=16, model=16) = 256 chips.
Multi-pod:  (pod=2, data=16, model=16) = 512 chips; the "pod" axis is the
slower cross-pod axis and carries only batch-parallel traffic.

``make_smoke_mesh()`` is a `DeviceMesh` over the devices present, as
`repro_torch.runtime.mesh.serve_mesh` builds one.
"""

from __future__ import annotations

from repro_torch.runtime.mesh import (
    DATA_AXIS, MODEL_AXIS, POD_AXIS, DeviceMesh, MeshSpec, serve_mesh)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec((2, 16, 16), (POD_AXIS, DATA_AXIS, MODEL_AXIS))
    return MeshSpec((16, 16), (DATA_AXIS, MODEL_AXIS))


def make_smoke_mesh(*, data: int = 1, model: int = 1,
                    devices=None) -> DeviceMesh:
    """A (data, model) mesh over ``devices`` (one per rank; None: the
    cards cuda:0..N-1, raising on fewer)."""
    return serve_mesh((data, model), devices)
