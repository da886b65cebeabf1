"""Mesh helpers of the port: ``MeshSpec``, the serve mesh and its axes.

Port of ``repro.runtime.mesh``.  A JAX mesh is one program over many
devices; the port's is one process holding one ``torch.device`` per rank
(`DeviceMesh`), which the serve path loops over inside each layer.  Ranks
may share a card when the caller places them so (``devices=("cuda:0",
"cuda:0")``); `serve_mesh` never does it on its own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

# Canonical physical axis names, outermost first.  "pod" is the slowest /
# cross-ICI axis, "data" is the pure-replication/batch axis, "model" is the
# tensor-parallel axis (fast ICI ring).
POD_AXIS = "pod"
DATA_AXIS = "data"
MODEL_AXIS = "model"
ALL_AXES = (POD_AXIS, DATA_AXIS, MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh description (used by configs and the pilot system).

    A PilotSlice is provisioned against a MeshSpec; the payload never gets to
    change it (late binding swaps the executable, not the resource grant).
    """

    shape: tuple[int, ...]
    axes: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} mismatch")
        for a in self.axes:
            if a not in ALL_AXES:
                raise ValueError(f"unknown mesh axis {a!r}; expected {ALL_AXES}")

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        if name not in self.axes:
            return 1
        return self.shape[self.axes.index(name)]


class DeviceMesh:
    """A `MeshSpec` placed on devices: ``devices`` is an object array of
    ``torch.device`` of the spec's shape, read as a JAX mesh's
    ``mesh.devices`` is.  ``shape`` maps each axis to its size, as JAX's
    ``Mesh.shape`` does."""

    def __init__(self, spec: MeshSpec, devices: np.ndarray):
        if devices.shape != spec.shape:
            raise ValueError(f"devices of shape {devices.shape} for a mesh "
                             f"of shape {spec.shape}")
        self.spec = spec
        self.devices = devices

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.spec.axes

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.spec.axes, self.spec.shape))

    @property
    def model_devices(self) -> tuple[torch.device, ...]:
        """The devices of the model ranks (data index 0), rank order."""
        flat = self.devices.reshape(-1, self.spec.axis_size(MODEL_AXIS))
        return tuple(flat[0])

    @property
    def lead(self) -> torch.device:
        """Rank 0's device: replicated leaves and gathers live there."""
        return self.model_devices[0]

    def key(self) -> tuple:
        return (self.spec.shape, self.spec.axes,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other):
        return isinstance(other, DeviceMesh) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        return (f"DeviceMesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.flat]})")


def parse_mesh_shape(text: str) -> tuple[int, ...]:
    """Parse the CLI/image mesh-shape syntax ``"AxB"`` (e.g. ``"1x2"``,
    ``"2x4"``) into a shape tuple.  A bare integer means ``1xN`` (pure
    tensor parallelism)."""
    parts = [p for p in str(text).lower().split("x") if p]
    if not parts:
        raise ValueError(f"bad mesh shape {text!r}; expected 'AxB'")
    try:
        shape = tuple(int(p) for p in parts)
    except ValueError as e:
        raise ValueError(f"bad mesh shape {text!r}; expected 'AxB'") from e
    if any(s < 1 for s in shape):
        raise ValueError(f"bad mesh shape {text!r}; dims must be >= 1")
    if len(shape) == 1:
        shape = (1,) + shape
    if len(shape) != 2:
        raise ValueError(f"bad mesh shape {text!r}; serve meshes are 2-D "
                         f"(data x model)")
    return shape


def serve_mesh_spec(shape: tuple[int, ...] | str) -> MeshSpec:
    """The serve-path mesh: ``(data, model)``.  The model axis carries the
    tensor-parallel shards of params and paged-KV pools; the data axis is
    pure replication headroom (slots are not batch-sharded in serve)."""
    if isinstance(shape, str):
        shape = parse_mesh_shape(shape)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2:
        raise ValueError(f"serve mesh shape must be 2-D (data, model), "
                         f"got {shape}")
    return MeshSpec(shape, (DATA_AXIS, MODEL_AXIS))


def serve_mesh(shape: tuple[int, ...] | str,
               devices: Sequence | None = None) -> DeviceMesh:
    """Build the serve mesh for ``shape`` (``"AxB"`` or a tuple) over
    ``devices``, one per rank in ``(data, model)`` order.  ``None`` takes
    ``cuda:0 .. cuda:N-1`` and raises when the machine has fewer cards: it
    never puts two ranks on one card by itself.  A caller that wants that
    passes the devices (``("cuda:0", "cuda:0")``)."""
    from repro_torch.models.api import resolve_device
    spec = serve_mesh_spec(shape)
    n = spec.num_devices
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"serve mesh {spec.shape} needs {n} CUDA devices and this "
                f"machine has {have}; pass devices= to place the ranks "
                f"(e.g. ('cuda:0', 'cuda:0') for two ranks on one card)")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = [resolve_device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"serve mesh {spec.shape} takes {n} devices, "
                         f"got {len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return DeviceMesh(spec, arr.reshape(spec.shape))


def mesh_axis_size(mesh: DeviceMesh, name: str) -> int:
    """Size of a named axis; 1 if the mesh does not have it."""
    return mesh.shape.get(name, 1) if hasattr(mesh.shape, "get") else dict(
        zip(mesh.axis_names, mesh.devices.shape)
    ).get(name, 1)


def batch_axes(mesh: DeviceMesh, layout: str = "2d") -> tuple[str, ...]:
    """Physical axes the global batch is sharded over (pod+data); under
    the train rules' "fsdp" layout the model axis too (no tensor
    parallelism).  ``mesh`` may also be a `MeshSpec`."""
    names = mesh.axes if isinstance(mesh, MeshSpec) else mesh.axis_names
    pool = ALL_AXES if layout == "fsdp" else (POD_AXIS, DATA_AXIS)
    return tuple(a for a in pool if a in names)


def batch_parallelism(mesh: DeviceMesh) -> int:
    out = 1
    for a in batch_axes(mesh):
        out *= mesh_axis_size(mesh, a)
    return out


def model_parallelism(mesh: DeviceMesh) -> int:
    return mesh_axis_size(mesh, MODEL_AXIS)
