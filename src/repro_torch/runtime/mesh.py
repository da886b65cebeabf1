"""``MeshSpec`` alone, from the reference's ``runtime/mesh.py``.

It is JAX-free and the pilot system's elastic planning
(``runtime/elastic.py``) needs it.  The rest of that module builds JAX
device meshes; the port's counterpart comes with tensor-parallel serving
(``ROADMAP.md`` Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import math

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
