"""Elastic scaling: live-pilot membership -> mesh + reshard plan.

The model axis is fixed per slice (a payload's TP degree is baked into its
compiled executable); the data axis grows/shrinks with the live-pilot set.
Membership changes therefore never require resharding *within* a slice —
they change how many slices the repo fans batches out to, and training
payloads resume from the last checkpoint with a recomputed data axis.

`plan_remesh` is pure host logic: given old/new membership it emits a
ReshardPlan that the launcher executes through the checkpoint store
(save at old mesh -> restore at new mesh; per-leaf shapes are mesh-
independent so the numpy checkpoints are directly portable).
"""

from __future__ import annotations

import dataclasses

from repro_torch.runtime.mesh import MeshSpec


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    old_mesh: MeshSpec | None
    new_mesh: MeshSpec
    reason: str
    # batch re-split: global batch stays fixed; per-slice microbatch changes
    global_batch: int
    old_per_data: int | None
    new_per_data: int
    # instructions executed by the launcher
    actions: tuple[str, ...]


class NoViableMeshError(ValueError):
    """Fleet membership admits no mesh at all — e.g. every pilot is gone.

    An explicit outcome, not a bogus 1-slice plan: the caller must wait for
    capacity (or page an operator), never "resume" onto slices that do not
    exist."""


def viable_data_axis(n_live: int, global_batch: int) -> int:
    """Largest data-parallel degree <= n_live that divides global_batch.
    Raises :class:`NoViableMeshError` when there are no live slices — a
    fleet that lost every pilot has no data axis, not a data axis of 1."""
    if n_live <= 0:
        raise NoViableMeshError(
            f"no viable data axis: {n_live} live slices (the fleet is empty; "
            f"hold the workload and wait for capacity)")
    for d in range(min(n_live, global_batch), 0, -1):
        if global_batch % d == 0:
            return d
    return 1


def plan_remesh(old: MeshSpec | None, n_live_slices: int, model_parallel: int,
                global_batch: int, reason: str = "membership-change") -> ReshardPlan:
    if n_live_slices < 1:
        raise NoViableMeshError(
            f"no viable mesh: {n_live_slices} live slices "
            f"(reason={reason!r}); refusing to emit a remesh plan for an "
            f"empty fleet")
    data = viable_data_axis(n_live_slices, global_batch)
    new = MeshSpec((data, model_parallel), ("data", "model"))
    actions = ["drain-payloads", "checkpoint-if-training"]
    if old is not None and old.shape == new.shape:
        actions = ["no-op"]
    else:
        actions += ["rebuild-mesh", "restore-checkpoint", "resume"]
    return ReshardPlan(
        old_mesh=old,
        new_mesh=new,
        reason=reason,
        global_batch=global_batch,
        old_per_data=None if old is None else global_batch // old.axis_size("data"),
        new_per_data=global_batch // data,
        actions=tuple(actions),
    )
