"""ClusterSim — the resource provider (Kubernetes / kubelet analogue).

Grants *slices* (pods' worth of devices) to pilot jobs, injects node
failures, and supports elastic grow/shrink.  The simulation is deliberately
thin: its job is to exercise the pilot system's provisioning-facing
contracts (grant -> run -> release; hard failure -> lease expiry -> re-queue;
membership change -> remesh plan) so they are testable without a cluster.

The :class:`Fleet` layer manages N pilots as one unit — spawn, scale up,
graceful scale-down, await-drained — all notification-driven:
``run_until_drained``/``Fleet.await_drained`` block on the repo's drain
event instead of polling ``stats()`` on a timer.

Port of ``repro.core.cluster``.  The simulated cluster sits on the torch
devices of one ``device`` type: ``ClusterSim(device="cuda")`` (the
default) grants the cards of this host and raises without one; the CPU
runs only when the caller asks for ``"cpu"``.  A slice's ``device`` is
the one its payloads bind on.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Optional

import torch

from repro_torch.analysis.locks import make_lock
from repro_torch.core.images import ExecutableRegistry
from repro_torch.core.pilot import Pilot, PilotConfig, TERMINAL_STATES
from repro_torch.core.taskrepo import TaskRepo
from repro_torch.models.api import resolve_device
from repro_torch.runtime.elastic import plan_remesh
from repro_torch.runtime.mesh import MeshSpec


def _pilot_record(p: "Pilot") -> dict:
    """What survives a reaped pilot: identity, the full state-machine path,
    and the accounting the autoscaler benchmarks charge against."""
    return {
        "pilot_id": p.pilot_id,
        "slice_id": p.slice.slice_id,
        "state": p.state,
        "state_log": list(p.state_log),
        "payloads_run": p.payloads_run,
        "error": p.error,
        "pilot_seconds": p.pilot_seconds(),
    }


def _devices(device: torch.device) -> list[torch.device]:
    """The torch devices of ``device``'s type on this host."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


@dataclasses.dataclass
class PilotSlice:
    slice_id: int
    devices: list
    labels: dict = dataclasses.field(default_factory=dict)
    mesh: Optional[object] = None
    released: bool = False
    device: Optional[torch.device] = None

    def release(self):
        self.released = True


class ClusterSim:
    def __init__(self, repo: TaskRepo | None = None,
                 registry: ExecutableRegistry | None = None, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.repo = repo or TaskRepo()
        self.registry = registry or ExecutableRegistry()
        self._ids = itertools.count(1)
        self._lock = make_lock("cluster.sim")
        self.slices: dict[int, PilotSlice] = {}
        self.pilots: dict[int, Pilot] = {}
        # reaped (terminal, thread-joined) pilots: bounded, state_log kept
        self.pilot_history: deque[dict] = deque(maxlen=512)

    # ---- provisioning -------------------------------------------------------

    def provision(self, n_slices: int = 1, *, labels: dict | None = None,
                  mesh=None) -> list[PilotSlice]:
        """``n_slices`` slices of this host's devices; with ``mesh`` (a
        `repro_torch.runtime.mesh.DeviceMesh`) each slice holds the mesh's
        devices and runs on its lead device."""
        devs = (list(mesh.devices.flat) if mesh is not None
                else _devices(self.device))
        out = []
        with self._lock:
            for _ in range(n_slices):
                sid = next(self._ids)
                s = PilotSlice(slice_id=sid, devices=list(devs),
                               labels=dict(labels or {}), mesh=mesh,
                               device=(mesh.lead if mesh is not None
                                       else self.device))
                self.slices[sid] = s
                out.append(s)
        return out

    def spawn_pilot(self, slice_: PilotSlice,
                    config: PilotConfig | None = None) -> Pilot:
        p = Pilot(slice_, self.repo, self.registry, config)
        with self._lock:
            self.pilots[slice_.slice_id] = p
        p.start_async()
        return p

    def spawn_fleet(self, n_pilots: int, config: PilotConfig | None = None,
                    *, labels: dict | None = None, mesh=None) -> "Fleet":
        """Provision n slices and start a pilot on each, as one Fleet."""
        fleet = Fleet(self, config, labels=labels, mesh=mesh)
        fleet.scale_up(n_pilots)
        return fleet

    # ---- failure injection / drain -------------------------------------------

    def fail_node(self, slice_id: int):
        """Hard node loss: the pilot thread aborts without cleanup AND the
        payload processes die with the node; the lease expires and the repo
        re-queues the task.  For a SERVING pilot the same mechanism cascades
        one level down: the dead server stops renewing its per-request
        leases, so the fleet pool's reaper requeues its in-flight requests
        onto surviving servers (the headline fleet-serve scenario)."""
        from repro_torch.core.proctable import PAYLOAD_UID
        with self._lock:
            p = self.pilots.get(slice_id)
        if p:
            p.fail()
            p.proctable.kill_uid(PAYLOAD_UID)

    def fail_pilot(self, pilot_id: str) -> bool:
        """:meth:`fail_node` addressed by pilot_id — the identity fault
        drivers (chaos controller, fleet-serve kill loop) actually hold,
        since slice ids are an internal detail of provisioning."""
        with self._lock:
            target = next((sid for sid, p in self.pilots.items()
                           if p.pilot_id == pilot_id), None)
        if target is None:
            return False
        self.fail_node(target)
        return True

    def drain(self, slice_id: int):
        with self._lock:
            p = self.pilots.get(slice_id)
        if p:
            p.drain()

    # ---- elasticity ------------------------------------------------------------

    def reap_pilots(self) -> int:
        """Prune pilots that reached a terminal state AND whose thread has
        exited.  Without reaping, ``pilots`` (and every ``live_pilots``
        scan) grows without bound across scale_up/scale_down cycles; the
        reaped pilots' ``state_log`` survives in the bounded
        ``pilot_history``."""
        with self._lock:
            dead = [(sid, p) for sid, p in self.pilots.items() if p.done()]
            for sid, p in dead:
                del self.pilots[sid]
                self.pilot_history.append(_pilot_record(p))
        return len(dead)

    def live_pilots(self) -> list[Pilot]:
        self.reap_pilots()
        with self._lock:
            return [p for p in self.pilots.values()
                    if p.state not in TERMINAL_STATES]

    def remesh_plan(self, model_parallel: int, global_batch: int,
                    old: MeshSpec | None = None):
        return plan_remesh(old, len(self.live_pilots()), model_parallel,
                           global_batch)

    # ---- convenience -------------------------------------------------------------

    def run_until_drained(self, timeout: float = 60.0,
                          poll: float | None = None) -> bool:
        """Block on the repo's drain event (queued == leased == 0).

        Lease expiry is serviced by the repo's deadline-heap timer, so there
        is nothing to poll; ``poll`` is kept for API compatibility and
        ignored.
        """
        return self.repo.wait_drained(timeout)

    def join_all(self, timeout: float = 10.0):
        for p in list(self.pilots.values()):
            p.join(timeout)


class Fleet:
    """A managed group of pilots over one ClusterSim (paper §4 at scale:
    provisioning N pods is one autoscaler action, not N manual spawns)."""

    def __init__(self, sim: ClusterSim, config: PilotConfig | None = None,
                 *, labels: dict | None = None, mesh=None):
        self.sim = sim
        self.config = config
        self.labels = labels
        self.mesh = mesh
        self._lock = make_lock("cluster.fleet")  # members churns from autoscaler
        self.members: list[Pilot] = []    # and driver threads concurrently
        self.history: deque[dict] = deque(maxlen=512)   # reaped members
        self._retired_seconds = 0.0

    # ---- scaling ------------------------------------------------------------

    def scale_up(self, n: int) -> list[Pilot]:
        """Provision n fresh slices and start a pilot on each.  During a
        fleet serve this is the join-mid-trace path: pair it with
        :meth:`submit_servers` and the new pilots lease into the request
        pool alongside the survivors."""
        started = []
        for s in self.sim.provision(n, labels=self.labels, mesh=self.mesh):
            started.append(self.sim.spawn_pilot(s, self.config))
        with self._lock:
            self.members.extend(started)
        return started

    def submit_servers(self, image, pool_name: str, *, n: int | None = None,
                       n_steps: int = 200_000, max_wall: float = 600.0,
                       spec: dict | None = None, **task_kw) -> list[int]:
        """Submit one serve-server task per pilot (default: one per live
        member).  Each server late-binds an engine onto its pilot's slice
        and leases requests from the named
        :class:`~repro_torch.serving.dispatch.FleetDispatcher` pool — the fleet
        analog of one trace-carrying serve task.  ``spec`` merges extra
        engine geometry (``slots``/``max_len``/``kv``/...) into the startup
        spec.  A labelled fleet's servers require its labels (unless the
        caller sets ``require_labels``), so they run on its own pilots and
        never on another fleet's drawing from the same repo."""
        n = n if n is not None else max(1, self.size())
        if self.labels:
            task_kw.setdefault("require_labels", dict(self.labels))
        return [self.sim.repo.submit(
            image, n_steps=n_steps, max_wall=max_wall,
            payload_spec={"dispatch": pool_name, **(spec or {})}, **task_kw)
            for _ in range(n)]

    def scale_down(self, n: int) -> list[Pilot]:
        """Gracefully drain the n most recently started live pilots.
        Pilots already draining don't count — back-to-back calls shed
        distinct pilots.  A draining SERVING pilot releases its leased
        requests back to the pool before exit (no lease-TTL wait): see
        ``Pilot.drain`` / ``wrapper._fleet_serve_loop``."""
        with self._lock:
            members = list(self.members)
        victims = [p for p in reversed(members)
                   if p.state not in TERMINAL_STATES
                   and not p.drain_flag.is_set()][:n]
        for p in victims:
            p.drain()
        return victims

    def reap(self) -> int:
        """Move terminal, thread-joined members into the bounded history
        (state_log preserved) and prune the ClusterSim registry too.  Runs
        implicitly on every ``live()``/``size()`` scan, so scale churn never
        grows the member list without bound."""
        with self._lock:
            done = [p for p in self.members if p.done()]
            for p in done:
                self.members.remove(p)
                self.history.append(_pilot_record(p))
                self._retired_seconds += p.pilot_seconds()
        self.sim.reap_pilots()
        return len(done)

    def live(self) -> list[Pilot]:
        self.reap()
        with self._lock:
            return [p for p in self.members if p.state not in TERMINAL_STATES]

    def size(self) -> int:
        return len(self.live())

    def draining(self) -> int:
        """Live members already asked to drain — capacity that is still
        counted by ``size()`` but is on its way out.  The autoscaler sizes
        against ``size() - draining()`` so a mid-drain victim is never
        double-counted (back-to-back scale_downs would overshoot)."""
        with self._lock:
            return sum(1 for p in self.members
                       if p.drain_flag.is_set()
                       and p.state not in TERMINAL_STATES)

    def pilot_seconds(self, now: float | None = None) -> float:
        """Total slice-holding wall time across the fleet's whole life —
        the resource-consumption metric autoscaling is judged on (reaped
        members included)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            total = self._retired_seconds
            members = list(self.members)
        return total + sum(p.pilot_seconds(now) for p in members)

    # ---- lifecycle ----------------------------------------------------------

    def await_drained(self, timeout: float = 60.0) -> bool:
        """Block until the repo has nothing queued or leased (drain event)."""
        return self.sim.repo.wait_drained(timeout)

    def drain_all(self):
        with self._lock:
            members = list(self.members)
        for p in members:
            p.drain()

    def join_all(self, timeout: float = 10.0):
        with self._lock:
            members = list(self.members)
        for p in members:
            p.join(timeout)
