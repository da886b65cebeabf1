"""Chaos fault injection for the pilot fleet (gray-failure drills).

The paper's pilot model targets opportunistic, preemptible Kubernetes
slices where disruption is NORMAL operation — and production dHTC
failures are mostly *gray*, not clean crashes: payloads that stall while
still renewing their leases, pilots running 5-10x slow, heartbeats that
silently drop, network partitions that cut the control plane while the
payload keeps computing, and poison requests that serially kill every
pilot they touch.  This module injects exactly those faults into a
running :class:`~repro_torch.core.cluster.ClusterSim` fleet on a declarative
schedule, so the hardening layers (progress watchdog, hedged
re-dispatch, backoff requeue, poison quarantine — see
``serving/dispatch.py``) can be driven end to end by a scripted trace.

Fault taxonomy (``FaultSpec.kind``):

``crash``
    Hard node loss via ``ClusterSim.fail_pilot`` — the one fault the
    substrate already survives (PR 4).  Included so chaos plans can mix
    clean and gray failures.
``stall``
    The serve payload stops making progress but KEEPS renewing its
    leases — invisible to the lease-expiry reaper by construction; only
    the dispatcher's progress watchdog can see it.
``slow``
    Step-time inflation by ``factor`` — the straggler that hedged
    re-dispatch rescues.
``flaky_heartbeat``
    Telemetry samples (``report_telemetry``) drop with probability
    ``drop_rate`` (deterministic per-site RNG) — the autoscaler's
    demand signal degrades but leases stay healthy.
``partition``
    Control-plane cut: lease renewals, fetches, and completions all
    fail while the payload keeps computing.  Leases expire and the work
    is replayed elsewhere; if the partition heals first, the original
    may still race the replay (first completion wins keeps it exactly
    once either way).

Injection is *cooperative and unprivileged*, matching the repo's
simulation idiom: the serve loop (``core/wrapper.py``) and the pilot's
renew tick (``core/pilot.py``) consult :func:`site` — a process-global
per-server fault register — at each tick.  When no controller is
installed the lookup is one dict probe returning ``None``, so the hot
path costs nothing outside chaos drills.

Poison requests: a request entry carrying ``{"poison": True}`` is only
*lethal* while a controller with ``FaultPlan.poison`` is installed — the
serve loop calls :meth:`ChaosSite.trip_poison` when it fetches one,
which hard-kills the pilot (the request's lease then expires and the
dispatcher's blast-radius accounting takes over).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
import zlib

from repro_torch.analysis.locks import make_lock


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault.  ``at_s`` is the offset from
    :meth:`ChaosController.start`; gray faults last ``duration_s`` and
    clear themselves (stamp-based — no end events to miss)."""
    kind: str                       # crash|stall|slow|flaky_heartbeat|partition
    at_s: float = 0.0
    duration_s: float = 1.0
    factor: float = 4.0             # slow: step-time inflation multiple
    drop_rate: float = 0.75        # flaky_heartbeat: P(sample dropped)
    victim: str | None = None       # explicit pilot_id; None = pick
    pick: str = "most-leases"       # most-leases | random


@dataclasses.dataclass
class FaultPlan:
    """A declarative chaos trace: scheduled faults + whether poison
    request entries are armed (lethal) for the run."""
    faults: list[FaultSpec] = dataclasses.field(default_factory=list)
    poison: bool = False
    seed: int = 0


class ChaosSite:
    """Per-server gray-fault state, consulted from inside the payload.

    All fields are plain floats/bools written by the controller thread
    and read by the serve loop — single-word updates under the GIL, no
    lock on the per-tick read path."""

    def __init__(self, server_id: str, controller: "ChaosController"):
        self.server_id = server_id
        self._controller = controller
        self._rng = random.Random(controller.seed
                                  ^ zlib.crc32(server_id.encode()))
        self.stall_until = 0.0
        self.slow_until = 0.0
        self.slow_by = 1.0
        self.cut_until = 0.0
        self.flaky_until = 0.0
        self.drop_rate = 0.0

    # -- per-tick queries (hot path: no locks) --------------------------

    def stalled(self) -> bool:
        return time.monotonic() < self.stall_until

    def slow_factor(self) -> float:
        return self.slow_by if time.monotonic() < self.slow_until else 1.0

    def partitioned(self) -> bool:
        return time.monotonic() < self.cut_until

    def drop_heartbeat(self) -> bool:
        if time.monotonic() >= self.flaky_until:
            return False
        return self._rng.random() < self.drop_rate

    def poison_lethal(self) -> bool:
        return self._controller.poison_armed

    def trip_poison(self, rid: int):
        """The server fetched a poison request: detonate (kill this
        pilot).  Called from the serve loop, which returns 143 right
        after — the lease is never released and expires normally."""
        self._controller._trip_poison(self.server_id, rid)


# -- process-global site registry (the simulation's "is chaos on?") -----

_LOCK = make_lock("chaos.install")
_ACTIVE: "ChaosController | None" = None


def site(server_id: str) -> ChaosSite | None:
    """The fault register for ``server_id``, or None when no chaos
    controller is installed (the common case — one attribute read)."""
    c = _ACTIVE
    return c.site_for(server_id) if c is not None else None


class ChaosController:
    """Executes a :class:`FaultPlan` against a live fleet.

    Usage::

        ctl = ChaosController(sim, fleet, pool=pool, plan=plan)
        ctl.start()          # t=0 for every FaultSpec.at_s
        ...traffic...
        ctl.stop()           # uninstalls; pending faults are dropped

    Only one controller is installed at a time (process-global, like the
    dispatcher pool registry).  ``log`` records every fault actually
    applied — benchmarks introspect it for gates like "poison killed at
    most 2 pilots"."""

    def __init__(self, sim, fleet=None, *, pool=None,
                 plan: FaultPlan | None = None):
        self.sim = sim
        self.fleet = fleet
        self.pool = pool
        self.plan = plan or FaultPlan()
        self.seed = self.plan.seed
        self.poison_armed = bool(self.plan.poison)
        self._rng = random.Random(self.seed)
        self._sites: dict[str, ChaosSite] = {}
        self._sites_lock = make_lock("chaos.sites")
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.log: list[dict] = []
        self.poison_kills: dict[int, int] = {}   # rid -> pilots killed
        self._victims: set[str] = set()          # pilots already targeted

    # -- site registry ---------------------------------------------------

    def site_for(self, server_id: str) -> ChaosSite:
        with self._sites_lock:
            s = self._sites.get(server_id)
            if s is None:
                s = self._sites[server_id] = ChaosSite(server_id, self)
            return s

    # -- lifecycle -------------------------------------------------------

    def start(self):
        global _ACTIVE
        with _LOCK:
            if _ACTIVE is not None and _ACTIVE is not self:
                raise RuntimeError("another ChaosController is installed")
            _ACTIVE = self
        self._stop.clear()
        self.t0 = time.monotonic()
        if self.plan.faults:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="chaos-controller")
            self._thread.start()
        return self

    def stop(self):
        global _ACTIVE
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with _LOCK:
            if _ACTIVE is self:
                _ACTIVE = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- the schedule ----------------------------------------------------

    def _run(self):
        for f in sorted(self.plan.faults, key=lambda f: f.at_s):
            delay = self.t0 + f.at_s - time.monotonic()
            if delay > 0 and self._stop.wait(delay):
                return
            if self._stop.is_set():
                return
            try:
                self._apply(f)
            except Exception as e:       # noqa: BLE001 — a fault that fails
                # to land must not kill the remaining schedule
                self.log.append({"t": time.monotonic() - self.t0,
                                 "kind": f.kind, "error": repr(e)})

    def _apply(self, f: FaultSpec):
        victim = f.victim or self._pick(f)
        if victim is None:
            self.log.append({"t": time.monotonic() - self.t0,
                             "kind": f.kind, "victim": None,
                             "error": "no candidate"})
            return
        self._victims.add(victim)
        now = time.monotonic()
        if f.kind == "crash":
            self.kill_pilot(victim)
        else:
            s = self.site_for(victim)
            if f.kind == "stall":
                s.stall_until = now + f.duration_s
            elif f.kind == "slow":
                s.slow_by = f.factor
                s.slow_until = now + f.duration_s
            elif f.kind == "flaky_heartbeat":
                s.drop_rate = f.drop_rate
                s.flaky_until = now + f.duration_s
            elif f.kind == "partition":
                s.cut_until = now + f.duration_s
            else:
                raise ValueError(f"unknown fault kind {f.kind!r}")
        self.log.append({"t": now - self.t0, "kind": f.kind,
                         "victim": victim})

    def _pick(self, f: FaultSpec) -> str | None:
        """Victim selection among LIVE pilots not yet targeted (a plan's
        faults spread across the fleet; re-targeting a crashed pilot
        exercises nothing).  Falls back to already-targeted live pilots
        when every pilot has been hit."""
        live = ([p.pilot_id for p in self.fleet.live()]
                if self.fleet is not None
                else [p.pilot_id for p in self.sim.live_pilots()])
        if not live:
            return None
        fresh = [p for p in live if p not in self._victims] or live
        if f.pick == "most-leases" and self.pool is not None:
            holders = self.pool.lease_holders()
            fresh.sort(key=lambda p: -len(holders.get(p, [])))
            return fresh[0]
        return fresh[self._rng.randrange(len(fresh))]

    # -- actuators -------------------------------------------------------

    def kill_pilot(self, pilot_id: str) -> bool:
        return self.sim.fail_pilot(pilot_id)

    def _trip_poison(self, server_id: str, rid: int):
        self.poison_kills[rid] = self.poison_kills.get(rid, 0) + 1
        self.log.append({"t": time.monotonic() - self.t0, "kind": "poison",
                         "victim": server_id, "rid": rid})
        self.kill_pilot(server_id)

    def stats(self) -> dict:
        return {
            "faults_applied": len([e for e in self.log
                                   if "error" not in e]),
            "poison_kills": dict(self.poison_kills),
            "log": list(self.log),
        }
