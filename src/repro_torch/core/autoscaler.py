"""FleetAutoscaler — demand-driven pilot provisioning with hysteresis.

The paper's late-binding model assumes the provisioning layer reacts to
demand: pilot pools on Kubernetes grow from queue pressure and shrink by
draining idle pilots (the companion work: "Auto-scaling HTCondor pools
using Kubernetes compute resources", "Demand-driven provisioning of
Kubernetes-like resources in OSG").  Every actuator already exists —
``Fleet.scale_up``/``scale_down``, ``Fleet.submit_servers``, lease
reaping, ``ExecutableRegistry.prefetch`` — this module is the closed loop
that drives them.

Signal -> policy -> actuator::

    TaskRepo.stats()            queued/leased depth, live-pilot count
    TaskRepo.scheduler_metrics  match-latency p50/p99 (observability)
    FleetDispatcher.pool_pressure
        queued/leased request backlog, pool-level TTFT p50/p99,
        kv_memory_utilization + blocked_admissions from the servers'
        per-tick telemetry heartbeats
                 |
                 v
    AutoscalePolicy: demand-proportional target with a HYSTERESIS band
        (scale up above high_water utilization, down below low_water,
        hold in between), per-direction COOLDOWNS, min/max bounds,
        down_stable_ticks (a momentary dip never sheds capacity),
        optional scale-to-zero
                 |
                 v
    scale up:   registry.prefetch(image)  — compile overlaps provisioning,
                fleet.scale_up(n)           so new pilots bind a WARM image
                fleet.submit_servers(n)   — joiners lease into the live pool
    scale down: fleet.scale_down(n)       — victims drain: a serving pilot
                releases its leased requests back (immediate requeue),
                then exits via the pilot's normal drained path

Why hysteresis + per-direction cooldowns: a pure proportional controller
flaps — a burst's tail oscillates the target across the threshold and the
fleet thrashes pilots (each flap pays a drain + a re-provision + a
re-warm).  The band makes small demand wiggles invisible; the cooldowns
bound the decision rate per direction AND forbid an opposite-direction
decision inside the new direction's cooldown of the previous one, so
"up then immediately down" cannot happen by construction (``flaps()``
counts violations; benchmarks gate it at zero).

Scale-to-zero (``min_pilots == 0``): an idle fleet sheds every pilot —
victims exit through the existing drain/idle_grace path — and the loop
re-provisions from zero on the next burst (the paper's step (g)->(h)
loop run in reverse, then forward again).

The tick is timer-wheel-paced but ACTUATES on a dedicated thread: wheel
callbacks must stay short and non-blocking (they share the lease-reaper
thread), so the periodic timer only sets an event the actuator thread
waits on.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Callable

from repro_torch.core.timerwheel import shared_wheel


@dataclasses.dataclass
class AutoscalePolicy:
    min_pilots: int = 0                # 0 == scale-to-zero allowed
    max_pilots: int = 8
    # hysteresis band on demand / (live * slots_per_pilot): above high ->
    # grow to fit demand, below low -> shrink to fit, in between -> hold
    high_water: float = 1.25
    low_water: float = 0.5
    up_cooldown: float = 0.5           # s between scale-up decisions
    down_cooldown: float = 2.0         # s between scale-down decisions
    interval: float = 0.2              # control-loop tick period (s)
    down_stable_ticks: int = 3         # consecutive low-util ticks required
    kv_high_water: float = 0.92        # KV pressure that forces +1 in-band
    slots_per_pilot: int = 1           # per-pilot concurrent capacity


@dataclasses.dataclass
class ScaleDecision:
    t: float                           # clock time of the decision
    direction: str                     # "up" | "down"
    n: int                             # pilots added / drained
    live_before: int                   # fleet.size() at decision time
    target: int                        # post-decision effective target
    demand: int                        # backlog the decision sized against
    reason: str


class FleetAutoscaler:
    """Closed loop over one :class:`~repro_torch.core.cluster.Fleet`.

    ``pool`` selects the SERVING mode: demand is the request backlog of a
    :class:`~repro_torch.serving.dispatch.FleetDispatcher` and scale-ups pair new
    pilots with ``submit_servers`` so joiners lease into the live request
    pool mid-trace.  Without a pool, demand is the fleet repo's own
    queued+leased task depth (batch mode).

    ``signals_fn``/``clock`` exist for deterministic policy tests: inject
    a fake demand stream and a fake clock, drive :meth:`tick` directly.
    """

    def __init__(self, fleet, image=None, *, pool=None, pool_label=None,
                 policy: AutoscalePolicy | None = None, spec: dict | None = None,
                 signals_fn: Callable[[], dict] | None = None,
                 clock: Callable[[], float] = time.monotonic, wheel=None):
        self.fleet = fleet
        self.image = image
        self.pool = pool
        # restrict pool signals to ONE label's slice of pool_pressure()
        # ("prefill" / "decode"): two autoscalers over a disaggregated
        # fleet each size their own role's pool off its own TTFT / KV /
        # blocked-admission telemetry instead of the blended fleet view
        self.pool_label = pool_label
        self.policy = policy or AutoscalePolicy()
        self.spec = spec
        self._signals_fn = signals_fn
        self._clock = clock
        self._wheel = wheel or shared_wheel()
        self.decisions: list[ScaleDecision] = []
        self.errors: deque[str] = deque(maxlen=32)
        self.ticks = 0
        self.peak_live = 0
        self.last_signals: dict = {}
        self._last = {"up": float("-inf"), "down": float("-inf")}
        self._low_ticks = 0
        self._prev_blocked = 0
        self._prev_blocked_by_server: dict[str, int] = {}
        self._timer = None
        self._thread: threading.Thread | None = None
        self._kick = threading.Event()
        self._stop = threading.Event()

    # ---- signals -----------------------------------------------------------

    def _signals(self) -> dict:
        if self._signals_fn is not None:
            return dict(self._signals_fn())
        repo = self.fleet.sim.repo
        rs = repo.stats()
        sm = repo.scheduler_metrics()
        sig = {
            "repo_queued": rs["queued"], "repo_leased": rs["leased"],
            "repo_pilots": rs.get("pilots", 0),
            "match_p50_us": sm["match_p50_us"],
            "match_p99_us": sm["match_p99_us"],
        }
        if self.pool is not None:
            pp = self.pool.pool_pressure()
            if self.pool_label is not None:
                # overlay the label's slice: TTFT, KV pressure, blocked
                # counters, sick count and capacity stats become role-
                # split; queued/leased stay pool-wide (the queue itself
                # is not labeled — each disagg stage is its own pool)
                pp = {**pp,
                      **((pp.get("by_label") or {})
                         .get(self.pool_label) or {})}
            sig.update({f"pool_{k}": v for k, v in pp.items()})
            sig["demand"] = pp["queued"] + pp["leased"]
            sig["kv_memory_utilization"] = pp["kv_memory_utilization"]
            sig["blocked_admissions"] = pp["blocked_admissions"]
            sig["blocked_by_server"] = pp["blocked_by_server"]
        else:
            sig["demand"] = rs["queued"] + rs["leased"]
            sig.setdefault("kv_memory_utilization", 0.0)
            sig.setdefault("blocked_admissions", 0)
        return sig

    # ---- the control loop --------------------------------------------------

    def tick(self) -> ScaleDecision | None:
        """One signal->policy->actuator pass.  Returns the decision made
        (None when holding).  Thread-safe against itself only — callers
        drive it from one place (the actuator thread, or a test)."""
        p = self.policy
        now = self._clock()
        self.ticks += 1
        sig = self._signals()
        self.last_signals = sig
        live = self.fleet.size()
        # mid-drain victims still count in size(); sizing against them
        # would double-shed on back-to-back low-demand ticks; SICK servers
        # (stall-benched or quarantine-implicated, per the pool's gray-
        # failure watchdog) still hold slices but serve nothing — counting
        # them would HOLD on a demand level that needs a scale-up around
        # the sick pilot
        sick = int(sig.get("pool_sick_servers") or 0)
        effective = max(0, live - self.fleet.draining() - sick)
        self.peak_live = max(self.peak_live, live)
        cap = max(1, p.slots_per_pilot)
        # a mesh-bound (tensor-parallel) server is ONE capacity unit: its
        # slot count comes from the image's engine geometry, NOT from the
        # device count backing it.  The pool reports the live per-server
        # slot capacity (`slots_per_server`); trusting it over a stale
        # policy default keeps the demand-proportional target honest, and
        # `pool_mesh_devices` is deliberately never multiplied in — an
        # 8-device sharded server still serves `slots` requests at a time.
        srv_slots = float(sig.get("pool_slots_per_server") or 0.0)
        cap = max(cap, srv_slots)
        # speculative decoding makes capacity EFFECTIVE, not nominal: a
        # fleet whose servers commit tokens_per_step above the per-pilot
        # slot count drains the same backlog with fewer pilots.  Without
        # speculation tokens_per_step never exceeds the slot count, so the
        # max() leaves every non-speculative sizing decision unchanged.
        tps = float(sig.get("pool_tokens_per_step") or 0.0)
        cap = max(cap, tps)
        demand = int(sig.get("demand", 0))
        need = math.ceil(demand / cap) if demand > 0 else 0
        kv = float(sig.get("kv_memory_utilization") or 0.0)
        blocked_delta = self._blocked_delta(sig)

        target, reason = effective, None
        if effective == 0:
            if demand > 0:               # burst into an empty (scaled-to-
                target = need            # zero) fleet: re-provision in one
                reason = f"burst-from-zero: demand {demand}"   # jump
            self._low_ticks = 0
        else:
            util = demand / (effective * cap)
            if util > p.high_water:
                target = max(need, effective)
                reason = f"util {util:.2f} > {p.high_water} (demand {demand})"
                self._low_ticks = 0
            elif util < p.low_water:
                self._low_ticks += 1
                if self._low_ticks >= p.down_stable_ticks:
                    target = need
                    reason = (f"util {util:.2f} < {p.low_water} for "
                              f"{self._low_ticks} ticks")
            else:
                self._low_ticks = 0
                if kv > p.kv_high_water or blocked_delta > 0:
                    # queue depth looks fine but the engines are memory-
                    # bound: admissions are blocking on KV pool pressure
                    target = effective + 1
                    reason = (f"kv pressure: util {kv:.2f}, "
                              f"+{max(0, blocked_delta)} blocked")
        target = max(p.min_pilots, min(p.max_pilots, target))

        if target > effective and self._may("up", now):
            # the bound is on LIVE pilots (slices actually held), not on
            # effective: a burst while victims are mid-drain must not
            # transiently overdraw the provider's quota past max_pilots
            n = min(target - effective, p.max_pilots - live)
            if n <= 0:
                return None
            self._actuate_up(n)
            return self._record(now, "up", n, live, effective + n, demand,
                                reason or "demand")
        if target < effective and self._may("down", now):
            n = effective - target
            self.fleet.scale_down(n)
            return self._record(now, "down", n, live, target, demand,
                                reason or "idle")
        return None

    def _blocked_delta(self, sig: dict) -> int:
        """Fresh blocked admissions since the last tick.  Counters are
        cumulative PER SERVER, so the diff must be per server too: server
        churn (retire, telemetry TTL prune) shrinking or re-growing a
        fleet-wide sum must neither fabricate a scale-up trigger nor mask
        a real one.  A server first seen this tick contributes 0 (its
        history is unknown); only subsequent growth counts."""
        by_server = sig.get("blocked_by_server")
        if by_server is None:            # batch mode / injected signals:
            blocked = int(sig.get("blocked_admissions") or 0)   # plain sum
            delta = blocked - self._prev_blocked
            self._prev_blocked = blocked
            return delta
        delta = sum(max(0, int(c) - self._prev_blocked_by_server.get(s, int(c)))
                    for s, c in by_server.items())
        self._prev_blocked_by_server = {s: int(c)
                                        for s, c in by_server.items()}
        return delta

    def _may(self, direction: str, now: float) -> bool:
        """Per-direction cooldown, PLUS: a decision may not land inside its
        own cooldown of the LAST decision in either direction — that is
        what makes an up-then-down flap structurally impossible."""
        cd = (self.policy.up_cooldown if direction == "up"
              else self.policy.down_cooldown)
        return (now - self._last["up"] >= cd
                and now - self._last["down"] >= cd)

    def _record(self, now, direction, n, live, target, demand, reason):
        self._last[direction] = now
        self._low_ticks = 0
        d = ScaleDecision(now, direction, n, live, target, demand, reason)
        self.decisions.append(d)
        return d

    def _actuate_up(self, n: int):
        # prefetch FIRST: the background compile overlaps provisioning and
        # pilot boot, so the new pilots' bind joins a warm (or in-flight)
        # pull and a cold compile never lands on the request latency path
        if self.image is not None:
            try:
                self.fleet.sim.registry.prefetch(self.image, self.fleet.mesh)
            except Exception:            # noqa: BLE001 — prefetch is a hint
                pass
        started = self.fleet.scale_up(n)
        if self.pool is not None and self.image is not None:
            # pair joiners with server payloads so they lease into the live
            # request pool mid-trace (one server task per new pilot)
            self.fleet.submit_servers(self.image, self.pool.name,
                                      n=len(started), spec=self.spec)

    # ---- observability -----------------------------------------------------

    def flaps(self) -> int:
        """Consecutive opposite-direction decisions inside the newer
        decision's cooldown window.  The no-flapping acceptance gate counts
        this; the ``_may`` guard keeps it at zero by construction."""
        n = 0
        for a, b in zip(self.decisions, self.decisions[1:]):
            if a.direction != b.direction:
                cd = (self.policy.up_cooldown if b.direction == "up"
                      else self.policy.down_cooldown)
                if b.t - a.t < cd:
                    n += 1
        return n

    def stats(self) -> dict:
        ups = [d for d in self.decisions if d.direction == "up"]
        downs = [d for d in self.decisions if d.direction == "down"]
        return {
            "ticks": self.ticks,
            "decisions": len(self.decisions),
            "scale_ups": len(ups),
            "scale_downs": len(downs),
            "pilots_added": sum(d.n for d in ups),
            "pilots_drained": sum(d.n for d in downs),
            "flaps": self.flaps(),
            "peak_live": self.peak_live,
            "errors": list(self.errors),
        }

    # ---- lifecycle ---------------------------------------------------------

    def start(self):
        """Arm the periodic wheel timer and the actuator thread."""
        if self._timer is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fleet-autoscaler")
        self._thread.start()
        # the wheel callback only kicks the event: actuation (provisioning,
        # thread spawns, repo submits) never runs on the shared wheel thread
        self._timer = self._wheel.call_periodic(
            self.policy.interval, self._kick.set, name="autoscaler-tick")

    def _loop(self):
        while True:
            self._kick.wait()
            self._kick.clear()
            if self._stop.is_set():
                return
            try:
                self.tick()
            except Exception as e:       # noqa: BLE001 — a failed tick must
                # not kill the loop; the next tick re-reads fresh signals
                self.errors.append(f"{type(e).__name__}: {e}")

    def stop(self):
        """Disarm the loop.  Does NOT touch the fleet — the owner decides
        whether to drain it."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._stop.set()
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
