"""Pilot-side monitor (paper §3.4 + dHTC straggler mitigation).

The monitor periodically scans the shared process table for payload-uid
entries and enforces policy at step boundaries, exactly where HTCondor
applies its SLOT_USER controls:

* wall-clock limit per payload,
* step-count limit,
* straggler detection: a payload whose step-time EWMA exceeds
  ``straggler_factor`` x the fleet median (published by the TaskRepo from all
  pilots' heartbeats) is terminated so its task can be re-queued on a
  healthier slice — tail latency control at 1000-node scale.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.core.proctable import PAYLOAD_UID, PILOT_UID, ProcessTable


@dataclasses.dataclass
class MonitorLimits:
    max_wall: float = 120.0
    max_steps: int | None = None
    straggler_factor: float = 3.0
    min_steps_for_straggler: int = 3


@dataclasses.dataclass
class MonitorAction:
    pid: int
    kind: str          # "kill-wall" | "kill-steps" | "kill-straggler"
    detail: str


class Monitor:
    def __init__(self, proctable: ProcessTable, limits: MonitorLimits,
                 fleet_median_fn=None):
        self.proctable = proctable
        self.limits = limits
        self.fleet_median_fn = fleet_median_fn or (lambda: None)
        self.actions: list[MonitorAction] = []
        self._ewma: dict[int, float] = {}

    def scan(self, now: float | None = None) -> list[MonitorAction]:
        now = now if now is not None else time.monotonic()
        acts: list[MonitorAction] = []
        lim = self.limits
        running: set[int] = set()
        for e in self.proctable.entries(uid=PAYLOAD_UID, viewer_uid=PILOT_UID):
            if e.state != "running":
                continue
            running.add(e.pid)
            wall = now - e.started
            if wall > lim.max_wall:
                acts.append(MonitorAction(e.pid, "kill-wall",
                                          f"wall {wall:.1f}s > {lim.max_wall}s"))
            elif lim.max_steps is not None and e.steps_done > lim.max_steps:
                acts.append(MonitorAction(e.pid, "kill-steps",
                                          f"steps {e.steps_done} > {lim.max_steps}"))
            elif (e.last_step_time is not None
                  and e.steps_done >= lim.min_steps_for_straggler):
                prev = self._ewma.get(e.pid, e.last_step_time)
                ewma = 0.7 * prev + 0.3 * e.last_step_time
                self._ewma[e.pid] = ewma
                med = self.fleet_median_fn()
                if med is not None and med > 0 and ewma > lim.straggler_factor * med:
                    acts.append(MonitorAction(
                        e.pid, "kill-straggler",
                        f"ewma {ewma*1e3:.1f}ms > {lim.straggler_factor}x median {med*1e3:.1f}ms"))
        for a in acts:
            self.proctable.kill(a.pid, signaller_uid=PILOT_UID)
        self.actions.extend(acts)
        # evict EWMA state for exited/killed pids — without this, a pilot
        # running thousands of payloads leaks one float per dead pid forever
        for pid in list(self._ewma):
            if pid not in running:
                del self._ewma[pid]
        return acts
