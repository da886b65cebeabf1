"""Pilot — the pilot container's control process (paper Fig. 2, steps a-h).

One Pilot owns one provisioned slice (pod).  Its lifecycle:

  (a) start(): validate the slice, write pilot config into the private
      arena area, install the placeholder payload container;
  (b) match a task from the TaskRepo (lease) — the pilot *blocks* on the
      repo condition (`match_wait`), it never spins;
  (c) late-bind: patch the payload container's image (unprivileged, pod-
      scoped capability), stage input files + env into the shared arena,
      publish the startup spec — the payload container wakes and runs;
  (d) monitor the payload: proctable step events push telemetry, the
      lease-renew heartbeat and the monitor's wall/straggler tick run on
      the shared timer wheel, and the pilot thread itself parks on the
      executor's exit event;
  (e) collect exitcode.json + output files the instant the exit event
      fires (microseconds, not the next poll tick), report the result
      (first-completion-wins);
  (f) cleanup: executor reset (container restart) + shared-volume wipe +
      orphan sweep;
  (g) loop to (b) until drain/max_payloads/no work;
  (h) terminate: destroy the arena, release the slice.

The pilot is an explicit state machine.  States and legal transitions:

    created ──> starting ──> idle ──> bound ──> running ──> collecting
                                ^                              │
                                └──────────────────────────────┘
    idle ──> terminated            (no work / max_payloads reached)
    idle ──> drained               (graceful drain requested)
    any non-terminal ──> failed    (HardFail: injected node loss)

`bound ──> idle` and `running ──> idle` cover bind/start errors where the
payload never produces an exit record.  Terminal states: ``terminated``,
``drained``, ``failed``.  A hard-fail aborts the thread without any
cleanup — the lease-expiry path then re-queues the task elsewhere, which is
the system's node-failure story.

Port of ``repro.core.pilot``: the payload executor and the prefetch hint
take the slice's ``device`` where the reference passes its ``mesh``, and
the slice's mesh when it holds one.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid

from repro_torch.core.arena import SharedArena
from repro_torch.core import chaos
from repro_torch.core.images import ExecutableRegistry
from repro_torch.core.latebind import PayloadExecutor, PodPatchCapability
from repro_torch.core.monitor import Monitor, MonitorLimits
from repro_torch.core.proctable import PAYLOAD_UID, PILOT_UID, ProcessTable
from repro_torch.core.taskrepo import TaskRepo, TaskResult
from repro_torch.core.timerwheel import shared_wheel


@dataclasses.dataclass
class PilotConfig:
    max_payloads: int = 4
    idle_grace: float = 2.0            # seconds with no matching work
    monitor_interval: float = 0.05     # wall/straggler tick (timer wheel)
    lease_renew_interval: float = 1.0
    spec_timeout: float = 30.0


class HardFail(Exception):
    """Injected node failure — the pilot vanishes without cleanup."""


class InvalidTransition(Exception):
    """A state change outside the documented transition table."""


# The documented transition table (see module docstring).
TRANSITIONS: dict[str, set[str]] = {
    "created":    {"starting", "failed"},
    "starting":   {"idle", "failed"},
    "idle":       {"bound", "terminated", "drained", "failed"},
    "bound":      {"running", "idle", "failed"},
    "running":    {"collecting", "idle", "failed"},
    "collecting": {"idle", "failed"},
    "terminated": set(),
    "drained":    set(),
    "failed":     set(),
}

TERMINAL_STATES = frozenset(s for s, nxt in TRANSITIONS.items() if not nxt)


class Pilot:
    def __init__(self, slice_, repo: TaskRepo, registry: ExecutableRegistry,
                 config: PilotConfig | None = None, arena_root: str | None = None):
        self.slice = slice_
        self.repo = repo
        self.registry = registry
        self.config = config or PilotConfig()
        self.pilot_id = f"pilot-{uuid.uuid4().hex[:8]}"
        self.pod_id = f"pod-{self.pilot_id}"
        self.arena = SharedArena(arena_root)
        self.proctable = ProcessTable()
        self.executor: PayloadExecutor | None = None
        self._cap = PodPatchCapability(pod_id=self.pod_id)
        self.fail_flag = threading.Event()          # cluster failure injection
        self.drain_flag = threading.Event()         # graceful drain
        self._wake = threading.Event()              # payload exit / fail kick
        self._wheel = shared_wheel()
        self.state = "created"
        self.state_log: list[str] = ["created"]
        self.error: str | None = None    # set on soft crash (state 'failed')
        self._last_telemetry_push = 0.0
        self.payloads_run = 0
        self.history: list[dict] = []
        self._thread: threading.Thread | None = None
        # wall-clock accounting for the autoscaler's pilot-seconds metric
        self.t_started: float | None = None
        self.t_ended: float | None = None

    # ---- state machine -------------------------------------------------

    def _transition(self, to: str):
        if to not in TRANSITIONS[self.state]:
            raise InvalidTransition(f"{self.state} -> {to}")
        self.state = to
        self.state_log.append(to)

    def _force_state(self, to: str):
        """HardFail path: any non-terminal state may jump to `failed`."""
        self.state = to
        self.state_log.append(to)

    # ------------------------------------------------------------------

    def start_async(self) -> threading.Thread:
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name=self.pilot_id)
        self._thread.start()
        return self._thread

    def join(self, timeout=None):
        if self._thread:
            self._thread.join(timeout)

    def fail(self):
        """Injected hard node loss: wake the pilot wherever it is parked."""
        self.fail_flag.set()
        self._wake.set()                 # parked on a payload exit event
        self.repo.kick()                 # parked in match_wait

    def drain(self):
        """Graceful drain: stop fetching new work, and ask the CURRENT
        payload to wind down.  Batch payloads ignore the drain event and
        finish normally; a fleet-serve payload honors it by releasing its
        leased requests back to the pool (immediate requeue, no lease-TTL
        wait) and exiting — the scale-down path."""
        self.drain_flag.set()
        self.proctable.drain_uid(PAYLOAD_UID)
        self.repo.kick()                 # wake an idle pilot immediately

    def done(self) -> bool:
        """Terminal state reached AND the pilot thread has exited — the
        condition under which Fleet/ClusterSim may reap this pilot."""
        return (self.state in TERMINAL_STATES
                and (self._thread is None or not self._thread.is_alive()))

    def pilot_seconds(self, now: float | None = None) -> float:
        """Wall-clock seconds this pilot has held (or held) its slice."""
        if self.t_started is None:
            return 0.0
        end = self.t_ended
        if end is None:
            end = now if now is not None else time.monotonic()
        return max(0.0, end - self.t_started)

    def _check_fail(self):
        if self.fail_flag.is_set():
            raise HardFail(self.pilot_id)

    def _cancelled(self) -> bool:
        return self.fail_flag.is_set() or self.drain_flag.is_set()

    # ------------------------------------------------------------------

    def run(self):
        self.t_started = time.monotonic()
        try:
            self._step_a_start()
            while self.payloads_run < self.config.max_payloads:
                self._check_fail()
                if self.drain_flag.is_set():
                    break
                task = self._step_b_fetch()
                self._check_fail()
                if task is None:
                    break                # idle_grace expired / drain / no work
                self._run_payload(task)                 # steps (c)-(f)
            self._transition("drained" if self.drain_flag.is_set()
                             else "terminated")
        except HardFail:
            self._force_state("failed")                  # no cleanup at all
            return
        except Exception as e:           # noqa: BLE001
            # soft crash (bad slice, bind machinery error): reach a terminal
            # state so Fleet/live_pilots never count a dead thread, but still
            # clean up the arena and release the slice
            self.error = f"{type(e).__name__}: {e}"
            self._force_state("failed")
            self._step_h_terminate()
        finally:
            if self.state != "failed":
                self._step_h_terminate()
            self.t_ended = time.monotonic()

    # ---- (a) ----------------------------------------------------------

    def _step_a_start(self):
        self._transition("starting")
        pe = self.proctable.register(PILOT_UID, f"pilot:{self.pilot_id}")
        self._pilot_entry = pe
        # env validation: the slice must expose at least one device
        if not getattr(self.slice, "devices", None):
            raise RuntimeError("invalid slice: no devices")
        with open(f"{self.arena.private}/pilot_config.json", "w") as f:
            f.write('{"pilot_id": "%s", "pod": "%s"}' % (self.pilot_id, self.pod_id))
        self.executor = PayloadExecutor(self.pod_id, self.arena,
                                        self.proctable, self.registry,
                                        device=getattr(self.slice, "device",
                                                       None),
                                        mesh=getattr(self.slice, "mesh",
                                                     None))
        self.proctable.subscribe(self._on_proc_event)
        self.repo.heartbeat_pilot(self.pilot_id)
        self._transition("idle")

    def _on_proc_event(self, kind: str, entry):
        """Proctable callback: step updates push telemetry to the repo for
        fleet-median straggler detection; exits wake the parked pilot.
        Telemetry pushes are rate-limited to the monitor interval so fast
        step loops don't hammer the fleet-global repo lock from the
        payload's hot path."""
        if entry.uid != PAYLOAD_UID:
            return
        if kind == "step" and entry.last_step_time is not None:
            now = time.monotonic()
            if now - self._last_telemetry_push >= self.config.monitor_interval:
                self._last_telemetry_push = now
                self.repo.heartbeat_pilot(self.pilot_id, entry.last_step_time)
        elif kind == "exit":
            self._wake.set()

    # ---- (b) ----------------------------------------------------------

    def _pilot_ad(self) -> dict:
        return {
            "pilot_id": self.pilot_id,
            "n_devices": len(self.slice.devices),
            "labels": dict(getattr(self.slice, "labels", {})),
            "payloads_run": self.payloads_run,
        }

    def _step_b_fetch(self):
        self.repo.heartbeat_pilot(self.pilot_id)
        return self.repo.match_wait(self._pilot_ad(),
                                    timeout=self.config.idle_grace,
                                    cancel=self._cancelled)

    # ---- (c)-(f) --------------------------------------------------------

    def _run_payload(self, task):
        record = {"task_id": task.task_id, "image": task.image}
        timers = []
        monitor = Monitor(
            self.proctable,
            MonitorLimits(max_wall=task.max_wall),
            fleet_median_fn=self.repo.fleet_median_step_time)
        try:
            # (c) late bind: image patch + staging + startup spec
            exe = self.executor.patch_image(self._cap, task.image)
            for name, data in task.input_files.items():
                self.arena.stage_file(name, data)
            self._transition("bound")
            self._wake.clear()
            self.executor.start(spec_timeout=self.config.spec_timeout,
                                on_exit=self._wake.set)
            # env rides in the startup spec (the paper's startup script
            # carries the env exports): one shared-volume publish, not two;
            # payload_spec carries payload-kind extras (a serve payload's
            # request trace and engine geometry)
            self.arena.publish_startup_spec({
                "n_steps": task.n_steps,
                "task_id": task.task_id,
                "env": {**task.env, "pilot": self.pilot_id},
                **task.resume,
                **task.payload_spec,
            })
            record["bind_seconds"] = self.executor.last_bind_seconds
            record["bind_cached"] = self.executor.last_bind_cached
            self._transition("running")
            # overlap the NEXT image pull with this payload's run: the hint
            # names the image a follow-up task needs, and the registry
            # compiles it on a background thread (single-flight with any
            # concurrent bind) so the next patch_image is a cache hit
            if task.prefetch_hint is not None:
                try:
                    self.registry.prefetch(task.prefetch_hint,
                                           self.executor.where)
                    record["prefetch_started"] = True
                except Exception:         # noqa: BLE001 — the hint is
                    pass                  # advisory; never fail the payload

            # (d) heartbeats on the shared timer wheel; the pilot thread
            # itself parks on the payload exit event (no sleep loop)
            def renew_tick():
                site = chaos.site(self.pilot_id)
                if site is not None and site.partitioned():
                    return               # control-plane cut: renewals and
                                         # heartbeats fail; the payload
                                         # keeps computing (gray failure)
                self.repo.renew(task.task_id, self.pilot_id)
                self.repo.heartbeat_pilot(self.pilot_id)

            done = self.executor.exit_event

            def monitor_tick():
                # wall/straggler enforcement still needs a clock tick, but it
                # is a timer-wheel callback, not a pilot-thread sleep loop
                monitor.scan()
                if done.is_set():
                    self._wake.set()     # belt-and-braces: never park forever

            timers.append(self._wheel.call_periodic(
                self.config.lease_renew_interval, renew_tick))
            timers.append(self._wheel.call_periodic(
                self.config.monitor_interval, monitor_tick))
            while not done.is_set() and not self.fail_flag.is_set():
                self._wake.wait()
                self._wake.clear()
            self._check_fail()
            self.executor.join(timeout=5.0)

            # (e) collect exit + outputs — fires the instant the exit event
            # is published, not at the next monitor tick
            self._transition("collecting")
            exit_info = self.arena.read_exit() or {"exitcode": 125,
                                                   "telemetry": {}}
            outputs = self.arena.output_files()
            result = TaskResult(
                task_id=task.task_id, pilot_id=self.pilot_id,
                exitcode=exit_info["exitcode"],
                telemetry=exit_info.get("telemetry", {}), outputs=outputs)
            accepted = self.repo.complete(result)
            if result.exitcode != 0:
                self.repo.release(task, failed=True)
            record["exitcode"] = result.exitcode
            record["accepted"] = accepted
            record["monitor_actions"] = [a.kind for a in monitor.actions]
        except HardFail:
            raise
        except Exception as e:                           # noqa: BLE001
            record["error"] = f"{type(e).__name__}: {e}"
            self.repo.release(task, failed=True)
        finally:
            # timers always die with the payload — a surviving renew timer
            # would keep a vanished pilot's lease alive forever
            for t in timers:
                t.cancel()
            if self.fail_flag.is_set():
                pass          # hard node loss: no cleanup at all (paper §4);
                              # the lease expires and the task re-queues
            else:
                # (f) cleanup: container restart + volume wipe + orphan sweep
                if self.executor is not None:
                    self.executor.reset(back_to_placeholder=False)
                self.arena.wipe_shared()
                self.payloads_run += 1
                self.history.append(record)
                if self.state != "idle":
                    self._transition("idle")

    # ---- (h) ----------------------------------------------------------

    def _step_h_terminate(self):
        # drop liveness/telemetry state at the repo: a terminated pilot must
        # not linger in the heartbeat map (or the straggler median) forever
        self.repo.evict_pilot(self.pilot_id)
        self.proctable.unsubscribe(self._on_proc_event)
        if self.executor is not None:
            self.executor.close()        # stop the container-runtime thread
        self.proctable.kill_uid(PAYLOAD_UID)
        pe = getattr(self, "_pilot_entry", None)
        if pe is not None:
            self.proctable.mark_exited(pe.pid, 0)
        self.arena.destroy()
        release = getattr(self.slice, "release", None)
        if release:
            release()
