"""ProcessTable — the shared process namespace + uid model (paper §3.4).

In the paper, the pilot sees the payload's processes because the pod shares
one process namespace, and tells them apart by a reserved payload UID; the
pilot keeps the pseudo-root UID so it can signal/kill payload processes while
the payload cannot touch the pilot's.

Here every host-side activity (pilot threads, payload step loops) registers
an entry tagged with a uid.  The pilot (uid 0) may enumerate and signal any
entry; a payload capability can only see/affect entries of its own uid —
enforced by the capability object, the analogue of the kernel refusing
signals across UIDs.  Termination is cooperative at step boundaries (the
same place HTCondor applies policy), via a stop Event the running loop
checks between steps.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from repro_torch.analysis.locks import audit_callback, make_lock

PILOT_UID = 0
PAYLOAD_UID = 1000        # the paper's well-defined, pre-determined UID


@dataclasses.dataclass
class ProcEntry:
    pid: int
    uid: int
    name: str
    started: float
    stop: threading.Event
    # graceful wind-down request (SIGTERM-with-grace analogue): a payload
    # that honors it stops taking NEW work, hands leased work back, and
    # exits cleanly — unlike `stop`, which is the hard kill
    drain: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    state: str = "running"            # running | exited | killed
    exitcode: int | None = None
    last_step_time: float | None = None
    steps_done: int = 0

    def request_stop(self):
        self.stop.set()


class ProcessTable:
    """Event-driven: observers subscribe to ``exit`` and ``step`` events
    instead of scanning the table on a timer.  Callbacks fire on the thread
    that caused the event, outside the table lock (no lock-order hazards);
    they must be short and exception-safe."""

    def __init__(self):
        self._lock = make_lock("proctable.table")
        self._next_pid = 1
        self._entries: dict[int, ProcEntry] = {}
        self._listeners: list = []        # callables (kind, entry)
        self._drained_uids: set[int] = set()   # sticky drain (see drain_uid)

    def subscribe(self, fn) -> None:
        """fn(kind, entry) with kind in {"exit", "step"}."""
        with self._lock:
            self._listeners.append(fn)

    def unsubscribe(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _notify(self, kind: str, entry: ProcEntry):
        with self._lock:
            listeners = list(self._listeners)
        audit_callback(f"proctable:{kind}")
        for fn in listeners:
            try:
                fn(kind, entry)
            except Exception:             # noqa: BLE001
                pass

    def register(self, uid: int, name: str) -> ProcEntry:
        with self._lock:
            pid = self._next_pid
            self._next_pid += 1
            e = ProcEntry(pid=pid, uid=uid, name=name, started=time.monotonic(),
                          stop=threading.Event())
            if uid in self._drained_uids:    # the uid is winding down: a
                e.drain.set()                # late-registering process starts
            self._entries[pid] = e           # pre-drained (no race window)
            return e

    def mark_exited(self, pid: int, exitcode: int):
        with self._lock:
            e = self._entries.get(pid)
            if e and e.state == "running":
                e.state = "exited"
                e.exitcode = exitcode
            else:
                e = None
        if e is not None:
            self._notify("exit", e)

    def heartbeat(self, pid: int, step_time: float):
        with self._lock:
            e = self._entries.get(pid)
            if e:
                e.last_step_time = step_time
                e.steps_done += 1
        if e is not None:
            self._notify("step", e)

    # ---- enumeration: uid-scoped, like `ps` in a shared namespace ----------

    def entries(self, *, uid: int | None = None, viewer_uid: int = PILOT_UID
                ) -> list[ProcEntry]:
        with self._lock:
            out = list(self._entries.values())
        if viewer_uid != PILOT_UID:
            out = [e for e in out if e.uid == viewer_uid]
        if uid is not None:
            out = [e for e in out if e.uid == uid]
        return out

    # ---- signalling ---------------------------------------------------------

    def kill(self, pid: int, *, signaller_uid: int = PILOT_UID) -> bool:
        """Cooperative SIGTERM.  Non-pilot uids may only signal their own."""
        with self._lock:
            e = self._entries.get(pid)
            if e is None:
                return False
            if signaller_uid != PILOT_UID and e.uid != signaller_uid:
                return False           # EPERM — the uid protection of §3.4
            e.stop.set()
            if e.state == "running":
                e.state = "killed"
            return True

    def drain_uid(self, uid: int, *, signaller_uid: int = PILOT_UID) -> int:
        """Graceful wind-down for every process of a uid (the pilot's
        scale-down path): sets each entry's ``drain`` event and remembers
        the uid, so a payload that registers AFTER the drain request (the
        pilot was draining while its container booted) still starts
        drained.  Unlike :meth:`kill_uid`, nothing is marked killed — the
        payload exits on its own, releasing leased work first."""
        if signaller_uid != PILOT_UID:
            return 0                       # EPERM — pilot-only control
        with self._lock:
            self._drained_uids.add(uid)
            entries = [e for e in self._entries.values() if e.uid == uid]
        for e in entries:
            e.drain.set()
        return len(entries)

    def kill_uid(self, uid: int, *, signaller_uid: int = PILOT_UID) -> int:
        """Kill every process of a uid (the pilot's orphan sweep, step (f))."""
        n = 0
        for e in self.entries(uid=uid):
            if self.kill(e.pid, signaller_uid=signaller_uid):
                n += 1
        return n

    def reap(self):
        with self._lock:
            dead = [p for p, e in self._entries.items() if e.state != "running"]
            for p in dead:
                del self._entries[p]
            return len(dead)
