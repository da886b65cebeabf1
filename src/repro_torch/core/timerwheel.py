"""TimerWheel — one deadline-heap timer thread for the whole control plane.

The event-driven refactor removes the per-pilot sleep loops; everything that
still needs a clock (lease expiry, lease renewal, the monitor's wall/straggler
tick, telemetry heartbeats) is a *timer* on a shared wheel instead.  One
thread services a heap of deadlines: it sleeps exactly until the earliest
deadline (interruptible by new, earlier timers) and fires callbacks on the
wheel thread.  With N pilots the process holds one timer thread, not N
polling loops — control-plane CPU stays flat as the fleet grows.

Callbacks must be short and non-blocking (they share one thread); anything
heavy should set an event and let the owner's thread do the work.

A raising callback must never be *silent*: the wheel services the lease
reaper and the payload monitor, so a swallowed exception there would turn
off lease expiry — the exact failure the fleet's requeue-on-pilot-death
story depends on never happening.  Every callback error is recorded on the
wheel's error ledger (``errors`` keeps the most recent ``(timer name,
exception)`` pairs, ``error_count`` counts them all) and surfaced through
:meth:`TimerWheel.stats`; a periodic timer that raised stays scheduled.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Callable

from repro_torch.analysis.locks import (
    RANK_WHEEL,
    audit_callback,
    make_condition,
    make_lock,
)


class Timer:
    """Handle for a scheduled callback.  ``cancel()`` is lazy: the wheel
    drops cancelled entries when they surface at the top of the heap."""

    __slots__ = ("fn", "deadline", "interval", "cancelled", "name")

    def __init__(self, fn: Callable[[], None], deadline: float,
                 interval: float | None, name: str | None = None):
        self.fn = fn
        self.deadline = deadline
        self.interval = interval          # None -> one-shot
        self.cancelled = False
        self.name = name or getattr(fn, "__qualname__", repr(fn))

    def cancel(self):
        self.cancelled = True


class TimerWheel:
    def __init__(self, name: str = "timer-wheel"):
        self._cond = make_condition(name=f"timerwheel[{name}]", rank=RANK_WHEEL)
        self._heap: list[tuple[float, int, Timer]] = []
        self._seq = itertools.count()
        self._thread: threading.Thread | None = None
        self._name = name
        self.fired = 0                    # observability: callbacks run
        self.error_count = 0              # callbacks that raised (total)
        self.errors: deque[tuple[str, Exception]] = deque(maxlen=32)

    # ---- scheduling -------------------------------------------------------

    def call_later(self, delay: float, fn: Callable[[], None],
                   name: str | None = None) -> Timer:
        return self._push(Timer(fn, time.monotonic() + max(delay, 0.0), None,
                                name))

    def call_at(self, deadline: float, fn: Callable[[], None],
                name: str | None = None) -> Timer:
        return self._push(Timer(fn, deadline, None, name))

    def call_periodic(self, interval: float, fn: Callable[[], None],
                      name: str | None = None) -> Timer:
        if interval <= 0:
            raise ValueError("periodic interval must be > 0")
        return self._push(Timer(fn, time.monotonic() + interval, interval,
                                name))

    def _push(self, t: Timer) -> Timer:
        with self._cond:
            is_earliest = not self._heap or t.deadline < self._heap[0][0]
            heapq.heappush(self._heap, (t.deadline, next(self._seq), t))
            self._ensure_thread()
            if is_earliest:               # only interrupt the service thread
                self._cond.notify()       # when its wait deadline moves up
        return t

    # ---- service thread ---------------------------------------------------

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=self._name)
            self._thread.start()

    def _run(self):
        while True:
            with self._cond:
                while True:
                    if not self._heap:
                        self._cond.wait()
                        continue
                    deadline, _, timer = self._heap[0]
                    if timer.cancelled:
                        heapq.heappop(self._heap)
                        continue
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        heapq.heappop(self._heap)
                        break
                    self._cond.wait(timeout=wait)
            try:
                # Callbacks run with NO wheel lock held; the audit guard
                # proves that invariant (and catches any future regression).
                audit_callback(f"timerwheel:{timer.name}")
                timer.fn()
            except Exception as e:        # noqa: BLE001 — timers never kill the
                # wheel, but they must not die silently either: a crashing
                # lease reaper would disable lease expiry fleet-wide
                with self._cond:          # stats() snapshots under the same
                    self.errors.append((timer.name, e))    # lock
                    self.error_count += 1
            self.fired += 1
            if timer.interval is not None and not timer.cancelled:
                timer.deadline = time.monotonic() + timer.interval
                self._push(timer)

    # ---- observability ----------------------------------------------------

    def stats(self) -> dict:
        """Fired/error accounting; ``last_errors`` names the timers whose
        callbacks raised so a disabled lease reaper is visible, not silent."""
        with self._cond:                  # snapshot vs concurrent appends
            errors = list(self.errors)
            count = self.error_count
        return {
            "fired": self.fired,
            "errors": count,
            "last_errors": [(n, f"{type(e).__name__}: {e}")
                            for n, e in errors],
        }


_default_wheel: TimerWheel | None = None
_default_lock = make_lock("timerwheel.default-registry")


def shared_wheel() -> TimerWheel:
    """Process-wide wheel: TaskRepo and all Pilots share one timer thread."""
    global _default_wheel
    with _default_lock:
        if _default_wheel is None:
            _default_wheel = TimerWheel("control-plane-timer")
        return _default_wheel
