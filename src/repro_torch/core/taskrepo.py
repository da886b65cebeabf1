"""TaskRepo — the overlay task repository (HTCondor schedd analogue).

Pilots fetch payloads by *matchmaking*: a pilot advertises its slice
(devices, mesh shape, memory, labels) and the repo returns the
highest-priority queued task whose requirements match (ClassAd-style
predicates over the pilot ad).  Tasks are *leased*, not popped: a pilot must
heartbeat the lease or it expires and the task is re-queued — the
at-least-once delivery that makes dead pilots harmless (fault tolerance at
1000-node scale).  First completion wins: duplicate results from speculative
re-execution are dropped.

Event-driven control plane (this module is its hub):

* ``match_wait(pilot_ad, timeout)`` blocks an idle pilot on a
  ``threading.Condition`` instead of a sleep loop; ``submit``/``release``/
  lease expiry notify all waiters, so a new task wakes pilots in
  microseconds and an idle fleet burns zero CPU.
* Matchmaking is *indexed*: unconstrained tasks live in one priority heap,
  tasks with ``require_labels`` (equality constraints) are bucketed per
  label-set, and only tasks with an opaque predicate need evaluation — a
  match costs O(log n + predicates checked), not a full queue scan.
* Lease expiry is a deadline heap serviced by the shared
  :class:`~repro_torch.core.timerwheel.TimerWheel` (one repo-owned timer), not a
  side effect piggybacked on every ``match`` call.
* ``wait_drained(timeout)`` blocks on a drain event that flips whenever
  queued == leased == 0 — ``ClusterSim.run_until_drained`` no longer polls.
  A bursty submitter calls ``open_submissions()`` before its first submit
  and ``seal()`` after its last: while open, a momentary
  queued == leased == 0 window between staggered submissions does NOT flip
  the drain event (the same latch semantics as the fleet pool's ``seal``).
  A repo that never opens behaves exactly as before (sealed from birth).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable

from repro_torch.analysis.locks import (
    RANK_REPO,
    audit_callback,
    make_condition,
    make_lock,
)
from repro_torch.core.timerwheel import TimerWheel, shared_wheel

Predicate = Callable[[dict], bool]


@dataclasses.dataclass
class BackoffPolicy:
    """Exponential backoff with deterministic jitter for failure requeue.

    A payload that crashes instantly used to hot-loop through the fleet:
    release(failed=True) / lease expiry re-enqueued it with zero delay,
    so the very next match handed it straight back.  The delay doubles
    per attempt up to ``cap`` and is jittered by a hash of
    ``(task_id, attempts)`` — deterministic (replayable runs stay
    replayable) but de-correlated across tasks, so a cohort of requests
    requeued by one pilot death does not re-land as one block on the
    next victim.  ``base <= 0`` disables backoff entirely (the legacy
    immediate-requeue behavior)."""
    base: float = 0.05             # first-failure delay (seconds)
    cap: float = 2.0               # delay ceiling
    jitter: float = 0.5            # +/- fraction around the nominal delay

    def delay(self, task_id: int, attempts: int) -> float:
        if self.base <= 0:
            return 0.0
        nominal = min(self.cap, self.base * (2.0 ** max(0, attempts - 1)))
        # Knuth multiplicative hash: stable across runs, unlike hash()
        frac = ((task_id * 2654435761 + attempts * 40503) % 4096) / 4096.0
        return nominal * (1.0 - self.jitter + 2.0 * self.jitter * frac)


@dataclasses.dataclass
class PayloadTask:
    task_id: int
    image: Any                          # PayloadImage (core.images)
    requirements: Predicate | None = None
    require_labels: dict | None = None  # equality constraints, indexable
    priority: int = 0
    n_steps: int = 20
    max_wall: float = 120.0             # seconds
    input_files: dict[str, bytes] = dataclasses.field(default_factory=dict)
    env: dict = dataclasses.field(default_factory=dict)
    resume: dict = dataclasses.field(default_factory=dict)  # ckpt info
    # extra JSON-able fields merged into the startup spec the pilot
    # publishes — e.g. a serve payload's request trace / engine geometry
    payload_spec: dict = dataclasses.field(default_factory=dict)
    # hint: the image a follow-up task will need; the pilot prefetches it
    # (background compile) while THIS payload runs, so the next bind is warm
    prefetch_hint: Any = None
    attempts: int = 0
    max_attempts: int = 3
    # earliest monotonic time this task may be matched again — stamped by
    # the failure-requeue backoff; 0.0 == immediately eligible
    not_before: float = 0.0


@dataclasses.dataclass
class Lease:
    task: PayloadTask
    pilot_id: str
    expires: float


@dataclasses.dataclass
class TaskResult:
    task_id: int
    pilot_id: str
    exitcode: int
    telemetry: dict
    outputs: dict[str, bytes] = dataclasses.field(default_factory=dict)


class _TaskHeap:
    """Priority heap of queued tasks: highest priority first, FIFO within a
    priority level.  Ordered by task_id (submission order), not a per-push
    sequence — a task re-queued after a predicate rejection or a lease
    expiry keeps its place instead of starving behind newer tasks."""

    __slots__ = ("_heap",)

    def __init__(self):
        self._heap: list[tuple[int, int, PayloadTask]] = []

    def push(self, task: PayloadTask):
        heapq.heappush(self._heap, (-task.priority, task.task_id, task))

    def peek(self) -> PayloadTask | None:
        return self._heap[0][2] if self._heap else None

    def pop(self) -> PayloadTask:
        return heapq.heappop(self._heap)[2]

    def __len__(self):
        return len(self._heap)

    def __bool__(self):
        return bool(self._heap)


class TaskRepo:
    def __init__(self, *, lease_ttl: float = 10.0, wheel: TimerWheel | None = None,
                 pilot_ttl: float | None = None,
                 backoff: BackoffPolicy | None = None,
                 on_expired: Callable[[PayloadTask, str], str] | None = None):
        self._lock = make_lock("taskrepo.repo", rank=RANK_REPO)
        self._cond = make_condition(self._lock)
        self._ids = itertools.count(1)
        self._open = _TaskHeap()                      # no constraints
        self._by_labels: dict[frozenset, _TaskHeap] = {}   # equality-indexed
        self._pred = _TaskHeap()                      # opaque predicates
        self._leases: dict[int, Lease] = {}
        self._deadlines: list[tuple[float, int]] = []  # (expires, task_id)
        self._reap_timer = None
        # backoff-deferred tasks: (not_before, task_id, task) min-heap.  A
        # deferred task is QUEUED (counts toward drain / demand) but not
        # matchable until its stamp passes — a failing task waits out its
        # backoff in here without ever blocking healthy matches
        self._deferred: list[tuple[float, int, PayloadTask]] = []
        self._defer_timer = None
        self.backoff = backoff or BackoffPolicy(base=0.0)   # default: legacy
        # consulted (OUTSIDE the repo lock) when a lease expires: returns
        # "requeue" (default) or "drop" (settle failed — e.g. the fleet
        # dispatcher quarantining a poison request).  Death-event hook for
        # blast-radius accounting at a higher layer.
        self.on_expired = on_expired
        self._results: dict[int, TaskResult] = {}
        self._failed: dict[int, PayloadTask] = {}
        self._pilot_heartbeats: dict[str, float] = {}
        self._step_times: dict[str, float] = {}     # pilot_id -> EWMA
        self.lease_ttl = lease_ttl
        # a pilot whose heartbeat is older than this is presumed gone; its
        # entry is evicted instead of accumulating forever under scale churn
        self.pilot_ttl = (pilot_ttl if pilot_ttl is not None
                          else max(3.0 * lease_ttl, 3.0))
        self._wheel = wheel or shared_wheel()
        self._sealed = True          # legacy behavior: drain flips on empty
        self._drained = threading.Event()
        self._drained.set()                           # empty repo is drained
        # observability for benchmarks: match cost + scheduler wakeups
        self.match_latencies: deque[float] = deque(maxlen=8192)
        self.idle_wakeups = 0                         # woke, found no match
        self.notifies = 0

    # ---- internal: queue index ----------------------------------------------

    def _n_queued(self) -> int:
        return (len(self._open) + len(self._pred) + len(self._deferred)
                + sum(len(h) for h in self._by_labels.values()))

    def _enqueue(self, task: PayloadTask):
        """Route a task to its index bucket.  Caller holds the lock.
        A task whose backoff stamp has not passed parks in the deferred
        heap instead; the defer timer re-routes it when eligible."""
        if task.not_before > time.monotonic():
            heapq.heappush(self._deferred,
                           (task.not_before, task.task_id, task))
            self._drained.clear()
            self._arm_defer_timer(task.not_before)
            return
        if task.requirements is not None:
            self._pred.push(task)
        elif task.require_labels:
            key = frozenset(task.require_labels.items())
            self._by_labels.setdefault(key, _TaskHeap()).push(task)
        else:
            self._open.push(task)
        self._drained.clear()
        self.notifies += 1
        self._cond.notify_all()

    def _arm_defer_timer(self, when: float):
        """Caller holds the lock."""
        if self._defer_timer is None or self._defer_timer.deadline > when:
            if self._defer_timer is not None:
                self._defer_timer.cancel()
            self._defer_timer = self._wheel.call_at(
                when, self._on_defer_timer, name="taskrepo-defer")

    def _on_defer_timer(self):
        """Move every deferral whose stamp has passed back into the match
        index (waking parked pilots), then re-arm for the next one."""
        now = time.monotonic()
        with self._lock:
            self._defer_timer = None
            while self._deferred and self._deferred[0][0] <= now:
                _, _, task = heapq.heappop(self._deferred)
                task.not_before = 0.0
                self._enqueue(task)
            if self._deferred:
                self._arm_defer_timer(self._deferred[0][0])

    def _update_drained(self):
        """Caller holds the lock."""
        if self._sealed and self._n_queued() == 0 and not self._leases:
            self._drained.set()
        else:
            self._drained.clear()

    # ---- submissions-open latch ----------------------------------------------

    def open_submissions(self):
        """Declare that more submissions are coming: ``wait_drained`` must
        not return during a momentary queued == leased == 0 window between
        staggered submissions (bursty arrivals).  Pair with :meth:`seal`."""
        with self._lock:
            self._sealed = False
            self._drained.clear()

    def seal(self):
        """The submitter is done: drain completes the instant the repo is
        empty (and immediately, if it already is)."""
        with self._lock:
            self._sealed = True
            self._update_drained()

    @property
    def sealed(self) -> bool:
        with self._lock:
            return self._sealed

    # ---- submission ---------------------------------------------------------

    def submit(self, image, **kw) -> int:
        with self._lock:
            tid = next(self._ids)
            self._enqueue(PayloadTask(task_id=tid, image=image, **kw))
            return tid

    # ---- matchmaking (step (b)) ---------------------------------------------

    def _try_match(self, pilot_ad: dict) -> PayloadTask | None:
        """Best matching task across the index buckets.  Caller holds lock.

        Candidates: head of the open heap (O(1)), heads of label buckets
        satisfied by the pilot's labels (O(#distinct label-sets)), and the
        best matching predicate task (pops until a predicate passes,
        non-matching entries are pushed back — O(k log n) for k checked).
        """
        t0 = time.perf_counter()
        labels = pilot_ad.get("labels") or {}
        # lazy tombstone purge: a queued copy of a task whose RESULT has
        # already landed (a hedged duplicate settled by first-completion-
        # wins, or a stale requeue racing a completion) must never be
        # leased again — it would win every future match (lowest task_id)
        # and replay settled work forever
        while ((h := self._open.peek()) is not None
               and h.task_id in self._results):
            self._open.pop()
        for key in [k for k, hh in self._by_labels.items()
                    if hh and hh.peek().task_id in self._results]:
            hh = self._by_labels[key]
            while hh and hh.peek().task_id in self._results:
                hh.pop()
            if not hh:
                del self._by_labels[key]
        best: tuple[tuple[int, int], Callable[[], PayloadTask]] | None = None

        def consider(task: PayloadTask, take: Callable[[], PayloadTask]):
            nonlocal best
            rank = (-task.priority, task.task_id)      # FIFO within priority
            if best is None or rank < best[0]:
                best = (rank, take)

        head = self._open.peek()
        if head is not None:
            consider(head, self._open.pop)
        for key, h in self._by_labels.items():
            if h and all(labels.get(k) == v for k, v in key):
                def take_label(h=h, key=key):
                    t = h.pop()
                    if not h:             # drop drained buckets so matches
                        del self._by_labels[key]   # stay O(active label-sets)
                    return t
                consider(h.peek(), take_label)
        # predicate bucket: pop in priority order until one matches
        rejected = []
        while self._pred:
            cand = self._pred.peek()
            if best is not None and (-cand.priority, cand.task_id) >= best[0]:
                break                     # can't beat the indexed candidate
            cand = self._pred.pop()
            if cand.task_id in self._results:
                continue                  # tombstone: drop, don't push back
            try:
                # a task may carry BOTH label constraints and a predicate
                ok = (not cand.require_labels
                      or all(labels.get(k) == v
                             for k, v in cand.require_labels.items())) \
                    and cand.requirements(pilot_ad)
            except Exception:             # noqa: BLE001 — bad predicate ≠ crash
                ok = False
            if ok:
                consider(cand, lambda c=cand: c)
                break
            rejected.append(cand)
        for r in rejected:
            self._pred.push(r)

        if best is None:
            return None
        task = best[1]()
        task.attempts += 1
        self._leases[task.task_id] = Lease(
            task=task, pilot_id=pilot_ad["pilot_id"],
            expires=time.monotonic() + self.lease_ttl)
        self._push_deadline(task.task_id, self._leases[task.task_id].expires)
        self.match_latencies.append(time.perf_counter() - t0)
        return task

    def match(self, pilot_ad: dict) -> PayloadTask | None:
        """Lease the best matching task for this pilot ad, or None."""
        with self._lock:
            return self._try_match(pilot_ad)

    def match_wait(self, pilot_ad: dict, timeout: float | None = None,
                   cancel: Callable[[], bool] | None = None
                   ) -> PayloadTask | None:
        """Lease the best matching task, blocking until one appears.

        The pilot parks on the repo condition; ``submit``/``release``/lease
        expiry wake it.  Returns None on timeout or when ``cancel()`` turns
        true (drain/failure injection — the caller kicks the condition via
        :meth:`kick`).
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        woke = False
        with self._cond:
            while True:
                if cancel is not None and cancel():
                    return None
                task = self._try_match(pilot_ad)
                if task is not None:
                    return task
                if woke:                           # woke up, still nothing
                    self.idle_wakeups += 1
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cond.wait(timeout=remaining)
                woke = True

    def kick(self):
        """Wake all parked pilots so they re-check their cancel conditions."""
        with self._lock:
            self._cond.notify_all()

    def renew(self, task_id: int, pilot_id: str) -> bool:
        with self._lock:
            lease = self._leases.get(task_id)
            if lease is None or lease.pilot_id != pilot_id:
                return False
            lease.expires = time.monotonic() + self.lease_ttl
            self._push_deadline(task_id, lease.expires)
            return True

    def heartbeat_pilot(self, pilot_id: str, step_time: float | None = None):
        with self._lock:
            self._pilot_heartbeats[pilot_id] = time.monotonic()
            if step_time is not None:
                prev = self._step_times.get(pilot_id, step_time)
                self._step_times[pilot_id] = 0.7 * prev + 0.3 * step_time

    def evict_pilot(self, pilot_id: str):
        """Forget a pilot's liveness/telemetry state.  Called by a pilot on
        its own terminate path and by the lease reaper when a lease expires
        (no renewals == the pilot is gone); without eviction the heartbeat
        map grows one entry per pilot EVER seen across scale churn."""
        with self._lock:
            self._pilot_heartbeats.pop(pilot_id, None)
            self._step_times.pop(pilot_id, None)

    def _prune_stale_pilots(self, now: float):
        """Caller holds the lock.  Drops pilots silent for > pilot_ttl —
        the backstop for pilots that die without a lease to reap."""
        cutoff = now - self.pilot_ttl
        for pid in [p for p, t in self._pilot_heartbeats.items()
                    if t < cutoff]:
            del self._pilot_heartbeats[pid]
            self._step_times.pop(pid, None)

    def fleet_median_step_time(self) -> float | None:
        with self._lock:
            vals = sorted(self._step_times.values())
        if not vals:
            return None
        return vals[len(vals) // 2]

    # ---- completion (step (e)): first-wins ----------------------------------

    def complete(self, result: TaskResult) -> bool:
        """Returns True if this result was accepted (first completion wins;
        speculative duplicates are dropped).  Non-zero exits keep their lease
        — the pilot follows up with release(task, failed=True) to retry/fail,
        so the repo never looks transiently drained between the two calls."""
        with self._lock:
            if result.task_id in self._results:
                self._leases.pop(result.task_id, None)
                self._update_drained()
                return False                       # speculative duplicate
            if result.exitcode == 0:
                self._leases.pop(result.task_id, None)
                self._results[result.task_id] = result
                self._update_drained()
                return True
            return False

    def release(self, task: PayloadTask, *, failed: bool = False,
                pilot_id: str | None = None, defer_s: float | None = None):
        """Give a leased task back (pilot draining, or payload failure).

        Racing the lease reaper is safe: if the lease is already gone the
        reaper requeued the task (or a result landed) and enqueueing it
        AGAIN here would duplicate it — the release becomes a no-op.  Pass
        ``pilot_id`` to also guard against the task having been re-leased
        to someone else in the meantime (their lease must survive).

        A FAILED release backs off before re-matching (``self.backoff``):
        a crashing payload must not hot-loop through the fleet.  Graceful
        releases requeue immediately (drain latency matters), unless the
        caller paces them explicitly with ``defer_s``."""
        with self._lock:
            lease = self._leases.get(task.task_id)
            if (pilot_id is not None and lease is not None
                    and lease.pilot_id != pilot_id):
                return                     # someone else's lease now
            if task.task_id in self._results:
                self._leases.pop(task.task_id, None)
                self._update_drained()
                return
            if lease is None:              # expired: the reaper handled it
                self._update_drained()
                return
            del self._leases[task.task_id]
            self._prune_stale_pilots(time.monotonic())
            if failed and task.attempts >= task.max_attempts:
                self._failed[task.task_id] = task
                self._update_drained()
                return
            if failed:
                task.not_before = (time.monotonic()
                                   + self.backoff.delay(task.task_id,
                                                        task.attempts))
            elif defer_s is not None:
                task.not_before = time.monotonic() + defer_s
            self._enqueue(task)

    # ---- lease reaping: deadline heap + repo-owned timer ---------------------

    def _push_deadline(self, task_id: int, expires: float):
        """Caller holds the lock.  Entries are lazy — renewals push a fresh
        tuple and stale ones are discarded when popped."""
        heapq.heappush(self._deadlines, (expires, task_id))
        self._arm_reap_timer(expires)

    def _arm_reap_timer(self, expires: float):
        """Caller holds the lock."""
        if self._reap_timer is None or self._reap_timer.deadline > expires:
            if self._reap_timer is not None:
                self._reap_timer.cancel()
            self._reap_timer = self._wheel.call_at(expires, self._on_reap_timer,
                                                   name="taskrepo-lease-reaper")

    def _on_reap_timer(self):
        with self._lock:
            self._reap_timer = None
        self.reap_leases()

    def reap_leases(self) -> int:
        now = time.monotonic()
        with self._lock:
            expired: list[tuple[PayloadTask, str]] = []
            while self._deadlines and self._deadlines[0][0] <= now:
                _, tid = heapq.heappop(self._deadlines)
                lease = self._leases.get(tid)
                if lease is None or lease.expires > now:
                    continue                       # stale entry (renewed/done)
                del self._leases[tid]
                expired.append((lease.task, lease.pilot_id))
                # no renewals for a whole TTL: the holder is presumed dead —
                # evict its heartbeat so the live-pilot signal and the
                # straggler median never count a ghost
                self._pilot_heartbeats.pop(lease.pilot_id, None)
                self._step_times.pop(lease.pilot_id, None)
            self._prune_stale_pilots(now)
        # the death-event hook runs OUTSIDE the repo lock: the fleet
        # dispatcher's blast-radius accounting takes its own pool lock
        # there, and pool->repo is the established lock order everywhere
        # else (fetch/complete/release all call in holding the pool lock)
        dispositions: dict[int, str] = {}
        if self.on_expired is not None and expired:
            audit_callback("taskrepo:on_expired")
            for task, pid in expired:
                try:
                    dispositions[task.task_id] = self.on_expired(task, pid)
                except Exception:        # noqa: BLE001 — a broken hook must
                    pass                 # not disable lease recovery
        with self._lock:
            for task, pid in expired:
                if task.task_id in self._results:
                    continue
                if dispositions.get(task.task_id) == "drop":
                    # the hook settled it (e.g. poison quarantine): record
                    # as failed so drain accounting and failed_tasks() agree
                    self._failed[task.task_id] = task
                elif task.attempts >= task.max_attempts:
                    # the dispatch budget is spent: settle as failed instead
                    # of cycling lease→expire→requeue forever (a release
                    # (failed=True) that races the expiry would otherwise
                    # never reach the _failed state)
                    self._failed[task.task_id] = task
                else:
                    # an expiry IS a delivery failure: back the task off so
                    # a payload that kills its pilot can't hot-loop through
                    # the fleet at lease-TTL cadence
                    task.not_before = now + self.backoff.delay(task.task_id,
                                                               task.attempts)
                    self._enqueue(task)
            self._update_drained()
            if self._deadlines:                    # re-arm for the next lease
                self._arm_reap_timer(self._deadlines[0][0])
            return len(expired)

    # ---- introspection --------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            self._prune_stale_pilots(time.monotonic())
            return {
                "queued": self._n_queued(),
                "leased": len(self._leases),
                "done": len(self._results),
                "failed": len(self._failed),
                # fresh-heartbeat pilots: the autoscaler's supply-side signal
                "pilots": len(self._pilot_heartbeats),
            }

    def scheduler_metrics(self) -> dict:
        """Match-cost distribution + wakeup accounting for benchmarks."""
        with self._lock:
            lat = sorted(self.match_latencies)
            n = len(lat)
            return {
                "matches": n,
                "match_p50_us": 1e6 * lat[n // 2] if n else 0.0,
                "match_p99_us": 1e6 * lat[min(n - 1, (99 * n) // 100)] if n else 0.0,
                "idle_wakeups": self.idle_wakeups,
                "notifies": self.notifies,
                # timer-callback failures (a crashed lease reaper / monitor
                # tick shows up here instead of silently disabling expiry)
                "timer_errors": self._wheel.error_count,
            }

    def result(self, task_id: int) -> TaskResult | None:
        with self._lock:
            return self._results.get(task_id)

    def failed_tasks(self) -> list[int]:
        """Task ids that settled as failed (attempt budget exhausted) —
        consumers that track work at a higher level (the fleet dispatcher's
        request records) reconcile against this."""
        with self._lock:
            return list(self._failed)

    def drain_done(self) -> bool:
        return self._drained.is_set()

    def wait_drained(self, timeout: float | None = None) -> bool:
        """Block until nothing is queued or leased (event, not a poll)."""
        return self._drained.wait(timeout)
