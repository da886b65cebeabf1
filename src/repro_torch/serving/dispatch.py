"""FleetDispatcher — a fleet-wide serve request pool (requeue-on-pilot-failure).

The single-engine serve path binds one request *trace* to one engine: if
that engine's pilot dies, its in-flight requests die with it.  The fleet
dispatcher is the late-binding analog of task requeue applied to SERVING
(paper §3.4/§3.6: the slice claim outlives the payload, but resource
*ownership* churns):

* a request trace is split into per-request entries in a dedicated
  :class:`~repro_torch.core.taskrepo.TaskRepo` — same leases, same matchmaking
  index, same deadline-heap reaper that already makes dead pilots harmless
  for batch tasks;
* serving pilots LEASE requests (:meth:`fetch`) into free engine slots and
  piggyback per-request progress on lease renewal (:meth:`renew`) every
  engine tick;
* a pilot that dies simply stops renewing: the repo's lease-expiry reaper
  requeues its in-flight requests and wakes any surviving server parked in
  ``fetch`` — the survivor replays them from the prompt (greedy decode over
  slot-isolated state is deterministic, so the replayed tokens are bitwise
  the tokens the dead pilot would have produced);
* completion is EXACTLY ONCE per request id: :meth:`complete` routes
  through ``TaskRepo.complete`` (first completion wins), so a slow original
  server racing a replayed copy produces one accepted result and one
  counted duplicate — never two.

Request lease lifecycle::

    submit ──> queued ──> leased(server A) ──renew──> ... ──> completed
                  ^            │ no renew (A died)                 ^
                  └── requeued ┘ after lease_ttl (+ backoff)       │
                  └────────────── leased(server B), replay ────────┘

Gray-failure hardening (:class:`RobustnessPolicy`) — a clean crash is the
EASY failure; these paths handle the ones the lease reaper cannot see:

* **progress watchdog** — renewals carry per-request progress, so a
  request renewing on schedule but FROZEN past ``stall_deadline`` is
  revoked (requeued elsewhere) and its server benched (``sick_cooldown``);
* **hedged re-dispatch** — a leased request whose in-flight age exceeds a
  pool-percentile service budget gets a duplicate dispatch with an
  anti-affinity predicate; first completion wins (the existing exactly-
  once rule), the loser is tombstoned and its server cancels the slot;
* **poison quarantine** — per-request blast-radius accounting: a request
  implicated (held with zero progress) in ``quarantine_after`` distinct
  pilot deaths settles FAILED with a recorded reason instead of serially
  killing its way through ``max_attempts`` pilots.  Once-implicated
  requests are *canaried*: dispatched at most one per server, so the next
  death identifies the poison unambiguously instead of condemning its
  whole co-fetched cohort;
* **requeue backoff** — failure requeues stamp ``not_before``
  (exponential + deterministic jitter, ``BackoffPolicy``) so a crashing
  request cannot hot-loop through the fleet at lease-TTL cadence.

Pools register under a process-global name (the simulation's stand-in for
a network endpoint): a serve payload finds its pool with
:func:`get_pool(spec["dispatch"])` from inside the payload container.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from collections import deque

from repro_torch.analysis.locks import (
    RANK_POOL,
    audit_callback,
    make_condition,
    make_lock,
)
from repro_torch.core import spans
from repro_torch.core.taskrepo import BackoffPolicy, TaskRepo, TaskResult
from repro_torch.core.timerwheel import shared_wheel

_POOLS: dict[str, "FleetDispatcher"] = {}
_POOLS_LOCK = make_lock("dispatch.pools-registry")


def _canary_ok(ad) -> bool:
    """Canary placement predicate: a SUSPECT (death-implicated) request only
    matches a server whose current requests have ALL produced tokens —
    progress proves they are not the poison (the poison never progresses),
    so if the canary dies the suspect is implicated unambiguously.  Routed
    through the repo's requirements matchmaking so an eligible server picks
    the suspect up the moment it parks in fetch — no defer/retry ping-pong
    inflating the suspect's TTFT."""
    return bool(ad.get("canary_ok"))


def get_pool(name: str) -> "FleetDispatcher | None":
    """Resolve a pool name published in a serve payload's startup spec."""
    with _POOLS_LOCK:
        return _POOLS.get(name)


@dataclasses.dataclass
class RobustnessPolicy:
    """Gray-failure hardening knobs (the ``AutoscalePolicy`` idiom: one
    dataclass, sane defaults, no inline constants).  The zero/None values
    disable the corresponding mechanism; :meth:`conservative` is the
    do-no-harm default a bare ``FleetDispatcher()`` gets — backoff only,
    detection layers off — so non-chaos callers keep PR-4 semantics."""
    # progress watchdog: revoke a renewing-but-frozen request after this
    # many seconds without progress, and bench its server
    stall_deadline: float = 2.0          # 0 disables
    sick_cooldown: float = 2.0           # seconds a stalled server is benched
    # hedged re-dispatch: duplicate a leased request once its in-flight age
    # exceeds max(hedge_min_s, hedge_factor * pNN(recent service times))
    hedging: bool = True
    hedge_percentile: float = 95.0
    hedge_factor: float = 3.0
    hedge_min_s: float = 2.0             # budget floor / cold-start budget
    hedge_min_samples: int = 8           # completions before pNN is trusted
    max_hedges: int = 1                  # duplicate dispatches per request
    watchdog_interval: float = 0.1       # hedge-scan period (s)
    # bench a server once this many of its held requests needed hedging
    # (a SLOW server keeps making progress — the stall watchdog never
    # fires — but trapping request after request past the straggler
    # budget is the same sickness); 0 disables
    bench_after_hedges: int = 0
    # poison quarantine: distinct pilot deaths (implicated with zero
    # progress) before the request settles failed; 0 disables
    quarantine_after: int = 2
    # failure-requeue backoff (threaded into the request repo)
    backoff: BackoffPolicy = dataclasses.field(
        default_factory=lambda: BackoffPolicy(base=0.05, cap=2.0))

    @classmethod
    def conservative(cls) -> "RobustnessPolicy":
        """Backoff-only: no stall revocation, no hedging, no quarantine.
        The default for pools that did not opt into chaos hardening."""
        return cls(stall_deadline=0.0, hedging=False, quarantine_after=0)


@dataclasses.dataclass
class RequestRecord:
    """Dispatcher-side state of one request across its (re)dispatches."""
    rid: int
    task_id: int
    entry: dict                         # the JSON-able request body
    submitted_s: float                  # monotonic submit time (TTFT zero)
    tokens: list | None = None          # accepted completion (first wins)
    server: str | None = None           # the server whose result won
    first_token_s: float | None = None  # pool-level TTFT (includes requeue)
    completed_s: float | None = None
    attempts: int = 0                   # dispatches (>1 == replayed)
    progress: int = 0                   # tokens reported via renew()
    failed: bool = False                # rejected max_attempts times
    servers_tried: list = dataclasses.field(default_factory=list)
    # blast radius: distinct pilots that died while holding this request
    # with zero recorded progress (the quarantine signal)
    implicated: set = dataclasses.field(default_factory=set)
    quarantined: bool = False
    fail_reason: str | None = None
    hedges: int = 0                     # duplicate dispatches issued
    hedge_tids: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _HeldLease:
    """Per-(server, rid) lease-side state: the repo task plus the progress
    trail the stall watchdog and blast-radius blame read."""
    task: object                        # the leased PayloadTask
    t: float                            # fetch time (hedge age zero)
    progress: int = -1                  # last tokens reported by THIS server
    t_progress: float = 0.0             # when progress last advanced
    t_renew: float = 0.0                # last successful lease renewal


class FleetDispatcher:
    def __init__(self, *, name: str | None = None, lease_ttl: float = 1.0,
                 max_attempts: int = 8,
                 policy: RobustnessPolicy | None = None):
        self.name = name or f"pool-{uuid.uuid4().hex[:8]}"
        self.policy = policy or RobustnessPolicy.conservative()
        # a DEDICATED repo: request leases expire on their own (short) TTL,
        # independent of the pilot-level task leases.  The repo calls back
        # on every lease expiry (a presumed pilot death) for blast-radius
        # accounting, and applies the policy's backoff to failure requeues.
        self.repo = TaskRepo(lease_ttl=lease_ttl,
                             backoff=self.policy.backoff,
                             on_expired=self._on_lease_expired)
        self.max_attempts = max_attempts
        # RANK_POOL < RANK_REPO: fetch/complete/release may call into the
        # repo while holding the pool lock, never the reverse.  Instance-
        # named so the disagg prefill->decode chain (two pool locks in a
        # fixed order) reads as two graph nodes, not a self-edge.
        self._lock = make_lock(f"dispatch.pool[{self.name}]", rank=RANK_POOL)
        self._done_cond = make_condition(self._lock)
        self._records: dict[int, RequestRecord] = {}
        self._by_tid: dict[int, int] = {}
        # (server_id, rid) -> _HeldLease (task + progress trail)
        self._leased: dict[tuple[str, int], _HeldLease] = {}
        self._n_settled = 0               # completed + failed
        self.duplicates = 0               # completions dropped by first-wins
        self.lost_leases = 0              # renewals refused (re-leased away)
        self.hedges = 0                   # hedged duplicate dispatches
        self.stalls_revoked = 0           # watchdog revocations
        self.quarantined = 0              # requests settled by blast radius
        self.servers: set[str] = set()    # servers that announced readiness
        # server_id -> bench-until stamp: stalled/implicated servers are
        # refused fetches and excluded from capacity sizing until this
        self._sick: dict[str, float] = {}
        # server_id -> held requests that crossed the straggler budget
        # (hedge strikes); at bench_after_hedges the server is benched
        self._hedge_strikes: dict[str, int] = {}
        # pilot_id -> (death stamp, had_suspect): groups the per-lease
        # expiry callbacks of one pilot death into one blame event even
        # when the reaper splits them across batches
        self._deaths: dict[str, tuple[float, bool]] = {}
        # server_id -> (monotonic stamp, engine telemetry sample): the
        # per-tick KV-pressure heartbeat the autoscaler reads; entries
        # go stale after telemetry_ttl (a dead server stops reporting)
        self._telemetry: dict[str, tuple[float, dict]] = {}
        self.telemetry_ttl = max(5.0 * lease_ttl, 2.0)
        # server_id -> announce-time labels ({"pool": "prefill"}, ...):
        # pool_pressure groups telemetry by the "pool" label so a mixed
        # fleet's prefill TTFT never blends into decode TPOT
        self._server_labels: dict[str, dict] = {}
        # completion hook (rec, handoff) -> None, called OUTSIDE the pool
        # lock on every accepted completion — the DisaggRouter's forward
        # edge from the prefill pool into the decode pool
        self.on_complete = None
        # bounded recent-TTFT window so pool_pressure (called every
        # autoscaler tick) never sorts the pool's full request history
        self._recent_ttfts: deque[float] = deque(maxlen=2048)
        self._recent_ttfts_by_label: dict[str, deque] = {}
        # fetch->completion service times: the hedge budget's percentile base
        self._recent_service: deque[float] = deque(maxlen=512)
        self.sealed = threading.Event()   # no further submissions coming
        self.closed = threading.Event()
        self._watchdog_timer = None
        if self.policy.hedging and self.policy.watchdog_interval > 0:
            self._watchdog_timer = shared_wheel().call_periodic(
                self.policy.watchdog_interval, self._watchdog_tick,
                name=f"pool-{self.name}-hedge-watchdog")
        with _POOLS_LOCK:
            _POOLS[self.name] = self

    # ---- submission -------------------------------------------------------

    def submit(self, entry: dict) -> int:
        """Queue one request.  ``entry`` is the trace-entry format
        (``{"rid", "prompt": [ints], "max_new_tokens", ...}``); an optional
        ``require_labels`` dict rides into the repo's matchmaking index so a
        request can be pinned to servers advertising matching labels (e.g.
        one pool feeding several model fleets)."""
        rid = int(entry["rid"])
        if self.sealed.is_set():
            raise RuntimeError(f"pool {self.name} is sealed")
        # record BEFORE publishing: the repo submit wakes parked fetchers,
        # which must always find the record.  The tid->rid mapping may lag
        # by microseconds; fetch falls back to the rid the task itself
        # carries in its payload_spec.
        # a two-stage (disagg) submit carries the ORIGINAL submit stamp so
        # the decode pool's TTFT window measures end-to-end, not since the
        # router's forward
        rec = RequestRecord(rid=rid, task_id=-1, entry=dict(entry),
                            submitted_s=float(entry.get(
                                "submitted_s", time.monotonic())))
        with self._lock:
            if rid in self._records:
                raise ValueError(f"duplicate request id {rid}")
            self._records[rid] = rec
        tid = self.repo.submit(
            "serve-request",
            require_labels=entry.get("require_labels"),
            priority=int(entry.get("priority", 0)),
            max_attempts=self.max_attempts,
            payload_spec={"rid": rid})
        with self._lock:
            rec.task_id = tid
            self._by_tid[tid] = rid
        return rid

    def submit_trace(self, trace: list[dict]) -> list[int]:
        """Split a request trace into per-request pool entries.  Arrival
        staggering (``at_step``) is an engine-tick concept and is ignored
        here — fleet arrivals are wall-clock submissions."""
        return [self.submit(e) for e in trace]

    # ---- the server side (called from serve payloads) ---------------------

    def announce(self, server_id: str, labels: dict | None = None):
        """A server reports it is up and WARM (engine compiled, ready to
        lease).  ``labels`` (e.g. ``{"pool": "prefill"}``) groups this
        server's telemetry in :meth:`pool_pressure`'s ``by_label`` split.
        Drivers that want cold-start excluded from TTFT wait for the
        fleet with :meth:`wait_servers` before submitting traffic."""
        with self._done_cond:
            self.servers.add(server_id)
            if labels:
                self._server_labels[server_id] = dict(labels)
            self._done_cond.notify_all()

    def _label_of(self, server_id: str) -> str:
        return str(self._server_labels.get(server_id, {}).get(
            "pool", "default"))

    def wait_servers(self, n: int, timeout: float | None = None) -> bool:
        return self._wait_for(lambda: len(self.servers) >= n, timeout)

    def retire(self, server_id: str):
        """A server's graceful exit (scale-down drain, tick budget, pool
        finished): drop it from the announced set and forget its telemetry,
        so pool pressure never counts capacity that is gone."""
        with self._done_cond:
            self.servers.discard(server_id)
            self._telemetry.pop(server_id, None)
            self._sick.pop(server_id, None)
            self._hedge_strikes.pop(server_id, None)
            self._done_cond.notify_all()

    def report_telemetry(self, server_id: str, sample: dict):
        """Per-tick engine telemetry heartbeat (kv_memory_utilization,
        blocked_admissions, free_slots, ...) — the demand-side signal the
        autoscaler folds into its scale decisions."""
        with self._lock:
            self._telemetry[server_id] = (time.monotonic(), dict(sample))

    def fetch(self, server_id: str, *, max_n: int = 1, timeout: float = 0.0,
              labels: dict | None = None, cancel=None) -> list[dict]:
        """Lease up to ``max_n`` requests for this server.  The first match
        may block up to ``timeout`` (parked on the repo condition — a
        requeued request wakes it immediately); the rest are non-blocking.
        Returned entries carry ``rid``, ``submitted_s`` (the pool-level TTFT
        zero) and ``attempt``.

        A BENCHED server (stall watchdog) gets nothing until its cooldown
        passes — a stalled payload freeing slots by revocation must not
        immediately refill them with requests it will also black-hole."""
        now = time.monotonic()
        with self._lock:
            sick_until = self._sick.get(server_id, 0.0)
        if now < sick_until:
            if timeout > 0:
                time.sleep(min(timeout, sick_until - now))
            return []
        ad = {"pilot_id": server_id, "labels": dict(labels or {})}
        stop = (self.closed.is_set if cancel is None
                else lambda: self.closed.is_set() or cancel())
        out: list[dict] = []
        for i in range(max_n):
            with self._lock:
                # solo-canary rule: a server holding a SUSPECT (death-
                # implicated) request serves it alone — fetching anything
                # else alongside would let an undetected poison detonate
                # on the canary and condemn the innocent suspect with it
                canarying = any(
                    r in self._records and self._records[r].implicated
                    for (s, r) in self._leased if s == server_id)
                # advertised to the _canary_ok placement predicate;
                # recomputed every iteration — the previous match added a
                # zero-progress lease to this server
                ad["canary_ok"] = all(
                    h.progress > 0 for (s, r), h in self._leased.items()
                    if s == server_id)
            if canarying:
                break
            if i == 0 and timeout > 0:
                task = self.repo.match_wait(ad, timeout=timeout, cancel=stop)
            else:
                task = self.repo.match(ad)
            if task is None:
                break
            with self._lock:
                # the submitter records the task before publishing but may
                # not have written the tid mapping yet — the task's own
                # payload_spec always carries the rid
                rid = self._by_tid.get(task.task_id)
                if rid is None:
                    rid = int(task.payload_spec["rid"])
                    self._by_tid[task.task_id] = rid
                rec = self._records[rid]
                if rec.task_id == -1:
                    rec.task_id = task.task_id
                if rec.tokens is not None or rec.failed:
                    # stale queued copy of an already-settled request (its
                    # lease expired in the same window the original server
                    # finished, or it settled as failed).  failed=rec.failed
                    # routes the failed case into the repo's _failed state
                    # instead of re-enqueueing a zombie that would win every
                    # future match (lowest task_id) and starve the queue.
                    self.repo.release(task, failed=rec.failed,
                                      pilot_id=server_id)
                    continue
                if (server_id, rid) in self._leased:
                    # this server already holds another dispatch of the
                    # same rid (its hedge, or a requeued primary looping
                    # back) — one engine slot per rid per server.  Defer
                    # the copy briefly so another server picks it up.
                    self.repo.release(task, pilot_id=server_id,
                                      defer_s=2 * self.policy.backoff.base
                                      or 0.05)
                    continue
                if (rec.implicated and self.policy.quarantine_after > 0
                        and any(h.progress <= 0
                                for (s, r), h in self._leased.items()
                                if s == server_id)):
                    # canary entry guard (the race the _canary_ok predicate
                    # cannot see: implication landed after the task was
                    # enqueued without requirements): a suspect must not
                    # share a server with a zero-progress request — an
                    # undetected poison among them would detonate on the
                    # canary and condemn the innocent suspect with it
                    self.repo.release(task, pilot_id=server_id,
                                      defer_s=2 * self.policy.backoff.base
                                      or 0.05)
                    continue
                # the previous holder of THIS task is dead or lost the
                # lease — its stale record must not keep counting it as a
                # holder.  Same-tid only: a hedge sibling holds the same
                # rid under a DIFFERENT task id and is a live racer, not a
                # stale holder
                for k in [k for k in self._leased
                          if k[1] == rid and k[0] != server_id
                          and self._leased[k].task.task_id == task.task_id]:
                    del self._leased[k]
                t_now = time.monotonic()
                self._leased[(server_id, rid)] = _HeldLease(
                    task=task, t=t_now, progress=-1, t_progress=t_now,
                    t_renew=t_now)
                rec.attempts = max(rec.attempts, task.attempts)
                rec.servers_tried.append(server_id)
                e = dict(rec.entry)
                e["rid"] = rid
                e["submitted_s"] = rec.submitted_s
                e["attempt"] = task.attempts
            if spans.enabled:     # the lease: the first part of its TTFT
                spans.record(spans.POOL_WAIT, round(rec.submitted_s * 1e9),
                             round(t_now * 1e9), rid=rid,
                             attr=task.attempts, tag=spans.intern(server_id))
            out.append(e)
        return out

    def renew(self, server_id: str, progress: dict[int, int]) -> list[int]:
        """Renew this server's request leases, piggybacking per-request
        progress (tokens produced so far) on the heartbeat.  Returns the
        rids whose lease this server NO LONGER holds (expired and re-leased,
        requeued, or REVOKED by the stall watchdog) — the caller should
        ``ServeEngine.cancel`` them instead of burning slots on tokens that
        can never win.

        The stall watchdog lives here because stalls are exactly the
        failure renewals cannot expose: a stuck payload keeps renewing on
        schedule, so only the piggybacked progress can show it is dead
        weight.  Frozen past ``stall_deadline`` -> the request is revoked
        (requeued elsewhere) and the server benched for ``sick_cooldown``."""
        lost: list[int] = []
        pol = self.policy
        for rid, n_tokens in progress.items():
            now = time.monotonic()
            revoked = None
            with self._lock:
                held = self._leased.get((server_id, rid))
                rec = self._records.get(rid)
                if held is not None and rec is not None:
                    if int(n_tokens) > held.progress:
                        held.progress = int(n_tokens)
                        held.t_progress = now
                        rec.progress = max(rec.progress, int(n_tokens))
                        if int(n_tokens) > 0 and rec.implicated:
                            # exoneration: a suspect that produces TOKENS is
                            # not the poison (poison never progresses) —
                            # drop its strikes and its idle-only canary
                            # routing so it stops paying the suspect tax
                            rec.implicated.clear()
                            held.task.requirements = None
                    elif (pol.stall_deadline > 0
                          and now - held.t_progress > pol.stall_deadline
                          and rec.tokens is None and not rec.failed):
                        del self._leased[(server_id, rid)]
                        self.stalls_revoked += 1
                        self._sick[server_id] = now + pol.sick_cooldown
                        revoked = held.task
            if held is None or rec is None:
                # the lease record was already swept (the rid re-leased to
                # another server, or the pool never knew it) — still a loss
                # from this server's point of view
                if rec is not None and rec.tokens is None:
                    self.lost_leases += 1
                lost.append(rid)
                continue
            if revoked is not None:
                # immediate requeue (no backoff: the REQUEST is healthy,
                # its server is not) — survivors pick it up right away
                self.repo.release(revoked, pilot_id=server_id)
                lost.append(rid)
                continue
            if self.repo.renew(held.task.task_id, server_id):
                held.t_renew = now
            else:
                lost.append(rid)
                self.lost_leases += 1
                with self._lock:
                    self._leased.pop((server_id, rid), None)
        return lost

    def complete(self, server_id: str, rid: int, tokens: list,
                 *, first_token_s: float | None = None,
                 handoff=None) -> bool:
        """Report a finished request.  First completion wins — routed
        through ``TaskRepo.complete``'s result dedup, so a replayed or
        HEDGED copy racing the original produces exactly one accepted
        result.  On a win, every other outstanding dispatch of the rid is
        tombstoned in the repo: leased losers fail their next renew (the
        server cancels the slot), queued copies are lazily purged by the
        match index.

        ``handoff`` (a :class:`~repro_torch.serving.blockpool.KVHandoff`) rides
        a PREFILL-role completion; it is passed to ``on_complete`` — the
        DisaggRouter's forward edge — only for the accepted winner, so
        the decode stage is submitted exactly once per rid no matter how
        many prefill replays raced."""
        with self._lock:
            rec = self._records.get(rid)
            held = self._leased.get((server_id, rid))
        if rec is None:
            return False
        # complete the task THIS server actually holds: under hedging the
        # rid maps to several tids and rec.task_id is only the primary
        tid = held.task.task_id if held is not None else rec.task_id
        accepted = self.repo.complete(TaskResult(
            task_id=tid, pilot_id=server_id, exitcode=0,
            telemetry={"rid": rid, "n_tokens": len(tokens)}))
        loser_tids: list[int] = []
        fire_hook = False
        with self._done_cond:
            self._leased.pop((server_id, rid), None)
            # a request settles EXACTLY once: a late result for a request
            # that already settled as failed (reject path) must not bump
            # _n_settled a second time — that would let wait_all/finished
            # fire with other work still in flight
            if accepted and not rec.failed and rec.tokens is None:
                rec.tokens = list(tokens)
                rec.server = server_id
                rec.first_token_s = first_token_s
                if first_token_s is not None:
                    self._recent_ttfts.append(first_token_s)
                    lab = self._label_of(server_id)
                    self._recent_ttfts_by_label.setdefault(
                        lab, deque(maxlen=2048)).append(first_token_s)
                now = time.monotonic()
                rec.completed_s = now - rec.submitted_s
                if held is not None:
                    self._recent_service.append(now - held.t)
                for k in [k for k in self._leased if k[1] == rid]:
                    lt = self._leased.pop(k).task.task_id
                    if lt != tid:
                        loser_tids.append(lt)
                for lt in {rec.task_id, *rec.hedge_tids} - {tid, -1}:
                    if lt not in loser_tids:
                        loser_tids.append(lt)
                fire_hook = self.on_complete is not None
                if not fire_hook:
                    self._n_settled += 1
                    self._done_cond.notify_all()
            else:
                self.duplicates += 1
                accepted = False
        if fire_hook:
            # the forward hook runs OUTSIDE the pool lock: it submits into
            # ANOTHER pool (its lock + repo lock), and holding this pool's
            # lock across that call is both a lock-order hazard and a
            # deadlock if the downstream ever calls back.  The settled
            # bump is deferred until the forward lands (even on a raising
            # hook), so a driver blocked in wait_all never observes the
            # pool drained while a forward is still in flight — rec.tokens
            # is already set, so racing duplicates/reject/expiry all see
            # the request as settled and cannot double-bump.
            audit_callback("dispatch.on_complete")
            try:
                self.on_complete(rec, handoff)
            finally:
                with self._done_cond:
                    self._n_settled += 1
                    self._done_cond.notify_all()
        for lt in loser_tids:
            self.repo.complete(TaskResult(
                task_id=lt, pilot_id=server_id, exitcode=0,
                telemetry={"rid": rid, "superseded_by": tid}))
        return accepted

    def release(self, server_id: str, rids: list[int]):
        """Hand leased-but-unfinished requests straight back (graceful
        payload end / drain): they requeue immediately instead of waiting
        out the lease TTL."""
        for rid in rids:
            with self._lock:
                held = self._leased.pop((server_id, rid), None)
            if held is not None:
                # pilot_id guard: if the lease already expired and moved,
                # the new holder's lease survives and nothing is duplicated
                self.repo.release(held.task, pilot_id=server_id)

    def reject(self, server_id: str, rid: int):
        """This server can never run the request (e.g. the prompt exceeds
        its engine's max_len).  The request retries elsewhere until the
        pool's ``max_attempts``, then settles as failed — it must not
        ping-pong forever between release and fetch."""
        with self._lock:
            held = self._leased.pop((server_id, rid), None)
            rec = self._records.get(rid)
        if held is None or rec is None:
            return
        self.repo.release(held.task, failed=True, pilot_id=server_id)
        if held.task.attempts >= self.max_attempts:
            with self._done_cond:
                if not rec.failed and rec.tokens is None:
                    rec.failed = True
                    rec.fail_reason = "rejected by every server"
                    self._n_settled += 1
                    self._done_cond.notify_all()

    # ---- gray-failure hardening -------------------------------------------

    def _on_lease_expired(self, task, pilot_id: str) -> str:
        """Death-event hook, called by the repo's lease reaper (outside the
        repo lock) once per expired lease.  Does the blast-radius blame
        accounting and decides the task's disposition: ``"requeue"``
        (normal recovery, with backoff) or ``"drop"`` (settle failed —
        quarantine, or the record is already settled).

        Blame rule: a pilot death strikes the requests it held with ZERO
        recorded progress — a request that renewed with tokens was being
        served fine and is collateral, not cause.  If any already-SUSPECT
        request was among the held set (canary isolation guarantees at
        most one per server), only suspects are struck: the canary
        confirmed its guilt and exonerates the rest of the batch."""
        spec = getattr(task, "payload_spec", None) or {}
        rid = spec.get("rid")
        if rid is None:
            return "requeue"
        rid = int(rid)
        pol = self.policy
        now = time.monotonic()
        quarantine_losers: list[int] = []
        with self._done_cond:
            rec = self._records.get(rid)
            held = self._leased.pop((pilot_id, rid), None)
            if rec is None:
                return "requeue"
            if rec.tokens is not None or rec.failed:
                return "drop"              # already settled: nothing to redo
            if pol.quarantine_after > 0:
                ev = self._deaths.get(pilot_id)
                if ev is None or now - ev[0] > 2.0 * self.repo.lease_ttl:
                    had_suspect = bool(rec.implicated) or any(
                        r in self._records and self._records[r].implicated
                        for (s, r) in self._leased if s == pilot_id)
                    ev = (now, had_suspect)
                    self._deaths[pilot_id] = ev
                had_suspect = ev[1]
                zero_progress = held is None or held.progress <= 0
                # zero progress is NECESSARY for a strike (a request that
                # renewed with tokens was being served fine — collateral,
                # not cause); when a suspect was among the held set, it is
                # also SUFFICIENT only for the suspect (canary confirmed)
                strike = zero_progress and (bool(rec.implicated)
                                            if had_suspect else True)
                if strike:
                    rec.implicated.add(pilot_id)
                    # now a suspect: its requeued task only matches a server
                    # with all-progressed requests (canary placement,
                    # cleared on exoneration)
                    task.requirements = _canary_ok
                    if len(rec.implicated) >= pol.quarantine_after:
                        rec.failed = True
                        rec.quarantined = True
                        rec.fail_reason = (
                            f"quarantined: {len(rec.implicated)} pilots "
                            f"({sorted(rec.implicated)}) died holding it")
                        self.quarantined += 1
                        self._n_settled += 1
                        # revoke every other outstanding dispatch (a hedge
                        # still decoding elsewhere must stop winning slots
                        # for a condemned request)
                        for k in [k for k in self._leased if k[1] == rid]:
                            quarantine_losers.append(
                                self._leased.pop(k).task.task_id)
                        for lt in ({rec.task_id, *rec.hedge_tids}
                                   - {task.task_id, -1}):
                            if lt not in quarantine_losers:
                                quarantine_losers.append(lt)
                        self._done_cond.notify_all()
        if quarantine_losers:
            for lt in quarantine_losers:
                self.repo.complete(TaskResult(
                    task_id=lt, pilot_id=pilot_id, exitcode=0,
                    telemetry={"rid": rid, "quarantined": True}))
            return "drop"
        if rec.quarantined:
            return "drop"
        return "requeue"

    def _watchdog_tick(self):
        """Hedge scan (timer-wheel periodic): find leased, unsettled,
        un-hedged requests whose in-flight age exceeds the pool's service
        budget and dispatch a duplicate with an anti-affinity predicate.
        The budget is a percentile of recent fetch->completion service
        times (times ``hedge_factor``), floored at ``hedge_min_s`` until
        enough samples exist — a cold pool must not hedge its first wave."""
        pol = self.policy
        if not pol.hedging or self.closed.is_set():
            return
        now = time.monotonic()
        to_hedge: list[tuple[int, RequestRecord, list[str]]] = []
        with self._lock:
            if len(self._recent_service) >= pol.hedge_min_samples:
                s = sorted(self._recent_service)
                p = s[min(len(s) - 1,
                          int(pol.hedge_percentile / 100.0 * len(s)))]
                budget = max(pol.hedge_min_s, pol.hedge_factor * p)
            else:
                budget = pol.hedge_min_s
            fresh = 0.5 * self.repo.lease_ttl   # holder-liveness horizon
            by_rid: dict[int, tuple[float, list[str], bool]] = {}
            for (server, rid), held in self._leased.items():
                t0, holders, alive = by_rid.get(rid, (held.t, [], False))
                alive = alive or (now - max(held.t_renew, held.t) <= fresh)
                by_rid[rid] = (min(t0, held.t), holders + [server], alive)
            for rid, (t0, holders, alive) in by_rid.items():
                rec = self._records.get(rid)
                if (rec is None or rec.tokens is not None or rec.failed
                        or rec.implicated     # suspects are canaried solo
                        or rec.hedges >= pol.max_hedges
                        or now - t0 <= budget
                        # hedging is for LIVE stragglers: a holder that
                        # stopped renewing is dead/partitioned — leave it
                        # to the lease reaper so blame accounting lands
                        # instead of racing a duplicate into a fresh pilot
                        or not alive):
                    continue
                rec.hedges += 1
                self.hedges += 1
                to_hedge.append((rid, rec, sorted(set(holders))))
                if pol.bench_after_hedges > 0:
                    for server in set(holders):
                        n = self._hedge_strikes.get(server, 0) + 1
                        self._hedge_strikes[server] = n
                        if n >= pol.bench_after_hedges:
                            # a server that keeps trapping requests past
                            # the straggler budget is SLOW-sick: bench it
                            # (no new fetches, excluded from capacity)
                            # even though its progress renewals look fine
                            self._sick[server] = now + pol.sick_cooldown
                            self._hedge_strikes[server] = 0
        for rid, rec, holders in to_hedge:
            excl = frozenset(holders)
            tid = self.repo.submit(
                "serve-request",
                # anti-affinity: the duplicate must land on a DIFFERENT
                # server — racing the straggler against itself is pointless
                requirements=lambda ad, _x=excl: ad["pilot_id"] not in _x,
                priority=int(rec.entry.get("priority", 0)),
                max_attempts=self.max_attempts,
                payload_spec={"rid": rid, "hedge": True})
            with self._lock:
                rec.hedge_tids.append(tid)
                self._by_tid[tid] = rid

    # ---- driver side ------------------------------------------------------

    def seal(self):
        """Declare that no further requests will be submitted.  Servers
        keep serving a momentarily-drained pool (elastic traffic!) until it
        is sealed AND everything has settled — only then does
        :meth:`finished` let them exit."""
        self.sealed.set()
        with self._done_cond:
            self._done_cond.notify_all()

    def finished(self) -> bool:
        """True once the pool is sealed and every submitted request has
        settled (completed or failed).  An unsealed pool is never finished
        — more traffic may arrive, servers park in fetch."""
        if not self.sealed.is_set():
            return False
        self._absorb_repo_failures()
        with self._lock:
            return self._n_settled == len(self._records)

    def wait_all(self, timeout: float | None = None) -> bool:
        """Block until every submitted request settles."""
        return self._wait_for(
            lambda: bool(self._records)
            and self._n_settled == len(self._records), timeout)

    def wait_completed(self, n: int, timeout: float | None = None) -> bool:
        """Block until at least ``n`` requests have settled — the hook a
        failure-injection driver uses to kill a pilot MID-trace."""
        return self._wait_for(lambda: self._n_settled >= n, timeout)

    def _wait_for(self, pred, timeout: float | None) -> bool:
        """Condition-wait for ``pred`` (evaluated under the pool lock).
        The wait is bounded to short slices so repo-level settlements that
        bypass the pool's notifications (the reaper failing a request whose
        attempt budget died with a lease) are absorbed promptly."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self._absorb_repo_failures()
            with self._done_cond:
                if pred():
                    return True
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._done_cond.wait(
                    timeout=0.25 if remaining is None
                    else min(0.25, remaining))

    def _absorb_repo_failures(self):
        """Settle records whose repo task failed without any server
        reporting it (attempt budget exhausted at lease expiry): without
        this, finished()/wait_all would hang on requests nobody owns."""
        for tid in self.repo.failed_tasks():
            with self._done_cond:
                rid = self._by_tid.get(tid)
                rec = self._records.get(rid) if rid is not None else None
                if (rec is not None and not rec.failed
                        and rec.tokens is None):
                    rec.failed = True
                    if rec.fail_reason is None:
                        rec.fail_reason = "attempt budget exhausted"
                    self._n_settled += 1
                    self._done_cond.notify_all()

    def pool_pressure(self) -> dict:
        """One-shot demand/supply snapshot for the autoscaler control loop:
        repo backlog (queued requests waiting for a server + leased
        in-flight), unsettled total, announced servers, pool-level TTFT
        percentiles over a bounded recent window (this runs every control
        tick — it must not sort the pool's full history), and the worst KV
        pressure / per-server blocked-admission counters across fresh
        server telemetry (stale entries — a dead server's last sample —
        are pruned here).  ``blocked_by_server`` carries the cumulative
        per-server counters so the autoscaler can diff per server: server
        churn (retire, TTL prune) must never fabricate or mask a delta in
        a fleet-wide sum.

        SICK servers (stall-benched) are counted in ``sick_servers`` and
        excluded from the capacity-side aggregates (``tokens_per_step``,
        ``acceptance_rate``, ``kv_memory_utilization``): a stalled pilot's
        last healthy-looking heartbeat must not keep propping up effective
        capacity — the autoscaler should scale UP around it."""
        now = time.monotonic()
        rs = self.repo.stats()
        with self._lock:
            pending = len(self._records) - self._n_settled
            for sid in [s for s, (t, _) in self._telemetry.items()
                        if now - t > self.telemetry_ttl]:
                del self._telemetry[sid]
            for sid in [s for s, u in self._sick.items() if now >= u]:
                del self._sick[sid]
            sick = set(self._sick)
            tele = {s: d for s, (_, d) in self._telemetry.items()}
            n_servers = len(self.servers)
            all_servers = set(self.servers)
            server_labels = dict(self._server_labels)
            ttfts = sorted(self._recent_ttfts)
            ttfts_by_label = {lab: sorted(d) for lab, d
                              in self._recent_ttfts_by_label.items()}
        n = len(ttfts)
        blocked = {s: int(d.get("blocked_admissions", 0))
                   for s, d in tele.items()}
        healthy = {s: d for s, d in tele.items() if s not in sick}
        # speculative-decoding effectiveness, averaged over the servers
        # that report it: tokens_per_step is the fleet's EFFECTIVE per-
        # pilot throughput (> slot count when draft acceptance is high),
        # which the autoscaler uses in place of nominal slot capacity
        acc = [float(d["acceptance_rate"]) for d in healthy.values()
               if "acceptance_rate" in d]
        tps = [float(d["tokens_per_step"]) for d in healthy.values()
               if "tokens_per_step" in d]
        # per-SERVER slot capacity: a mesh-bound (tensor-parallel) server
        # is ONE unit of `slots` capacity however many devices back it —
        # mesh_devices is reported for observability only and must never
        # multiply into the autoscaler's demand-proportional target
        srv_slots = [float(d["slots"]) for d in healthy.values()
                     if "slots" in d]

        # per-label split: a mixed prefill/decode fleet must not blend
        # prefill TTFT with decode TPOT (or one role's KV pressure with
        # the other's) — the autoscaler for each role reads its own slice
        def lab_of(s):
            return str(server_labels.get(s, {}).get("pool", "default"))

        by_label: dict[str, dict] = {}
        for lab in sorted({lab_of(s) for s in all_servers}
                          | set(ttfts_by_label)):
            srv = [s for s in all_servers if lab_of(s) == lab]
            h = {s: d for s, d in healthy.items() if lab_of(s) == lab}
            lt = ttfts_by_label.get(lab, [])
            m = len(lt)
            acc_l = [float(d["acceptance_rate"]) for d in h.values()
                     if "acceptance_rate" in d]
            tps_l = [float(d["tokens_per_step"]) for d in h.values()
                     if "tokens_per_step" in d]
            sl_l = [float(d["slots"]) for d in h.values() if "slots" in d]
            by_label[lab] = {
                "servers": len(srv),
                "sick_servers": sum(1 for s in srv if s in sick),
                "ttft_p50_s": lt[m // 2] if m else None,
                "ttft_p99_s": lt[min(m - 1, (99 * m) // 100)] if m else None,
                "kv_memory_utilization": max(
                    (d.get("kv_memory_utilization", 0.0)
                     for d in h.values()), default=0.0),
                "blocked_admissions": sum(
                    int(d.get("blocked_admissions", 0))
                    for s, d in tele.items() if lab_of(s) == lab),
                # per-server counters restricted to this label so a role's
                # autoscaler can diff per server without seeing the other
                # role's churn
                "blocked_by_server": {
                    s: int(d.get("blocked_admissions", 0))
                    for s, d in tele.items() if lab_of(s) == lab},
                "acceptance_rate": (sum(acc_l) / len(acc_l)
                                    if acc_l else 0.0),
                "tokens_per_step": sum(tps_l) / len(tps_l) if tps_l else 0.0,
                "slots_per_server": sum(sl_l) / len(sl_l) if sl_l else 0.0,
                "prefills_exported": sum(
                    int(d.get("prefills_exported", 0)) for d in h.values()),
                "handoffs_imported": sum(
                    int(d.get("handoffs_imported", 0)) for d in h.values()),
            }
        return {
            "by_label": by_label,
            "queued": rs["queued"],
            "leased": rs["leased"],
            "pending": pending,
            "servers": n_servers,
            "sick_servers": len(sick),
            "sealed": self.sealed.is_set(),
            "ttft_p50_s": ttfts[n // 2] if n else None,
            "ttft_p99_s": ttfts[min(n - 1, (99 * n) // 100)] if n else None,
            "kv_memory_utilization": max(
                (d.get("kv_memory_utilization", 0.0)
                 for d in healthy.values()), default=0.0),
            "blocked_admissions": sum(blocked.values()),
            "blocked_by_server": blocked,
            "acceptance_rate": sum(acc) / len(acc) if acc else 0.0,
            "tokens_per_step": sum(tps) / len(tps) if tps else 0.0,
            "slots_per_server": (sum(srv_slots) / len(srv_slots)
                                 if srv_slots else 0.0),
            "mesh_devices": max(
                (int(d.get("mesh_devices", 1)) for d in healthy.values()),
                default=1),
        }

    def lease_holders(self) -> dict[str, list[int]]:
        """server_id -> rids it currently holds leases for (the failure
        driver picks its victim here)."""
        out: dict[str, list[int]] = {}
        with self._lock:
            for (server, rid) in self._leased:
                out.setdefault(server, []).append(rid)
        return out

    def results(self) -> dict[int, list]:
        """rid -> accepted token list, completed requests only."""
        with self._lock:
            return {rid: list(rec.tokens)
                    for rid, rec in self._records.items()
                    if rec.tokens is not None}

    def records(self) -> dict[int, RequestRecord]:
        with self._lock:
            return dict(self._records)

    def stats(self) -> dict:
        with self._lock:
            recs = list(self._records.values())
            completed = [r for r in recs if r.tokens is not None]
            return {
                "requests": len(recs),
                "completed": len(completed),
                "failed": sum(1 for r in recs if r.failed),
                "duplicates": self.duplicates,
                "lost_leases": self.lost_leases,
                # replays: extra dispatches beyond the first — the price of
                # the failures, not of the steady state
                "replays": sum(max(0, r.attempts - 1) for r in recs),
                "distinct_servers": len({r.server for r in completed}),
                "hedges": self.hedges,
                "stalls_revoked": self.stalls_revoked,
                "quarantined": self.quarantined,
            }

    def close(self):
        """Unregister the pool and release any server parked in fetch."""
        self.closed.set()
        if self._watchdog_timer is not None:
            self._watchdog_timer.cancel()
            self._watchdog_timer = None
        with _POOLS_LOCK:
            _POOLS.pop(self.name, None)
        self.repo.kick()


class DisaggRouter:
    """Two-stage request router for disaggregated prefill/decode fleets.

    One request flows through TWO pools, each an ordinary
    :class:`FleetDispatcher` with its own leases, reaper, robustness
    policy and telemetry:

    1. ``submit`` queues the prompt into the **prefill** pool.  A
       prefill-role server leases it, runs admission, and completes with
       the one admission token plus a
       :class:`~repro_torch.serving.blockpool.KVHandoff`.
    2. The prefill pool's accepted completion fires ``on_complete``
       (exactly once per rid, however many replays raced), and the
       router resubmits into the **decode** pool — the entry carries the
       handoff object by reference (pool entries never serialize — the
       in-memory arena idiom) and the ORIGINAL ``submitted_s``, so
       decode-pool TTFT remains end-to-end.
    3. A decode-role server leases it, scatters the handoff into its own
       pool, and streams the remaining tokens.

    Failure semantics fall out of the per-stage lease machinery:

    * a dead PREFILL pilot stops renewing -> the prefill repo requeues
      the PROMPT; the survivor replays admission (deterministic) and its
      accepted completion forwards the handoff once;
    * a dead DECODE pilot stops renewing -> the decode repo requeues the
      ENTRY — which still carries the handoff — so the survivor replays
      from the HANDOFF, never re-prefilling the prompt.

    ``results()`` returns the full streams (decode-stage results, plus
    any prefill-only completion that never forwarded — e.g. quarantined
    before the decode stage existed)."""

    def __init__(self, *, name: str | None = None, lease_ttl: float = 1.0,
                 max_attempts: int = 8,
                 policy: RobustnessPolicy | None = None):
        base = name or f"disagg-{uuid.uuid4().hex[:8]}"
        self.name = base
        self.prefill = FleetDispatcher(
            name=f"{base}-prefill", lease_ttl=lease_ttl,
            max_attempts=max_attempts, policy=policy)
        self.decode = FleetDispatcher(
            name=f"{base}-decode", lease_ttl=lease_ttl,
            max_attempts=max_attempts, policy=policy)
        self.prefill.on_complete = self._forward
        self._fwd_lock = make_lock("dispatch.router-fwd")
        self._forwarded: set[int] = set()

    # ---- stage 1 -> stage 2 ------------------------------------------------

    def _forward(self, rec: RequestRecord, handoff):
        """Forward an accepted prefill completion into the decode pool.
        Runs outside the prefill pool's lock (its ``on_complete``
        contract); `complete` already guarantees one accepted winner per
        rid, and the `_forwarded` set makes the forward idempotent even
        against a buggy double-callback."""
        if handoff is None:
            return                      # settled without a handoff: final
        with self._fwd_lock:
            if rec.rid in self._forwarded:
                return
            self._forwarded.add(rec.rid)
        entry = dict(rec.entry)
        entry.update(
            rid=rec.rid,
            handoff=handoff,
            submitted_s=rec.submitted_s,       # end-to-end TTFT zero
            prefill_first_token_s=rec.first_token_s,
            prefill_server=rec.server)
        self.decode.submit(entry)

    # ---- driver side -------------------------------------------------------

    def submit(self, entry: dict) -> int:
        return self.prefill.submit(entry)

    def submit_trace(self, trace: list[dict]) -> list[int]:
        return [self.submit(e) for e in trace]

    def seal(self):
        """Seal the PREFILL stage only: the decode stage stays open for
        forwards until every prefill settles (`wait_all` seals it)."""
        self.prefill.seal()

    def wait_all(self, timeout: float | None = None) -> bool:
        """Prefill settles -> no more forwards are coming -> seal decode
        -> decode settles."""
        t0 = time.monotonic()
        if not self.prefill.wait_all(timeout):
            return False
        self.decode.seal()
        left = (None if timeout is None
                else max(0.0, timeout - (time.monotonic() - t0)))
        return self.decode.wait_all(left)

    def finished(self) -> bool:
        if not self.prefill.finished():
            return False
        self.decode.seal()
        return self.decode.finished()

    def results(self) -> dict[int, list]:
        out = {rid: toks for rid, toks in self.prefill.results().items()
               if rid not in self._forwarded}
        out.update(self.decode.results())
        return out

    def records(self) -> dict[str, dict[int, RequestRecord]]:
        return {"prefill": self.prefill.records(),
                "decode": self.decode.records()}

    def stats(self) -> dict:
        return {"prefill": self.prefill.stats(),
                "decode": self.decode.stats()}

    def pool_pressure(self) -> dict:
        return {"prefill": self.prefill.pool_pressure(),
                "decode": self.decode.pool_pressure()}

    def close(self):
        self.prefill.close()
        self.decode.close()
