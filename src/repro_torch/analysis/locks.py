"""Instrumented locking layer: drop-in Lock/RLock/Condition with auditing.

Every lock in ``core/`` and ``serving/`` is created through this module's
factory (``make_lock`` / ``make_rlock`` / ``make_condition``) instead of
bare ``threading.*`` — the repo lint enforces this.  A tracked lock is a
thin wrapper over the stdlib primitive whose hot path costs one module
attribute read when no auditor is installed (the same idiom as
``chaos.site``).  With a :class:`LockAuditor` installed, every
acquisition records:

- the per-thread **held-set** at the moment of acquisition,
- an **edge** ``held -> acquired`` into a global lock-order graph
  (instance-granular, so the disagg prefill->decode pool chain — two
  *different* pool locks taken in a fixed order — is not a false cycle),
- the **witness stack** the first time each edge is seen,
- **hierarchy violations**: the documented order is pool -> repo -> wheel
  (``RANK_POOL < RANK_REPO < RANK_WHEEL``); acquiring a lower-ranked
  lock while holding a higher-ranked one is flagged,
- **blocking-under-lock**: ``Condition.wait`` while holding any *other*
  tracked lock,
- **callback-under-lock**: ``audit_callback(site)`` is called by the
  runtime immediately before invoking user-supplied hooks (timer-wheel
  callbacks, ``on_complete``, ``on_expired``, proc-table listeners,
  executor ``on_exit``); if any tracked lock is held at that point the
  auditor records a violation.

The auditor also exposes a ``preempt`` hook fired at every tracked
acquire/release/wait boundary — the deterministic schedule fuzzer
(:mod:`repro_torch.analysis.fuzz`) uses it to inject seeded context switches.

Lock-ranks are coarse *classes*; cycle detection runs on instances.  A
rank of ``None`` means "leaf / unranked": the lock participates in the
graph but not in the rank check.
"""

from __future__ import annotations

import itertools
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "RANK_POOL",
    "RANK_REPO",
    "RANK_WHEEL",
    "TrackedLock",
    "TrackedRLock",
    "TrackedCondition",
    "LockAuditor",
    "make_lock",
    "make_rlock",
    "make_condition",
    "audit_callback",
    "current_auditor",
]

# Documented acquisition order: a pool lock may be held while taking the
# repo lock (dispatch fetch/complete/release all call into TaskRepo with
# the pool lock held), and the repo lock may be held while taking the
# timer-wheel lock (arming defer/reap timers).  Never the reverse.
RANK_POOL = 10
RANK_REPO = 20
RANK_WHEEL = 30

_RANK_NAMES = {RANK_POOL: "pool", RANK_REPO: "repo", RANK_WHEEL: "wheel"}

# The one module-global the hot path reads.  None => auditing off.
_AUDITOR: Optional["LockAuditor"] = None
_INSTALL_LOCK = threading.Lock()
_SEQ = itertools.count(1)


def current_auditor() -> Optional["LockAuditor"]:
    """The currently installed auditor, or None."""
    return _AUDITOR


def audit_callback(site: str) -> None:
    """Runtime guard: call immediately before invoking a user callback.

    Records a ``callback-under-lock`` violation if the calling thread
    holds any tracked lock.  One attr read when auditing is off.
    """
    a = _AUDITOR
    if a is not None:
        a.note_callback(site)


class TrackedLock:
    """Non-reentrant mutex wrapping ``threading.Lock``.

    Defines ``_is_owned`` (via explicit owner tracking) so it can back a
    ``threading.Condition`` — the stdlib default probes ownership with a
    nonblocking acquire, which would corrupt our bookkeeping.
    """

    __slots__ = ("_inner", "name", "rank", "seq", "_owner")

    reentrant = False

    def __init__(self, name: str, rank: Optional[int] = None):
        self._inner = threading.Lock()
        self.name = name
        self.rank = rank
        self.seq = next(_SEQ)
        self._owner = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        a = _AUDITOR
        if a is not None:
            a.before_acquire(self)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            if a is not None:
                a.on_acquired(self)
        return got

    def release(self) -> None:
        # Owner cleared before the inner release so a racing acquirer
        # never observes itself as a stale owner.
        self._owner = 0
        self._inner.release()
        a = _AUDITOR
        if a is not None:
            a.on_released(self)

    def locked(self) -> bool:
        return self._inner.locked()

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    # Condition support: with _is_owned defined, the stdlib default
    # _release_save/_acquire_restore (plain release/acquire) are correct
    # and route through our tracked acquire/release.

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TrackedLock {self.name!r} seq={self.seq} rank={self.rank}>"


class TrackedRLock:
    """Reentrant mutex wrapping ``threading.RLock``.

    Only the *outermost* acquire/release of a reentrant hold is reported
    to the auditor — nested re-acquisition by the owning thread is not an
    ordering event and must not create self-edges.
    """

    __slots__ = ("_inner", "name", "rank", "seq", "_owner", "_count")

    reentrant = True

    def __init__(self, name: str, rank: Optional[int] = None):
        self._inner = threading.RLock()
        self.name = name
        self.rank = rank
        self.seq = next(_SEQ)
        self._owner = 0
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        a = _AUDITOR
        first = self._owner != threading.get_ident()
        if a is not None and first:
            a.before_acquire(self)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            self._count += 1
            if a is not None and first:
                a.on_acquired(self)
        return got

    def release(self) -> None:
        self._count -= 1
        last = self._count == 0
        if last:
            self._owner = 0
        self._inner.release()
        if last:
            a = _AUDITOR
            if a is not None:
                a.on_released(self)

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    # Condition support for reentrant locks: wait() must fully release
    # the recursion and restore it on wakeup.
    def _release_save(self) -> Tuple[Any, int]:
        count = self._count
        self._count = 0
        self._owner = 0
        state = self._inner._release_save()
        a = _AUDITOR
        if a is not None:
            a.on_released(self)
        return (state, count)

    def _acquire_restore(self, saved: Tuple[Any, int]) -> None:
        state, count = saved
        a = _AUDITOR
        if a is not None:
            a.before_acquire(self)
        self._inner._acquire_restore(state)
        self._owner = threading.get_ident()
        self._count = count
        if a is not None:
            a.on_acquired(self)

    def __enter__(self) -> "TrackedRLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TrackedRLock {self.name!r} seq={self.seq} rank={self.rank}>"


class TrackedCondition(threading.Condition):
    """``threading.Condition`` over a tracked lock.

    Reuses the stdlib wait/notify machinery (it duck-types through the
    lock's ``acquire``/``release``/``_is_owned``/``_release_save``/
    ``_acquire_restore``), adding only the wait-under-lock check and the
    fuzzer preemption point.
    """

    def __init__(self, lock: Any):
        if not isinstance(lock, (TrackedLock, TrackedRLock)):
            raise TypeError("TrackedCondition requires a tracked lock")
        super().__init__(lock)

    def wait(self, timeout: Optional[float] = None) -> bool:
        a = _AUDITOR
        if a is not None:
            a.note_wait(self._lock)
        return super().wait(timeout)


def make_lock(name: str, *, rank: Optional[int] = None) -> TrackedLock:
    """Factory for a non-reentrant tracked mutex."""
    return TrackedLock(name, rank)


def make_rlock(name: str, *, rank: Optional[int] = None) -> TrackedRLock:
    """Factory for a reentrant tracked mutex."""
    return TrackedRLock(name, rank)


def make_condition(
    lock: Any = None, *, name: str = "condition", rank: Optional[int] = None
) -> TrackedCondition:
    """Factory for a condition variable over a tracked lock.

    With ``lock=None`` a fresh ``TrackedRLock`` backs the condition
    (matching the stdlib default of an RLock).  Pass an existing tracked
    lock to share it between plain ``with`` sections and the condition —
    the usual repo/pool pattern.
    """
    if lock is None:
        lock = TrackedRLock(name, rank)
    return TrackedCondition(lock)


class LockAuditor:
    """Records lock acquisition order and concurrency-discipline violations.

    Install with ``install()`` / ``uninstall()`` or as a context manager.
    Installation nests: installing while another auditor is active stashes
    the previous one and restores it on uninstall, so tests can run a
    private auditor under the session-wide ``--concurrency-audit`` one.

    Violation kinds recorded in ``violations`` (list of dicts):

    - ``self-deadlock``   — re-acquire of a non-reentrant lock the thread
      already owns (also raised as RuntimeError: the acquire would hang).
    - ``lock-hierarchy``  — acquired a lower-ranked lock while holding a
      higher-ranked one (pool -> repo -> wheel is the documented order).
    - ``wait-under-lock`` — Condition.wait while holding another tracked
      lock (wait releases only its own lock; the rest block strangers).
    - ``callback-under-lock`` — user hook invoked with a tracked lock held
      (see ``audit_callback``).

    ``preempt``, if set, is called as ``preempt(point, lock)`` with
    ``point`` in {"acquire", "release", "wait"} at every boundary — the
    schedule fuzzer's injection point.
    """

    def __init__(
        self,
        *,
        preempt: Optional[Callable[[str, Any], None]] = None,
        stack_limit: int = 14,
    ):
        # Raw stdlib lock on purpose: the auditor's own mutex must not
        # feed back into the graph it maintains.
        self._mu = threading.Lock()
        self._tl = threading.local()
        # (src_seq, dst_seq) -> edge record
        self._edges: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self.violations: List[Dict[str, Any]] = []
        self.acquired_total = 0  # benign data race: approximate counter
        self.preempt = preempt
        self.stack_limit = stack_limit
        self._prev: Optional["LockAuditor"] = None

    # -- installation -------------------------------------------------

    def install(self) -> "LockAuditor":
        global _AUDITOR
        with _INSTALL_LOCK:
            self._prev = _AUDITOR
            _AUDITOR = self
        return self

    def uninstall(self) -> None:
        global _AUDITOR
        with _INSTALL_LOCK:
            if _AUDITOR is self:
                _AUDITOR = self._prev
            self._prev = None

    def __enter__(self) -> "LockAuditor":
        return self.install()

    def __exit__(self, *exc: Any) -> None:
        self.uninstall()

    # -- per-thread state ---------------------------------------------

    def _held(self) -> List[Any]:
        h = getattr(self._tl, "held", None)
        if h is None:
            h = self._tl.held = []
        return h

    def held_names(self) -> List[str]:
        """Names of tracked locks held by the calling thread."""
        return [h.name for h in self._held()]

    # -- event sinks (called from tracked locks) ----------------------

    def before_acquire(self, lock: Any) -> None:
        if self.preempt is not None:
            self.preempt("acquire", lock)
        held = self._held()
        if not held:
            return
        if not lock.reentrant and lock._is_owned():
            self._violate(
                "self-deadlock",
                f"thread re-acquired non-reentrant lock {lock.name!r} "
                f"it already holds",
            )
            raise RuntimeError(
                f"self-deadlock: {lock.name!r} is non-reentrant and already "
                f"held by this thread"
            )
        if lock.rank is not None:
            worst = None
            for h in held:
                if h.rank is not None and h.rank > lock.rank:
                    if worst is None or h.rank > worst.rank:
                        worst = h
            if worst is not None:
                self._violate(
                    "lock-hierarchy",
                    f"acquired {lock.name!r} "
                    f"({_RANK_NAMES.get(lock.rank, lock.rank)}) while holding "
                    f"{worst.name!r} ({_RANK_NAMES.get(worst.rank, worst.rank)}) "
                    f"— documented order is pool -> repo -> wheel",
                )
        for h in held:
            if h is lock:
                continue
            self._edge(h, lock)

    def on_acquired(self, lock: Any) -> None:
        self.acquired_total += 1
        self._held().append(lock)

    def on_released(self, lock: Any) -> None:
        held = self._held()
        # Out-of-LIFO release is legal; drop the most recent occurrence.
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                break
        if self.preempt is not None:
            self.preempt("release", lock)

    def note_wait(self, lock: Any) -> None:
        others = [h for h in self._held() if h is not lock]
        if others:
            self._violate(
                "wait-under-lock",
                f"Condition.wait on {lock.name!r} while still holding "
                f"{[h.name for h in others]!r}",
            )
        if self.preempt is not None:
            self.preempt("wait", lock)

    def note_callback(self, site: str) -> None:
        held = self._held()
        if held:
            self._violate(
                "callback-under-lock",
                f"user callback {site!r} invoked while holding "
                f"{[h.name for h in held]!r}",
            )

    # -- graph bookkeeping --------------------------------------------

    def _edge(self, src: Any, dst: Any) -> None:
        key = (src.seq, dst.seq)
        rec = self._edges.get(key)
        if rec is not None:
            rec["count"] += 1  # benign race on the counter
            return
        stack = "".join(
            traceback.format_stack(limit=self.stack_limit)[:-2]
        )
        with self._mu:
            rec = self._edges.get(key)
            if rec is not None:
                rec["count"] += 1
                return
            self._edges[key] = {
                "src": src.name,
                "dst": dst.name,
                "src_seq": src.seq,
                "dst_seq": dst.seq,
                "count": 1,
                "thread": threading.current_thread().name,
                "stack": stack,
            }

    def _violate(self, kind: str, message: str) -> None:
        stack = "".join(traceback.format_stack(limit=self.stack_limit)[:-2])
        with self._mu:
            self.violations.append(
                {
                    "kind": kind,
                    "message": message,
                    "thread": threading.current_thread().name,
                    "stack": stack,
                }
            )

    # -- reporting ----------------------------------------------------

    def edges(self) -> List[Dict[str, Any]]:
        with self._mu:
            return list(self._edges.values())

    def cycles(self) -> List[List[Dict[str, Any]]]:
        """Instance-level cycles in the acquisition graph.

        Each cycle is returned as the list of edge records along it
        (with witness stacks).  Uses iterative Tarjan SCC: any strongly
        connected component with more than one node is a potential
        deadlock.
        """
        with self._mu:
            edges = dict(self._edges)
        adj: Dict[int, List[int]] = {}
        for (s, d) in edges:
            adj.setdefault(s, []).append(d)
            adj.setdefault(d, [])
        index: Dict[int, int] = {}
        low: Dict[int, int] = {}
        on_stack: Dict[int, bool] = {}
        stack: List[int] = []
        sccs: List[List[int]] = []
        counter = itertools.count()

        for root in adj:
            if root in index:
                continue
            work: List[Tuple[int, int]] = [(root, 0)]
            while work:
                node, pi = work[-1]
                if pi == 0:
                    index[node] = low[node] = next(counter)
                    stack.append(node)
                    on_stack[node] = True
                recurse = False
                succs = adj[node]
                while pi < len(succs):
                    w = succs[pi]
                    pi += 1
                    if w not in index:
                        work[-1] = (node, pi)
                        work.append((w, 0))
                        recurse = True
                        break
                    elif on_stack.get(w):
                        low[node] = min(low[node], index[w])
                if recurse:
                    continue
                work[-1] = (node, pi)
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack[w] = False
                        comp.append(w)
                        if w == node:
                            break
                    if len(comp) > 1:
                        sccs.append(comp)
                work.pop()
                if work:
                    parent, _ = work[-1]
                    low[parent] = min(low[parent], low[node])

        out: List[List[Dict[str, Any]]] = []
        for comp in sccs:
            members = set(comp)
            out.append(
                [
                    rec
                    for (s, d), rec in edges.items()
                    if s in members and d in members
                ]
            )
        return out

    def hierarchy_table(self) -> Dict[str, List[str]]:
        """Name-level aggregation: held-lock -> sorted acquired-locks.

        Instance suffixes like ``[poolname]`` are stripped so the table
        stays stable across runs; this is what DESIGN.md embeds.
        """
        agg: Dict[str, set] = {}
        for rec in self.edges():
            src = rec["src"].split("[", 1)[0]
            dst = rec["dst"].split("[", 1)[0]
            agg.setdefault(src, set()).add(dst)
        return {k: sorted(v) for k, v in sorted(agg.items())}

    def report(self) -> Dict[str, Any]:
        cycles = self.cycles()
        with self._mu:
            violations = list(self.violations)
        return {
            "acquired_total": self.acquired_total,
            "n_edges": len(self._edges),
            "cycles": cycles,
            "violations": violations,
            "table": self.hierarchy_table(),
        }

    def format_report(self, rep: Optional[Dict[str, Any]] = None) -> str:
        rep = rep or self.report()
        lines = [
            f"lock audit: {rep['acquired_total']} acquisitions, "
            f"{rep['n_edges']} order edges, {len(rep['cycles'])} cycles, "
            f"{len(rep['violations'])} violations"
        ]
        for cyc in rep["cycles"]:
            names = " -> ".join(f"{e['src']}->{e['dst']}" for e in cyc)
            lines.append(f"  CYCLE: {names}")
            for e in cyc:
                lines.append(
                    f"    edge {e['src']} -> {e['dst']} "
                    f"(x{e['count']}, thread {e['thread']}) witness:"
                )
                lines.extend(
                    "      " + ln for ln in e["stack"].rstrip().splitlines()
                )
        for v in rep["violations"]:
            lines.append(f"  VIOLATION[{v['kind']}] ({v['thread']}): {v['message']}")
            lines.extend("      " + ln for ln in v["stack"].rstrip().splitlines())
        if rep["table"]:
            lines.append("  observed order (held -> acquired):")
            for src, dsts in rep["table"].items():
                lines.append(f"    {src} -> {', '.join(dsts)}")
        return "\n".join(lines)

    def assert_clean(self) -> None:
        rep = self.report()
        if rep["cycles"] or rep["violations"]:
            raise AssertionError(self.format_report(rep))
