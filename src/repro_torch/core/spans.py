"""One recorder of spans and counters for the port's serve path.

A span is a name, a start and an end from ``time.monotonic_ns()``, the
id of the span that was open on the same thread when it began (its
parent), and optionally a request id (``rid``), one small integer
attribute (``attr``: a bucket, an attempt, a shape, a count), a tag
(``tag``: an interned string, such as a server id) and the recording
thread's index (``thread``).  An instant event is
a span whose start is its end; the rare counters are events.

The spans live in one process-wide ring of preallocated columns
(`CAPACITY` spans; the oldest are overwritten, and `Recorder.export` says
how many).  Recording takes no lock: a span's id comes from one
``itertools.count`` (atomic under the interpreter lock), each thread
writes only the slot its id names, and each thread keeps its own stack of
open spans, which gives the parent.  A slot's id is cleared before its
other columns are written and set after, so an export taken while other
threads record skips the rows it caught half written.

Recording is on by default; ``spans.enabled = False`` turns every call
site off, each then costing one attribute test.  Nothing is recorded
inside a function that a CUDA graph captures: a capture runs the host
code once, and the replays run none of it.

`Recorder.export` returns a columnar dict that survives JSON (one
thread's spans, or all; at most ``limit`` of the newest), with two
clock pairs (``monotonic_ns``, ``time.time_ns()``), one taken when the
recorder was made and one at the export: a span's stamp plus the pair's
difference is its time on the Unix clock, which ``torch.profiler``'s
events use.

Where each span is taken (the serve path, from the pool down), and what
reads it (``perfbench/metrics/<name>.py``, ``launch/profile_fleet.py``):

========================  ===================================================
``pool.wait``             `FleetDispatcher.fetch`: the request's submit to its
                          lease; rid, attempt, server tag (`lease_wait_ms`,
                          `admit_wait_ms`; profile_fleet's renewal gaps)
``fleet.tick``            one loop iteration of the fleet server; ``attr`` 1
                          when the engine held work, 0 for an idle poll
                          (`loop_host_ms`)
``fleet.fetch``,          the loop's host phases, children of ``fleet.tick``
``fleet.complete``,       (`fetch_ms`, `complete_ms`, `renew_ms`,
``fleet.renew``,          `report_ms`); ``fleet.renew`` carries the leases
``fleet.report``          renewed and the server tag (profile_fleet)
``fleet.announce``        event: the server announced itself to the pool
                          (profile_fleet)
``fleet.lost``            event: a renewal the pool refused; rid, server tag
                          (profile_fleet)
``engine.step``           `ServeEngine.step`, the stamps of its tick time
                          (`loop_host_ms`)
``engine.admit``          one one-shot admission, to its first-token stamp;
                          rid, bucket (`admit_ms`, `admit_wait_ms`)
``engine.decode``         the decode half of a step: replay, the one copy,
                          the unpack and the evictions (`decode_ms`)
``graph.capture``         event: a CUDA graph captured; kind tag, shape
                          (`graph_captures`)
========================  ===================================================
"""

from __future__ import annotations

import itertools
import threading
import time

from repro_torch.analysis.locks import make_lock

CAPACITY = 1 << 18     # spans kept: ~60k in an 80 s serve run of one card
COLUMNS = ("id", "name", "t0", "t1", "parent", "rid", "attr", "tag",
           "thread")
SLACK_NS = 1_000_000_000

enabled = True


def clock_pair() -> list[int]:
    """(``monotonic_ns``, ``time.time_ns()``) read together: the mean of
    two monotonic reads around the Unix one."""
    a = time.monotonic_ns()
    u = time.time_ns()
    b = time.monotonic_ns()
    return [(a + b) // 2, u]


class _Thread:
    """A recording thread's index and its stack of open spans."""
    __slots__ = ("index", "stack")

    def __init__(self, index: int):
        self.index = index
        self.stack: list[int] = []


class Recorder:
    """The ring of spans; see the module's documentation."""

    def __init__(self, capacity: int = CAPACITY):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError(f"capacity {capacity} is not a power of two")
        self.capacity = capacity
        self._mask = capacity - 1
        self.id = [-1] * capacity
        (self.name, self.t0, self.t1, self.parent, self.rid, self.attr,
         self.tag, self.thread) = ([0] * capacity for _ in range(8))
        self._claim = itertools.count().__next__
        self._threads = itertools.count().__next__
        self._last = -1            # the newest id written (a hint)
        self._local = threading.local()
        self._lock = make_lock("spans.names")
        self._index: dict[str, int] = {}
        self._strings: list[str] = []
        self.clock0 = clock_pair()

    def intern(self, s: str) -> int:
        """The index of ``s`` in the names table (span names and tags)."""
        i = self._index.get(s)
        if i is None:
            with self._lock:
                i = self._index.get(s)
                if i is None:
                    i = len(self._strings)
                    self._strings.append(s)
                    self._index[s] = i
        return i

    def _thread(self) -> _Thread:
        try:
            return self._local.state
        except AttributeError:
            self._local.state = st = _Thread(self._threads())
            return st

    def thread_index(self) -> int:
        """The calling thread's index in the ``thread`` column."""
        return self._thread().index

    def _put(self, name, t0, t1, parent, rid, attr, tag, thread) -> int:
        i = self._claim()
        j = i & self._mask
        self.id[j] = -1
        self.name[j] = name
        self.t0[j] = t0
        self.t1[j] = t1
        self.parent[j] = parent
        self.rid[j] = rid
        self.attr[j] = attr
        self.tag[j] = tag
        self.thread[j] = thread
        self.id[j] = i
        self._last = i
        return i

    def begin(self, name: int, t0: int, rid: int = -1, attr: int = 0,
              tag: int = -1) -> int:
        """Open a span at ``t0``; it is the parent of what this thread
        records until `end`.  Returns its id."""
        st = self._thread()
        stack = st.stack
        i = self._put(name, t0, -1, stack[-1] if stack else -1, rid, attr,
                      tag, st.index)
        stack.append(i)
        return i

    def end(self, i: int, t1: int, attr: int | None = None):
        """Close span ``i`` at ``t1`` (and set its ``attr``), and every
        span this thread opened inside it and left open."""
        j = i & self._mask
        if self.id[j] == i:
            self.t1[j] = t1
            if attr is not None:
                self.attr[j] = attr
        stack = self._thread().stack
        while stack and stack.pop() != i:
            pass

    def record(self, name: int, t0: int, t1: int, rid: int = -1,
               attr: int = 0, tag: int = -1) -> int:
        """A whole span, under this thread's open span."""
        st = self._thread()
        stack = st.stack
        return self._put(name, t0, t1, stack[-1] if stack else -1, rid,
                         attr, tag, st.index)

    def event(self, name: int, t: int, rid: int = -1, attr: int = 0,
              tag: int = -1) -> int:
        return self.record(name, t, t, rid, attr, tag)

    def reset_thread(self):
        """Forget this thread's open spans (a payload that raised left
        some): what it records next has no parent."""
        self._thread().stack.clear()

    def export(self, since_ns: int | None = None, thread: int | None = None,
               limit: int | None = None) -> dict:
        """The closed spans kept that end at or after ``since_ns`` (None:
        every one), recorded by thread ``thread`` (`thread_index`; None:
        every thread), the newest ``limit`` of them at most (None: no
        bound), as columns in the order their ids were claimed: at a
        span's start (`begin`) or its end (`record`).  ``dropped`` counts
        the spans overwritten in the ring and ``cut`` those the limit left
        out; every span that starts after ``kept_since_ns`` is in the
        export (None: nothing was dropped or cut).  With
        ``since_ns`` the scan goes back from the newest span and stops at
        one that ended `SLACK_NS` before it: threads claim ids in the
        order of their stamps to within a switch of the interpreter lock.
        ``clock_pairs`` maps the stamps onto the Unix clock."""
        mask, ids, t1s, threads = self._mask, self.id, self.t1, self.thread
        last = self._last
        while ids[(last + 1) & mask] == last + 1:
            last += 1              # (another thread's hint came first)
        oldest = max(0, last + 1 - self.capacity)
        stop = -1 if since_ns is None else since_ns - SLACK_NS
        seen = []
        for i in range(last, oldest - 1, -1):
            j = i & mask
            if ids[j] != i:
                if ids[j] > i:
                    break          # overwritten meanwhile, and all before
                continue           # being written
            if 0 <= t1s[j] < stop:
                break
            if thread is None or threads[j] == thread:
                seen.append((i, j))
        seen.reverse()
        floor = 0 if since_ns is None else since_ns
        # (rewritten since, still open, or older)
        seen = [(i, j) for i, j in seen if ids[j] == i and t1s[j] >= floor]
        cut = 0 if limit is None else max(0, len(seen) - limit)
        cut_since = max((self.t0[j] for _, j in seen[:cut]), default=None)
        seen = seen[cut:]
        cols = {c: [] for c in COLUMNS}
        pairs = [(getattr(self, c), cols[c]) for c in COLUMNS[1:]]
        for i, j in seen:
            cols["id"].append(i)
            for src, dst in pairs:
                dst.append(src[j])
        kept_since = None
        if oldest:                 # (what was dropped was claimed before)
            j = oldest & mask
            kept_since = t1s[j] if t1s[j] >= 0 else self.t0[j]
        if cut:
            kept_since = max(kept_since or 0, cut_since)
        with self._lock:
            names = list(self._strings)
        return {"capacity": self.capacity, "dropped": oldest, "cut": cut,
                "kept_since_ns": kept_since,
                "clock_pairs": [self.clock0, clock_pair()],
                "names": names, "spans": cols}


RECORDER = Recorder()
intern = RECORDER.intern
begin = RECORDER.begin
end = RECORDER.end
record = RECORDER.record
event = RECORDER.event
export = RECORDER.export
reset_thread = RECORDER.reset_thread
thread_index = RECORDER.thread_index

POOL_WAIT = intern("pool.wait")
FLEET_TICK = intern("fleet.tick")
FLEET_FETCH = intern("fleet.fetch")
FLEET_COMPLETE = intern("fleet.complete")
FLEET_RENEW = intern("fleet.renew")
FLEET_REPORT = intern("fleet.report")
FLEET_ANNOUNCE = intern("fleet.announce")
FLEET_LOST = intern("fleet.lost")
ENGINE_STEP = intern("engine.step")
ENGINE_ADMIT = intern("engine.admit")
ENGINE_DECODE = intern("engine.decode")
GRAPH_CAPTURE = intern("graph.capture")
