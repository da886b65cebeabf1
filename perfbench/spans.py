"""The program's spans in a serve run, for the per-layer readers.

A serve payload's exit telemetry carries ``trace``: the export of the
port's span recorder (``repro_torch.core.spans``), columns of span ids,
names, ``time.monotonic_ns()`` stamps, parents, request ids, one integer
attribute, a tag and a thread each, with the names table, the ring's
``dropped`` count, the export's ``cut``, the stamp after which nothing
was dropped or cut (``kept_since_ns``) and two clock pairs
(``monotonic_ns``, Unix ns).  `load` reads it for the window: the spans
that start at or after ``run["t0"]`` and end
before the profiled sub-window starts (``run["profile"]["t0"]``, else
``run["t1"]``), since the profiler's start and stop stall the host, so a
tick that overlaps the profiler's start is left out.  Where the run has no
trace (a program without the recorder) or spans that may be newer than
``run["t0"]`` were dropped or cut, there is nothing to read: None.
"""

from __future__ import annotations

import numpy as np


class Trace:
    """The trace's spans as numpy columns (``id``, ``name`` (a string),
    ``t0``, ``t1``, ``parent``, ``rid``, ``attr``) and the window's
    bounds ``lo`` and ``hi`` in monotonic ns."""

    def __init__(self, trace: dict, lo: int, hi: int):
        cols = trace["spans"]
        names = np.asarray(trace["names"], dtype=object)
        self.lo, self.hi = lo, hi
        for c in ("id", "t0", "t1", "parent", "rid", "attr"):
            setattr(self, c, np.asarray(cols[c], dtype=np.int64))
        self.name = names[np.asarray(cols["name"], dtype=np.int64)]

    def inside(self, name: str) -> np.ndarray:
        """Indices of the ``name`` spans inside the window."""
        return np.flatnonzero((self.name == name) & (self.t0 >= self.lo)
                              & (self.t1 < self.hi))

    def children(self, name: str, of: np.ndarray) -> dict[int, list[int]]:
        """For each index in ``of``, the indices of its ``name`` children."""
        want = {int(self.id[i]): int(i) for i in of}
        out: dict[int, list[int]] = {int(i): [] for i in of}
        for k in np.flatnonzero(self.name == name):
            p = want.get(int(self.parent[k]))
            if p is not None:
                out[p].append(int(k))
        return out

    def ms(self, idx) -> np.ndarray:
        return (self.t1[idx] - self.t0[idx]) / 1e6


def load(run) -> Trace | None:
    trace = (run.get("telemetry") or {}).get("trace")
    if not trace:
        return None
    lo = round(run["t0"] * 1e9)
    prof = run.get("profile")
    hi = round((prof["t0"] if prof else run["t1"]) * 1e9)
    kept = trace.get("kept_since_ns")
    if kept is not None and kept >= lo:
        return None
    return Trace(trace, lo, hi)


def _leases(tr: Trace) -> list[tuple[int, int, int]]:
    """(rid, its ``pool.wait``, its ``engine.admit``) per request of the
    window: its last admission (the completed attempt's, which ends at the
    first token the pool records), where that lies inside the window, and
    the last lease of its rid that ended before that admission began,
    from a submit at or after the window's start.  A request admitted
    again after the window (its lease lost while the profiler's stop held
    the host) is not the window's."""
    last: dict[int, int] = {}
    for a in np.flatnonzero(tr.name == "engine.admit"):
        rid = int(tr.rid[a])
        if rid not in last or tr.t1[a] >= tr.t1[last[rid]]:
            last[rid] = int(a)
    waits = np.flatnonzero(tr.name == "pool.wait")
    out = []
    for rid, a in last.items():
        if not (tr.t0[a] >= tr.lo and tr.t1[a] < tr.hi):
            continue
        w = waits[(tr.rid[waits] == rid) & (tr.t1[waits] <= tr.t0[a])]
        if len(w):
            w = w[np.argmax(tr.t1[w])]
            if tr.t0[w] >= tr.lo:
                out.append((rid, int(w), a))
    return out


def requests(tr: Trace) -> np.ndarray:
    """Per request of the window (`_leases`), (lease wait, engine queue,
    admission) in ms, one row each; their sum is its time to first
    token."""
    return np.asarray([((tr.t1[w] - tr.t0[w]) / 1e6,
                        (tr.t0[a] - tr.t1[w]) / 1e6,
                        (tr.t1[a] - tr.t0[a]) / 1e6)
                       for _, w, a in _leases(tr)],
                      dtype=np.float64).reshape(-1, 3)


def loop_host_ms(tr: Trace) -> np.ndarray:
    """Per busy ``fleet.tick`` of the window (``attr`` 1), its length less
    its ``engine.step`` child's: the fleet loop's host time."""
    ticks = tr.inside("fleet.tick")
    ticks = ticks[tr.attr[ticks] == 1]
    steps = tr.children("engine.step", ticks)
    return np.asarray([tr.ms(t) - sum(tr.ms(k) for k in steps[int(t)])
                       for t in ticks if steps[int(t)]], dtype=np.float64)


def phase_ms(tr: Trace, name: str) -> np.ndarray:
    """Per busy ``fleet.tick`` of the window, the length of its ``name``
    child (one of the loop's host phases)."""
    ticks = tr.inside("fleet.tick")
    kids = tr.children(name, ticks[tr.attr[ticks] == 1])
    return np.asarray([sum(tr.ms(k) for k in ks) for ks in kids.values()
                       if ks], dtype=np.float64)


def median_phase_ms(run, name: str) -> float | None:
    """The median of `phase_ms` in ``run``; None with nothing to read."""
    tr = load(run)
    ms = phase_ms(tr, name) if tr is not None else ()
    return float(np.median(ms)) if len(ms) else None


CHILDREN = ("fleet.fetch", "engine.step", "fleet.complete", "fleet.renew",
            "fleet.report")


def accounting(tr: Trace, first_token_s: dict[int, float]) -> dict:
    """How well the spans account for the serving thread over the window:
    the share of it that ``fleet.tick`` spans cover (cut to the window),
    the share of busy ticks whose direct children sum to the tick within
    2 %, and the share of requests whose lease wait, engine queue and
    admission sum to the pool's ``first_token_s`` (by rid, in s) within
    1 ms."""
    every = np.flatnonzero(tr.name == "fleet.tick")
    covered = float(np.sum(np.clip(tr.t1[every], tr.lo, tr.hi)
                           - np.clip(tr.t0[every], tr.lo, tr.hi)))
    ticks = tr.inside("fleet.tick")
    busy = ticks[tr.attr[ticks] == 1]
    kids = {}
    for name in CHILDREN:
        for t, ks in tr.children(name, busy).items():
            kids.setdefault(t, []).extend(ks)
    within = [abs(sum(tr.ms(k) for k in kids.get(int(t), ())) - tr.ms(t))
              <= 0.02 * tr.ms(t) for t in busy]
    ttft = [abs((tr.t1[a] - tr.t0[w]) / 1e9 - first_token_s[rid]) <= 1e-3
            for rid, w, a in _leases(tr)
            if first_token_s.get(rid) is not None]
    return {"tick_cover": covered / (tr.hi - tr.lo),
            "busy_ticks": len(busy),
            "children_within": float(np.mean(within)) if within else None,
            "requests": len(ttft),
            "ttft_within": float(np.mean(ttft)) if ttft else None}
