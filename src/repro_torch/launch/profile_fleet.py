"""How long a fleet server's leases go unrenewed, beside the lease TTL.

    python -m repro_torch.launch.profile_fleet [--ttl 1.0 3.0] [--reps 3] \
        [--smoke --device cpu]

A fleet server renews its request leases once a tick, and on one card its
tick waits for the other servers' turns at the device lock; a lease that
goes unrenewed for longer than the TTL expires, and the pool replays work
its live server was doing (a lost lease).  For each TTL this runs, ``--reps``
times each, the two fleet runs of ``chip_smoke.py`` on its serve trace (16
requests, prompts of 24-900 tokens, 64 new tokens; smollm-360m at full
width unless ``--smoke``, 8 slots, max_len 1024, the hand-written
kernels): ``serve``, 3 pilots and no failure, and ``spec``, 2
self-drafting pilots with the one holding the most leases killed once 4
requests have settled.  For every renewal it takes the time since the
lease was fetched or last renewed by that server, wrapping the pool's
``fetch`` and ``renew`` for the run (a killed server's own telemetry dies
with it, so the pool's side is where its gaps can be seen).  Prints one
JSON line a run: per server its longest fetch-to-first-renewal and
renewal-to-renewal gaps, renewals and lost leases; the pool's replays and
lost leases; and the wall time.
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.analysis.locks import make_lock
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.launch.serve import make_trace, serve_fleet
from repro_torch.serving.dispatch import FleetDispatcher

RUNS = {"serve": dict(n_pilots=3),
        "spec": dict(n_pilots=2, draft="self", fail_at=4)}


class _LeaseGaps:
    """Wraps ``FleetDispatcher.announce``, ``fetch`` and ``renew`` while
    entered and records, per server, the longest gap before a lease's
    first renewal (from its fetch) and between two renewals, the leases
    lost, the time of each renewal call (``renew_times``) and when it
    announced itself (``announced``)."""

    def __init__(self):
        self._lock = make_lock("profile_fleet.gaps")
        self._last: dict[tuple, tuple[str, float]] = {}
        self.by_server: dict[str, dict] = {}
        self.renew_times: dict[str, list[float]] = {}
        self.announced: dict[str, float] = {}

    def __enter__(self):
        announce = FleetDispatcher.announce
        fetch, renew = FleetDispatcher.fetch, FleetDispatcher.renew
        gaps = self

        def announce_(pool, server_id, labels=None):
            announce(pool, server_id, labels=labels)
            with gaps._lock:
                gaps.announced[server_id] = time.monotonic()

        def fetch_(pool, server_id, **kw):
            out = fetch(pool, server_id, **kw)
            now = time.monotonic()
            with gaps._lock:
                for e in out:
                    gaps._last[(server_id, e["rid"])] = ("fetch", now)
            return out

        def renew_(pool, server_id, progress):
            now = time.monotonic()
            lost = renew(pool, server_id, progress)
            with gaps._lock:
                gaps.renew_times.setdefault(server_id, []).append(now)
                row = gaps.by_server.setdefault(server_id, {
                    "fetch_to_renew_max_s": 0.0, "renew_gap_max_s": 0.0,
                    "renewals": 0, "lost": 0})
                for rid in progress:
                    kind, t = gaps._last.get((server_id, rid), ("renew", now))
                    key = ("fetch_to_renew_max_s" if kind == "fetch"
                           else "renew_gap_max_s")
                    row[key] = max(row[key], now - t)
                    row["renewals"] += 1
                    row["lost"] += rid in lost
                    gaps._last[(server_id, rid)] = ("renew", now)
            return lost

        self._saved = announce, fetch, renew
        (FleetDispatcher.announce, FleetDispatcher.fetch,
         FleetDispatcher.renew) = announce_, fetch_, renew_
        return self

    def __exit__(self, *exc):
        (FleetDispatcher.announce, FleetDispatcher.fetch,
         FleetDispatcher.renew) = self._saved


def profile(ttl: float, run: str, *, smoke: bool = False,
            device="cuda") -> dict:
    cfg = (get_smoke_config if smoke else get_config)("smollm-360m")
    trace = make_trace(cfg.vocab_size, 16, max_len=1024, seed=0,
                       prompt_len=(24, 900), max_new_tokens=64)
    kw = dict(RUNS[run])
    n = kw.pop("n_pilots")
    with _LeaseGaps() as gaps:
        out = serve_fleet("smollm-360m", 16, n, slots=8, max_len=1024,
                          lease_ttl=ttl, trace=trace, smoke=smoke,
                          device=device, **kw)
    return {"run": run, "lease_ttl": ttl, "pilots": n,
            "failed_pilots": out["failed_pilots"],
            "replays": out["replays"], "lost_leases": out["lost_leases"],
            "completed": out["completed"], "wall_s": out["wall_s"],
            "servers": gaps.by_server}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ttl", type=float, nargs="+", default=[1.0, 3.0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--runs", nargs="+", default=list(RUNS), choices=RUNS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for ttl in args.ttl:
        for run in args.runs:
            for rep in range(args.reps):
                print(json.dumps({**profile(ttl, run, smoke=args.smoke,
                                            device=args.device),
                                  "rep": rep}), flush=True)


if __name__ == "__main__":
    main()
