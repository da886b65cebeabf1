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
lease was fetched or last renewed by that server, from the spans the
program records (`repro_torch.core.spans`: each lease's ``pool.wait``,
each ``fleet.renew``), which a killed server records too up to its death
(its own telemetry dies with it).  Prints one JSON line a run: per server
its longest fetch-to-first-renewal and renewal-to-renewal gaps, renewals
and lost leases; the pool's replays and lost leases; and the wall time.
"""

from __future__ import annotations

import argparse
import bisect
import json
import time

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core import spans
from repro_torch.launch.serve import make_trace, serve_fleet

RUNS = {"serve": dict(n_pilots=3),
        "spec": dict(n_pilots=2, draft="self", fail_at=4)}


class _LeaseGaps:
    """The renewals of the fleet servers that ran while entered, read from
    the spans they recorded (`repro_torch.core.spans`), per server: the
    longest gap before a lease's first renewal (from its ``pool.wait``'s
    end) and between two renewals both of which renewed a lease it held
    (a renewal that renews more leases than were fetched since the one
    before it renews one of them again), the leases renewed
    (``renewals``) and lost (``lost``), the time of each renewal call
    that renewed a lease (``renew_times``) and when it announced itself
    (``announced``), all in monotonic seconds.  Reads nothing while
    ``spans.enabled`` is off."""

    def __init__(self):
        self.by_server: dict[str, dict] = {}
        self.renew_times: dict[str, list[float]] = {}
        self.announced: dict[str, float] = {}

    def __enter__(self):
        self._since = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        tr = spans.export(self._since)
        names, cols = tr["names"], tr["spans"]
        leases: dict[str, list[float]] = {}
        renews: dict[str, list[tuple[float, int]]] = {}
        lost: dict[str, int] = {}
        for k, n in enumerate(cols["name"]):
            what, tag = names[n], cols["tag"][k]
            server = names[tag] if tag >= 0 else None
            t0, t1 = cols["t0"][k] / 1e9, cols["t1"][k] / 1e9
            if what == "fleet.announce":
                self.announced[server] = t0
            elif what == "pool.wait":
                leases.setdefault(server, []).append(t1)
            elif what == "fleet.renew" and cols["attr"][k] > 0:
                renews.setdefault(server, []).append((t0, cols["attr"][k]))
            elif what == "fleet.lost":
                lost[server] = lost.get(server, 0) + 1
        for server, rs in renews.items():
            rs.sort()
            times = [t for t, _ in rs]
            fetched = sorted(leases.get(server, ()))
            first = [times[i] if i < len(times) else None
                     for i in (bisect.bisect_left(times, f) for f in fetched)]
            gaps = [b - a for (a, _), (b, n) in zip(rs, rs[1:])
                    if n > sum(a < f <= b for f in fetched)]
            self.renew_times[server] = times
            self.by_server[server] = {
                "fetch_to_renew_max_s": max(
                    (r - f for f, r in zip(fetched, first) if r is not None),
                    default=0.0),
                "renew_gap_max_s": max(gaps, default=0.0),
                "renewals": sum(n for _, n in rs),
                "lost": lost.get(server, 0)}


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
