"""Deterministic schedule fuzzer: seeded preemption at lock boundaries.

Race bugs hide in interleavings the test suite never hits.  The fuzzer
widens the explored schedule space *reproducibly*: a
:class:`ScheduleFuzzer` plugs into the lock auditor's ``preempt`` hook,
and at every tracked acquire/release/wait boundary each thread consults
its own seeded RNG — ``Random(seed ^ crc32(thread_name))`` — to decide
whether to yield (a tiny sleep, plus a lowered ``sys.setswitchinterval``
to amplify contention).  The per-thread *decision sequence* is a pure
function of ``(seed, thread name, boundary index)``, so a failing seed
replays the same injected-preemption schedule; the OS still owns actual
thread placement, so this is deterministic *injection*, not a
deterministic scheduler — in practice a failing seed reproduces because
the injected yields dominate the interleaving.

The driven workload is the six-server stress race
(:func:`six_server_stress`): N requests raced by six server threads that
randomly complete, release, die silently (lease expiry + replay), or
hold-and-renew, under an aggressive hedging watchdog — now with a
:class:`~repro_torch.serving.blockpool.BlockAllocator` churn per held request
so "zero block leaks" is an asserted invariant, not a vacuous one.
Every seed asserts:

- exactly-once settlement (every rid completed once, zero failed,
  accepted-counts all exactly 1, token streams correct);
- zero stranded leases (repo queued == leased == 0, no lease holders);
- zero block leaks (the allocator is fully free at the end);
- zero lock-order cycles and zero auditor violations.

CLI::

    python -m repro_torch.analysis.fuzz --seeds 10          # the soak gate
    python -m repro_torch.analysis.fuzz --seeds 3 --requests 24   # CI smoke
    python -m repro_torch.analysis.fuzz --seeds 1 --table   # lock-order table
"""

from __future__ import annotations

import random
import sys
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

from repro_torch.analysis.locks import LockAuditor, make_lock

__all__ = ["ScheduleFuzzer", "six_server_stress", "run_soak", "main"]


class ScheduleFuzzer:
    """Seeded preemption injector for the lock auditor's ``preempt`` hook.

    ``decisions`` maps thread name -> the 0/1 preemption choices made at
    each of that thread's lock boundaries, in order — the reproducibility
    witness (same seed => identical per-thread decision sequences).
    """

    def __init__(self, seed: int, *, p_preempt: float = 0.15,
                 sleep_s: float = 0.0003):
        self.seed = int(seed)
        self.p_preempt = p_preempt
        self.sleep_s = sleep_s
        self.preemptions = 0
        self.boundaries = 0
        self._tl = threading.local()
        self._mu = threading.Lock()  # lint: allow[bare-lock] -- the fuzzer feeds the auditor's preempt hook; a tracked lock here would recurse into instrumentation
        self.decisions: Dict[str, List[int]] = {}

    def _state(self):
        st = getattr(self._tl, "state", None)
        if st is None:
            name = threading.current_thread().name
            rng = random.Random(
                (self.seed << 17) ^ zlib.crc32(name.encode()))
            with self._mu:
                trace = self.decisions.setdefault(name, [])
            st = self._tl.state = (rng, trace)
        return st

    def preempt(self, point: str, lock: Any) -> None:
        rng, trace = self._state()
        hit = rng.random() < self.p_preempt
        trace.append(1 if hit else 0)
        self.boundaries += 1        # benign race: approximate counters
        if hit:
            self.preemptions += 1
            if self.sleep_s > 0:
                time.sleep(self.sleep_s)

    def auditor(self) -> LockAuditor:
        return LockAuditor(preempt=self.preempt)


def six_server_stress(seed: int, *, n_requests: int = 40,
                      n_servers: int = 6, p_preempt: float = 0.15,
                      sleep_s: float = 0.0003,
                      timeout: float = 120.0) -> Dict[str, Any]:
    """One fuzzed run of the six-server stress race.  Raises
    AssertionError (with the full auditor report) on any invariant
    violation; returns a summary dict on success."""
    # imported here, not at module top: analysis.locks must stay
    # importable from every core module without dragging in serving
    from repro_torch.core.taskrepo import BackoffPolicy
    from repro_torch.serving.blockpool import BlockAllocator
    from repro_torch.serving.dispatch import FleetDispatcher, RobustnessPolicy

    fz = ScheduleFuzzer(seed, p_preempt=p_preempt, sleep_s=sleep_s)
    aud = fz.auditor()
    pol = RobustnessPolicy(
        stall_deadline=0.0, sick_cooldown=0.0,
        hedging=True, hedge_percentile=50.0, hedge_factor=3.0,
        hedge_min_s=0.15, hedge_min_samples=4, max_hedges=2,
        watchdog_interval=0.02, quarantine_after=0,
        backoff=BackoffPolicy(base=0.01, cap=0.1))
    alloc = BlockAllocator(num_blocks=1 + 4 * n_requests, block_size=16)
    accepted: Dict[int, int] = {}
    acc_lock = make_lock("fuzz.accounting")

    def tokens_for(rid: int) -> List[int]:
        return [rid, rid + 1, rid + 2]

    old_si = sys.getswitchinterval()
    t0 = time.monotonic()
    aud.install()
    pool = None
    try:
        sys.setswitchinterval(1e-4)
        pool = FleetDispatcher(name=f"fuzz-pool-{seed}", lease_ttl=0.12,
                               max_attempts=64, policy=pol)

        def server(name: str, srv_seed: int):
            rng = random.Random(srv_seed)
            held: Dict[int, List[int]] = {}   # rid -> leased KV blocks

            def free_blocks(rid: int):
                for bid in held.pop(rid, []):
                    alloc.free(bid)

            while not pool.finished():
                got = pool.fetch(name, max_n=2, timeout=0.05)
                for e in got:
                    held[e["rid"]] = [alloc.alloc() for _ in range(2)]
                if not got:
                    continue
                for e in got:
                    rid = e["rid"]
                    roll = rng.random()
                    if roll < 0.45:
                        ok = pool.complete(
                            name, rid, tokens_for(rid),
                            first_token_s=0.01)
                        free_blocks(rid)
                        if ok:
                            with acc_lock:
                                accepted[rid] = accepted.get(rid, 0) + 1
                    elif roll < 0.65:
                        pool.release(name, [rid])
                        free_blocks(rid)
                    elif roll < 0.8:
                        # silent death: never release the lease — the
                        # reaper requeues it.  The pilot's device blocks
                        # die with it, so the harness frees them here.
                        free_blocks(rid)
                    else:
                        # slow holder: renew a few times, then finish
                        for _ in range(rng.randint(1, 3)):
                            time.sleep(0.02)
                            lost = pool.renew(name, {rid: 1})
                            if rid in lost:
                                break
                        else:
                            ok = pool.complete(
                                name, rid, tokens_for(rid),
                                first_token_s=0.05)
                            if ok:
                                with acc_lock:
                                    accepted[rid] = accepted.get(rid, 0) + 1
                        free_blocks(rid)
            for rid in list(held):
                free_blocks(rid)

        for rid in range(n_requests):
            pool.submit({"rid": rid, "prompt": [1, 2, 3],
                         "max_new_tokens": 3})
        pool.seal()
        threads = [
            threading.Thread(target=server,
                             args=(f"fuzz-server-{i}", (seed << 8) + i),
                             name=f"fuzz-server-{i}", daemon=True)
            for i in range(n_servers)
        ]
        for t in threads:
            t.start()
        settled = pool.wait_all(timeout)
        for t in threads:
            t.join(timeout=10.0)

        errors: List[str] = []
        st = pool.stats()
        if not settled:
            errors.append(f"wait_all timed out after {timeout}s: {st}")
        if st["completed"] != n_requests:
            errors.append(
                f"completed {st['completed']} != {n_requests} submitted")
        if st["failed"] != 0:
            errors.append(f"{st['failed']} requests settled failed")
        multi = {r: n for r, n in accepted.items() if n != 1}
        if multi:
            errors.append(f"non-exactly-once acceptance: {multi}")
        results = pool.results()
        bad = [r for r, toks in results.items() if toks != tokens_for(r)]
        if bad:
            errors.append(f"wrong tokens for rids {bad}")
        rs = pool.repo.stats()
        if rs["queued"] != 0 or rs["leased"] != 0:
            errors.append(
                f"stranded repo state: queued={rs['queued']} "
                f"leased={rs['leased']}")
        holders = pool.lease_holders()
        if holders:
            errors.append(f"stranded lease holders: {holders}")
        if alloc.allocated_blocks != 0:
            errors.append(
                f"block leak: {alloc.allocated_blocks} blocks still "
                f"allocated of {alloc.capacity_blocks}")
        rep = aud.report()
        if rep["cycles"]:
            errors.append(f"{len(rep['cycles'])} lock-order cycle(s)")
        if rep["violations"]:
            errors.append(f"{len(rep['violations'])} auditor violation(s)")
        if errors:
            raise AssertionError(
                f"seed {seed}: " + "; ".join(errors) + "\n"
                + aud.format_report(rep))
        return {
            "seed": seed,
            "completed": st["completed"],
            "replays": st["replays"],
            "hedges": st["hedges"],
            "duplicates": st["duplicates"],
            "lost_leases": st["lost_leases"],
            "boundaries": fz.boundaries,
            "preemptions": fz.preemptions,
            "lock_acquisitions": aud.acquired_total,
            "order_edges": rep["n_edges"],
            "table": rep["table"],
            "wall_s": time.monotonic() - t0,
        }
    finally:
        sys.setswitchinterval(old_si)
        if pool is not None:
            pool.close()
        aud.uninstall()


def run_soak(seeds: List[int], **kw: Any) -> List[Dict[str, Any]]:
    """Run the stress race under every seed; raises on the first failure."""
    return [six_server_stress(s, **kw) for s in seeds]


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.fuzz",
        description="deterministic schedule fuzzer (six-server stress race)")
    ap.add_argument("--seeds", default="10",
                    help="seed count N (runs 0..N-1) or comma list")
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--servers", type=int, default=6)
    ap.add_argument("--p-preempt", type=float, default=0.15)
    ap.add_argument("--table", action="store_true",
                    help="print the observed lock-hierarchy table")
    args = ap.parse_args(argv)

    if "," in args.seeds:
        seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
    else:
        seeds = list(range(int(args.seeds)))

    table: Dict[str, List[str]] = {}
    for s in seeds:
        r = six_server_stress(s, n_requests=args.requests,
                              n_servers=args.servers,
                              p_preempt=args.p_preempt)
        for src, dsts in r["table"].items():
            table.setdefault(src, [])
            table[src] = sorted(set(table[src]) | set(dsts))
        print(f"seed {r['seed']:>3}: completed={r['completed']} "
              f"replays={r['replays']} hedges={r['hedges']} "
              f"duplicates={r['duplicates']} "
              f"preempts={r['preemptions']}/{r['boundaries']} "
              f"edges={r['order_edges']} wall={r['wall_s']:.1f}s")
    print(f"fuzz: {len(seeds)} seed(s) clean — exactly-once settlement, "
          f"zero stranded leases, zero block leaks, zero cycles")
    if args.table:
        print("observed lock order (held -> acquired):")
        for src, dsts in sorted(table.items()):
            print(f"  {src} -> {', '.join(dsts)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
