"""A serve cell's run: one pilot late-binds the configuration's serve image
and serves a request pool that closed-loop clients fill.

Path: ``ClusterSim.spawn_fleet(1)`` -> ``Fleet.submit_servers`` -> the
pilot binds the image (``ExecutableRegistry.pull``) -> the payload wrapper's
``_fleet_serve_loop`` -> ``ServeEngine`` on the configuration's kernel
flags, its admissions and decode step replayed as CUDA graphs.  The
registry here is the program's own, except that the image's
``make_inputs`` hands over the weights this benchmark made from the seed.

Timeline: set-up (weights, bind, the engine's warm-ups, then ``warmup_s``
of the cell's own traffic so every slot is busy and the slots are
staggered); the window (``seconds``; with ``trace`` a profiled sub-window
of ``profile_s`` at its end); the drain (clients stop submitting, the
requests in flight finish, bounded by ``drain_s``; not timed).
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import torch

from perfbench import trace as trace_mod
from perfbench.generator import ClosedLoop
from perfbench.weights import make_weights


def log(t_process: float, what: str):
    """A stage of the run on standard error, with the seconds since the
    process started."""
    print(f"[perfbench] {time.monotonic() - t_process:9.3f} s  {what}",
          file=sys.stderr, flush=True)


def admit_length(prompt_len: int, max_len: int) -> int:
    """The admission bucket of a prompt: its power of two, at least 16, at
    most ``max_len - 1`` (the serve engine's rule, as its documentation
    states it)."""
    b = 16
    while b < prompt_len:
        b *= 2
    return min(b, max_len - 1)


PREPARED = 24          # request bodies made in set-up, per client


class Clients:
    """Closed-loop clients over one pool: each sends its next request when
    its last completes, until `stop`.  Completions arrive through the
    pool's ``on_complete`` hook, on the serving thread."""

    def __init__(self, pool, loop: ClosedLoop):
        self.pool = pool
        self.loop = loop
        self.submitted: dict[int, float] = {}       # rid -> submit stamp
        self._open = True
        self._ready: dict[int, dict] = {}
        self._lock = threading.Lock()
        pool.on_complete = self._completed

    def prepare(self, n: int):
        """Make the first ``n`` request bodies now, in set-up, so that a
        completion's next request costs the serving thread only its
        submit."""
        for i in range(n):
            self._ready[i] = self.loop.request(i)

    def start(self):
        for c in range(self.loop.clients):
            self._submit(c)

    def stop(self):
        with self._lock:
            self._open = False

    def _submit(self, rid: int):
        entry = self._ready.pop(rid, None) or self.loop.request(rid)
        with self._lock:
            if not self._open:
                return
            t = time.monotonic()
            entry["submitted_s"] = t
            self.submitted[rid] = t
        self.pool.submit(entry)

    def _completed(self, rec, handoff):
        self._submit(self.loop.next_of(rec.rid))


def delivered(pool) -> int:
    """Tokens the pool has seen delivered: every completed request's tokens
    plus the renewed progress of those still leased."""
    return sum(len(r.tokens) if r.tokens is not None else r.progress
               for r in pool.records().values())


def progress(pool) -> dict[int, int]:
    return {rid: (len(r.tokens) if r.tokens is not None else r.progress)
            for rid, r in pool.records().items()}


def run(c: dict, mix: dict, seed: int, seconds: float, traced: bool,
        device, t_process: float, smoke: bool = False) -> dict:
    """Run the cell; returns the run's record (see ``run.py``)."""
    from repro_torch.core import ClusterSim, PayloadImage, PilotConfig
    from repro_torch.core.images import ExecutableRegistry
    from repro_torch.models.transformer import LMParams
    from repro_torch.serving.dispatch import FleetDispatcher
    from repro_torch.serving.graph import DEVICE_LOCK

    serve = c["serve"]
    slots, max_len = serve["slots"], serve["max_len"]
    tree = make_weights(c, seed, device)
    params = LMParams(tree)
    log(t_process, "weights made")

    class Registry(ExecutableRegistry):
        """The program's registry; a pulled image's inputs are the
        benchmark's weights."""

        def _build(self, image, dev, mesh=None):
            exe = super()._build(image, dev, mesh)
            exe.make_inputs = lambda _seed: params
            return exe

    image = PayloadImage(arch=c["arch"], shape=f"custom:{max_len}x{slots}",
                         mode="serve", smoke=smoke,
                         flags=tuple(sorted(c["flags"].items())))
    sim = ClusterSim(registry=Registry(), device=device)
    pool = FleetDispatcher(lease_ttl=serve["lease_ttl_s"])
    fleet = sim.spawn_fleet(1, PilotConfig(max_payloads=1, idle_grace=1.0))
    pilot = fleet.members[0]
    loop = ClosedLoop(mix, seed, c["vocab_size"])
    clients = Clients(pool, loop)
    out: dict = {"kind": "serve"}
    try:
        tids = fleet.submit_servers(image, pool.name, n=1, max_wall=3600.0,
                                    spec={"slots": slots, "max_len": max_len})
        clients.prepare(PREPARED * loop.clients)
        while not pool.wait_servers(1, timeout=0.5):
            ended = sim.repo.result(tids[0])
            if ended is not None or pilot.done():
                raise RuntimeError(f"the server ended before it came up: "
                                   f"{ended}, pilot {pilot.state}, "
                                   f"{pilot.error}, {pilot.history}")
        t_ready = time.monotonic()
        log(t_process, "server ready")
        if traced:
            # the first profiler session of a process sets up the device
            # tracing, which takes seconds: not inside the window
            with DEVICE_LOCK, trace_mod.profiler():
                pass
            log(t_process, "profiler set up")
        clients.start()
        time.sleep(mix["warmup_s"])
        t0 = time.monotonic()
        d0, s0, w0 = delivered(pool), pool.stats(), progress(pool)
        log(t_process, "window opens")
        prof_rec = None
        if traced:
            # the profiled sub-window closes the window: stopping the
            # profiler holds the host for seconds (past the lease TTL),
            # which then falls after the window
            time.sleep(max(0.0, seconds - mix["profile_s"]))
            # the profiler starts and stops between the server's ticks,
            # under the program's device lock: switching device tracing on
            # or off while another thread replays graphs can hang
            prof = trace_mod.profiler()
            with DEVICE_LOCK:
                prof.__enter__()
            tp0, p0 = time.monotonic(), progress(pool)
            time.sleep(mix["profile_s"])
            tp1, p1 = time.monotonic(), progress(pool)
            t1 = tp1
            d1, s1, w1 = delivered(pool), pool.stats(), p1
            clients.stop()
            with DEVICE_LOCK:
                prof.__exit__(None, None, None)
            log(t_process, "profiler stopped")
        else:
            time.sleep(seconds)
            t1 = time.monotonic()
            d1, s1, w1 = delivered(pool), pool.stats(), progress(pool)
            clients.stop()
        log(t_process, "window closed")
        in_window = sorted(r for r, t in clients.submitted.items()
                           if t0 <= t < t1)
        deadline = time.monotonic() + mix["drain_s"]
        while time.monotonic() < deadline:
            recs = pool.records()
            if all(recs[r].tokens is not None or recs[r].failed
                   for r in clients.submitted):
                break
            time.sleep(0.05)
        out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                    if torch.cuda.is_available() else 0)
        log(t_process, "drained")
        if traced:
            prof_rec = trace_mod.summarize(prof, tp1 - tp0)
            log(t_process, f"trace read: {prof_rec['ops']} device operations")
            prof_rec.update({"t0": tp0, "t1": tp1, "progress0": p0,
                             "progress1": p1})
            del prof
    finally:
        clients.stop()
        pool.close()
        fleet.drain_all()
        fleet.join_all(120.0)
    log(t_process, "pilot ended")
    result = sim.repo.result(tids[0])
    telemetry = result.telemetry if result is not None else {}
    recs = pool.records()
    rows = []
    for rid, r in recs.items():
        plen_prompt = len(r.entry["prompt"])
        rows.append({
            "rid": rid, "prompt": plen_prompt,
            "plen": admit_length(plen_prompt, max_len),
            "expected": 1 + min(int(r.entry["max_new_tokens"]),
                                max_len - admit_length(plen_prompt, max_len)),
            "submitted": r.submitted_s, "first": r.first_token_s,
            "completed": r.completed_s,
            "tokens": None if r.tokens is None else len(r.tokens),
            "in_window": t0 <= r.submitted_s < t1})
    out.update({
        "t_process": t_process, "t_ready": t_ready, "t0": t0, "t1": t1,
        "pilot_started": pilot.t_started,
        "setup_s": t0 - t_process,
        "delivered": d1 - d0, "stats0": s0, "stats1": s1,
        "progress0": w0, "progress1": w1,
        "requests": rows, "in_window": in_window,
        "results": pool.results(), "entries": {rid: r.entry
                                               for rid, r in recs.items()},
        "pilot_history": list(pilot.history),
        "telemetry": telemetry, "profile": prof_rec,
        "slots": slots, "max_len": max_len,
        "tree": tree})
    del params
    return out


def sample(out: dict, seed: int, n: int) -> list[int]:
    """Requests to compare: ``n`` drawn from the seed among those submitted
    in the window and finished, and the longest of them (prompt bucket
    plus tokens) always."""
    done = [r for r in out["requests"] if r["in_window"]
            and r["tokens"] is not None]
    if not done:
        return []
    longest = max(done, key=lambda r: (r["plen"] + r["tokens"], r["rid"]))
    rest = sorted(r["rid"] for r in done if r["rid"] != longest["rid"])
    rng = np.random.default_rng([int(seed), 0xC0DE])
    pick = rng.choice(len(rest), size=min(n, len(rest)), replace=False)
    return [longest["rid"]] + sorted(rest[i] for i in pick)
