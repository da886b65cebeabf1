"""PayloadWrapper — the startup wrapper inside the payload container (§3.5).

Port of ``repro.core.wrapper``.  Responsibilities, mirroring the paper:

1. runs as fake-root inside the payload container: it may set up the
   environment and register processes, but it *drops privileges* before
   invoking user code — the user step loop only ever sees a
   :class:`PayloadCapability` with the payload uid and the shared arena
   path (never the pilot's private area or the pod-patch capability);
2. sources the payload environment from the shared volume;
3. runs the payload and relays its exit code + telemetry back through
   ``exitcode.json`` on the shared volume (there is no parent-child process
   relationship to propagate it through);
4. heartbeats per step so the pilot's monitor can meter progress and
   enforce limits at step boundaries.

The payload runs on the executor's container thread, on the Executable's
device (``exe.device``), never on whatever device that thread happens to
have current.  A prefetch may warm the next image on another thread
meanwhile: the wrapper holds `repro_torch.serving.graph.DEVICE_LOCK` over
each device call it makes (a serve engine holds it itself), one step at a
time, so the two interleave and neither sees the other's device work.
The seed stays an int: the image's ``make_inputs`` seeds a
``torch.Generator`` on that device.  A train payload resumes from its
checkpoint directory and saves into it (`_train_loop`).  A serve payload
whose startup spec names a fleet pool (``dispatch``) leases its requests
from that pool (`_fleet_serve_loop`); the fleet's servers are engines of
one process, each on its pilot's thread, and on one card they take turns
at the device lock.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ck
from repro_torch.core import chaos, spans
from repro_torch.core.arena import SharedArena
from repro_torch.core.images import sync
from repro_torch.core.proctable import PAYLOAD_UID, ProcessTable
from repro_torch.data.synthetic import to_device
from repro_torch.launch.steps import GRAPH_KEY, load_train_state, state_tree
from repro_torch.serving import dispatch as fleet_dispatch
from repro_torch.serving.engine import Request
from repro_torch.serving.graph import DEVICE_LOCK


@dataclasses.dataclass(frozen=True)
class PayloadCapability:
    """What user code gets after the privilege drop: its uid and the shared
    volume path.  No pilot token, no private volume, no pod patch rights."""
    uid: int
    shared_dir: str


# a serve payload's exit trace: ~100 s of a busy fleet server's spans on
# one card (~7 a tick), ~2 MB of JSON at most (the pool keeps every result)
TRACE_SPANS = 1 << 15


def run_wrapper(arena: SharedArena, proctable: ProcessTable, exe, spec: dict):
    """Execute one payload under the payload uid.  Never raises: every
    outcome becomes an exit code in the arena (the paper's relay).  A
    serve payload's telemetry carries ``trace``: the spans its thread
    recorded since its start (`repro_torch.core.spans.export`; a fleet
    server's leases are recorded in its own fetch), the newest
    `TRACE_SPANS` of them at most."""
    # env arrives inside the startup spec (the pilot path) or, for direct
    # arena users, in the standalone env file on the shared volume (§3.5)
    env = spec.get("env")
    if env is None:
        env = arena.read_env()
    entry = proctable.register(PAYLOAD_UID, f"payload:{exe.image.arch}:{exe.image.mode}")
    t_start = time.monotonic()
    telemetry: dict = {"steps": 0, "mode": exe.image.mode,
                       "arch": exe.image.arch, "step_times": []}
    exitcode = 0
    try:
        seed = int(env.get("seed", 0))
        n_steps = int(spec.get("n_steps", 1))
        if exe.image.mode == "noop":
            with DEVICE_LOCK:
                exe.fn(exe.make_inputs(seed))
            telemetry["steps"] = 1
        elif exe.image.mode == "train":
            exitcode = _train_loop(exe, seed, n_steps, entry, proctable,
                                   telemetry, spec)
        elif exe.image.mode == "prefill":
            with DEVICE_LOCK:
                params, batch = exe.make_inputs(seed)
            t0 = time.monotonic()
            with DEVICE_LOCK:
                logits, cache = exe.fn(params, batch)
                sync(exe.device)
                finite = bool(torch.isfinite(logits).all().item())
            dt = time.monotonic() - t0
            proctable.heartbeat(entry.pid, dt)
            telemetry["steps"] = 1
            telemetry["step_times"].append(dt)
            if not finite:
                exitcode = 3
        elif exe.image.mode == "serve":
            spans.reset_thread()
            try:
                exitcode = _serve_loop(exe, seed, n_steps, entry, proctable,
                                       telemetry, spec)
            finally:
                if spans.enabled:
                    telemetry["trace"] = spans.export(
                        round(t_start * 1e9), thread=spans.thread_index(),
                        limit=TRACE_SPANS)
        else:                                           # decode
            with DEVICE_LOCK:
                params, state = exe.make_inputs(seed)
            for i in range(n_steps):
                if entry.stop.is_set():
                    exitcode = 143                      # SIGTERM-by-pilot
                    break
                t0 = time.monotonic()
                with DEVICE_LOCK:
                    logits, state = exe.fn(params, state)
                    sync(exe.device)
                dt = time.monotonic() - t0
                proctable.heartbeat(entry.pid, dt)
                telemetry["steps"] = i + 1
                telemetry["step_times"].append(dt)
            # the port's own: the steps replayed the state's captured graph
            telemetry["step_graph"] = GRAPH_KEY in state
    except Exception as e:                               # noqa: BLE001
        exitcode = 1
        telemetry["error"] = f"{type(e).__name__}: {e}"
    telemetry["wall"] = time.monotonic() - t_start
    telemetry["step_times"] = telemetry["step_times"][-16:]
    proctable.mark_exited(entry.pid, exitcode)
    arena.report_exit(exitcode, telemetry)
    return exitcode


def _serve_loop(exe, seed, n_steps, entry, proctable, telemetry, spec) -> int:
    """Serve payload: a continuous-batching inference server late-bound onto
    the slice.

    Two request sources, selected by the startup spec:

    * ``trace`` — the single-engine path: JSON dicts ``{"rid", "prompt":
      [ints], "max_new_tokens", "at_step"}``; a request is admitted once the
      engine has ticked ``at_step`` times (staggered arrivals).
    * ``dispatch`` — the FLEET path: the spec names a
      :class:`~repro_torch.serving.dispatch.FleetDispatcher` pool and the
      server leases requests out of it instead of owning a static trace;
      per-request progress piggybacks on lease renewal every tick, so a
      server that dies simply stops renewing and its in-flight requests
      requeue onto survivors (see ``_fleet_serve_loop``).

    ``n_steps`` bounds the tick count — the lease/budget contract serve
    shares with train.  The engine's decode loop is device-resident (one
    device→host transfer per step); each tick heartbeats the proctable so
    the pilot's monitor meters serve progress exactly as it meters train
    steps.  Besides the reference's telemetry, ``engine`` holds the port's
    own stats of the run (`_ENGINE_STAT_KEYS`): the gap between ticks, the
    kernel launches of this payload's engine (counted under the device
    lock, so a prefetch's warm-up on another thread is not among them) and,
    when the trace ran out, the engine's leaked KV blocks.
    """
    with DEVICE_LOCK:
        params = exe.make_inputs(seed)
    kv_kw = {k: spec[k] for k in ("kv", "prefill", "prefill_chunk",
                                  "num_blocks", "block_size",
                                  "prefix_sharing", "spec", "spec_k",
                                  "mesh_shape", "role")
             if spec.get(k) is not None}
    eng = exe.fn(params, slots=spec.get("slots"),
                 max_len=spec.get("max_len"), **kv_kw)
    if spec.get("dispatch"):
        try:
            return _fleet_serve_loop(eng, spec, n_steps, entry, proctable,
                                     telemetry)
        finally:
            # a fleet's servers come and go while others capture their
            # step graphs: this one's graph and pools go under the lock
            with DEVICE_LOCK:
                del eng

    def on_tick(tick, dt):
        if entry.stop.is_set():
            return False                                # SIGTERM-by-pilot
        proctable.heartbeat(entry.pid, dt)
        telemetry["steps"] = tick
        telemetry["step_times"].append(dt)
        return True

    stats = eng.run_trace(spec.get("trace") or [], max_ticks=n_steps,
                          on_tick=on_tick)
    if entry.stop.is_set():
        return 143
    # the serve stats carry cache pressure: how hot the slot-sized claim
    # ran and what the prefix cache saved
    telemetry["serve"] = {k: stats[k] for k in _SERVE_STAT_KEYS}
    telemetry["tokens"] = {str(r.rid): r.tokens for r in eng.done.values()}
    telemetry["engine"] = {k: stats[k] for k in _ENGINE_STAT_KEYS}
    idle = not (eng.queue or eng._live or eng._jobs)
    telemetry["engine"]["block_leaks"] = eng.block_leaks() if idle else None
    return 0


def _fleet_serve_loop(eng, spec, n_steps, entry, proctable, telemetry) -> int:
    """Fleet serve: lease requests from the pool named in the startup spec
    instead of replaying a static trace.

    Per tick: top up free slots from the pool (the fetch parks on the pool
    condition when the engine is idle, so a requeued request wakes the
    server immediately), one engine step, report completions (first
    completion wins at the pool), then renew every in-flight lease with its
    progress.  A renewal the pool refuses means the lease expired and moved
    elsewhere — the slot is cancelled rather than racing a replay it cannot
    win.

    Death semantics: when the stop event fires (node loss / SIGTERM) the
    loop returns WITHOUT releasing anything — a dead server cannot clean up,
    and the pool's lease-expiry reaper requeueing its in-flight requests is
    exactly the failure path this payload exists to exercise.  A graceful
    end (tick budget, pool closed, or the pilot's DRAIN event — the
    autoscaler's scale-down path) hands unfinished requests straight back
    instead: survivors requeue them immediately, no lease-TTL wait.

    Each tick also reports the engine's KV-pressure sample to the pool
    (``report_telemetry``), which the autoscaler reads via
    ``pool_pressure`` — kv_memory_utilization / blocked_admissions are
    scale-up signals a queue-depth-only policy would miss.

    Each iteration is a ``fleet.tick`` span (`repro_torch.core.spans`;
    its ``attr`` 1 when the engine held work, 0 for an idle poll) over
    its host phases ``fleet.fetch``, ``fleet.complete``, ``fleet.renew``
    (the leases renewed, the server's tag) and ``fleet.report``, with the
    engine's ``engine.step`` between the first two (``fleet.complete``
    starts at its end stamp, whose two stamps also give the heartbeat's
    step time); ``fleet.announce`` marks the announce and ``fleet.lost``
    each renewal the pool refused.

    Every device call is the engine's own and holds the device lock (its
    step, warm-ups and cancels), so on one card a server renews its leases
    only between its turns at the lock: a tick's wait for another server's
    device work (a joiner's graph capture and warm-ups) is part of its
    gap between renewals.  Unlike the reference's loop, a tick with no
    request in the engine is not metered as a step (the pilot's straggler
    monitor compares step times).  Besides the reference's telemetry,
    ``engine``
    holds the port's own stats of the run (`_ENGINE_STAT_KEYS`, zeroed by
    `ServeEngine.warm_install`, so they describe live traffic) and the
    engine's leaked KV blocks."""
    pool = fleet_dispatch.get_pool(spec["dispatch"])
    if pool is None:
        raise RuntimeError(f"fleet pool {spec['dispatch']!r} is not "
                           f"registered in this process")
    server_id = ((spec.get("env") or {}).get("pilot")
                 or f"server-{spec.get('task_id', id(eng))}")
    labels = spec.get("server_labels") or {}
    # stage every admission bucket AND the whole admit/decode/evict install
    # path before taking the first lease: a first-use cost mid-serve stalls
    # renewals past the lease TTL and thrashes requests between servers
    eng.warm_admission()
    eng.warm_install()
    # labels carry the server's pool role ({"pool": "prefill"|"decode"}) so
    # pool_pressure() can report per-label telemetry instead of blending
    # prefill TTFT with decode TPOT across a mixed fleet
    pool.announce(server_id, labels=labels)
    tag = spans.intern(server_id)
    if spans.enabled:
        spans.event(spans.FLEET_ANNOUNCE, time.monotonic_ns(), tag=tag)
    inflight: dict[int, Request] = {}
    fetched = completed_here = released = 0
    decoded = tick = 0
    t_start = time.monotonic()

    def renew(on: bool) -> list[int]:
        t0 = time.monotonic_ns() if on else 0
        progress = {rid: len(r.tokens) for rid, r in inflight.items()}
        lost = pool.renew(server_id, progress) if progress else []
        if on:
            t1 = time.monotonic_ns()
            spans.record(spans.FLEET_RENEW, t0, t1, attr=len(progress),
                         tag=tag)
            for rid in lost:
                spans.event(spans.FLEET_LOST, t1, rid=rid, tag=tag)
        return lost

    while tick < n_steps:
        on = spans.enabled
        t_tick = time.monotonic_ns() if on else 0
        sid = spans.begin(spans.FLEET_TICK, t_tick) if on else -1
        busy = False
        try:
            if entry.stop.is_set():
                return 143               # died mid-serve: leases just expire
            if pool.closed.is_set():
                break
            if entry.drain.is_set():
                break    # scale-down: wind down NOW — leased work is
                         # released below, not left to wait out its TTL
            # chaos drills (no-op dict probe when no controller is
            # installed): a STALLED payload freezes — no fetch, no step, no
            # completions — but its lease renewals keep flowing with frozen
            # progress, which is exactly the gray failure only the progress
            # watchdog can see
            site = chaos.site(server_id)
            stalled = site is not None and site.stalled()
            cut = site is not None and site.partitioned()
            if stalled:
                if inflight:
                    renew(on)
                time.sleep(0.005)
                tick += 1
                continue
            fid = spans.begin(spans.FLEET_FETCH, t_tick) if on else -1
            # _live already counts mid-admission (_jobs) requests, so this
            # is every admitted-or-queued request exactly once
            want = eng.slots - (len(eng._live) + len(eng.queue))
            if want > 0 and not cut and not pool.finished():
                idle = (not any(m.active for m in eng.slot_meta)
                        and not eng._jobs)
                for e in pool.fetch(server_id, max_n=want,
                                    timeout=0.05 if idle else 0.0,
                                    labels=labels, cancel=entry.stop.is_set):
                    if (site is not None and e.get("poison")
                            and site.poison_lethal()):
                        # poison request: detonates on fetch, killing this
                        # pilot — the lease is never released; it expires
                        # and the pool's blast-radius accounting takes over
                        site.trip_poison(int(e["rid"]))
                        return 143
                    req = Request(
                        rid=int(e["rid"]),
                        prompt=np.asarray(e["prompt"], np.int32),
                        max_new_tokens=int(e.get("max_new_tokens", 16)),
                        submitted=float(e.get("submitted_s",
                                              time.monotonic())),
                        handoff=e.get("handoff"))
                    if req.rid in inflight:
                        # the pool re-leased a rid this server still holds
                        # locally: its lease expired mid-partition and
                        # looped back before this tick's renew could reveal
                        # the loss.  Purge the stale copy — pairing the
                        # fresh Request with the old engine result would
                        # commit truncated tokens (and two live slots under
                        # one rid is worse)
                        eng.cancel(req.rid)
                        inflight.pop(req.rid, None)
                    eng.done.pop(req.rid, None)  # stale result, lost lease
                    try:
                        eng.submit(req)
                    except ValueError:
                        pool.reject(server_id, req.rid)  # can NEVER fit here
                        continue
                    inflight[req.rid] = req
                    fetched += 1
            busy = bool(eng._live or eng.queue or eng._jobs)
            if on:
                spans.end(fid, time.monotonic_ns())
            decoded += eng.step()
            # the completions' phase starts where the step's span ends (it
            # holds the device lock's release and the heartbeat)
            t_s, t_c = eng.last_step_ns
            dt = (t_c - t_s) / 1e9
            if site is not None:
                slow = site.slow_factor()
                if slow > 1.0:           # straggler: inflate the step time
                    time.sleep(dt * (slow - 1.0))
                    dt = dt * slow
            tick += 1
            if busy:
                # an idle poll is no step: metered, its ~0.1 ms would sit in
                # the monitor's straggler EWMA and the fleet median beside
                # the serving ticks, and a server whose traffic resumes
                # after a quiet spell was killed as a straggler of its own
                # idle ticks
                proctable.heartbeat(entry.pid, dt)
                telemetry["step_times"].append(dt)
            telemetry["steps"] = tick
            if cut:
                # control-plane partition: the payload keeps computing but
                # renewals, completions and telemetry cannot reach the
                # pool.  Leases expire and the work replays elsewhere;
                # completions parked in eng.done are reported after the
                # partition heals (first completion wins keeps it exactly
                # once either way).
                if pool.finished() and not inflight:
                    break
                continue
            for rid in [r for r in inflight if r in eng.done]:
                req = inflight.pop(rid)
                # a unified or decode-role engine completes with
                # handoff=None; a prefill-role engine's export rides here
                # into the decode pool (a decode server's requeued entry
                # carries the same handoff back, so a replay imports it
                # again: no re-prefill)
                if pool.complete(server_id, rid, req.tokens,
                                 first_token_s=req.first_token_s,
                                 handoff=req.handoff):
                    completed_here += 1
            if on:
                spans.record(spans.FLEET_COMPLETE, t_c, time.monotonic_ns())
            for rid in renew(on):
                eng.cancel(rid)          # re-leased elsewhere: free the slot
                inflight.pop(rid, None)
            t_r = time.monotonic_ns() if on else 0
            # the engine's cache pressure and free slots go to the pool,
            # where the autoscaler reads them as a demand signal
            if not (site is not None and site.drop_heartbeat()):
                pool.report_telemetry(server_id, {
                    **eng.kv_pressure(),
                    "blocked_admissions": eng.blocked_admissions,
                    "free_slots": eng.slots - (len(eng._live)
                                               + len(eng.queue)),
                })
            if on:
                spans.record(spans.FLEET_REPORT, t_r, time.monotonic_ns())
            if pool.finished() and not inflight:
                break
        finally:
            if on:
                spans.end(sid, time.monotonic_ns(), attr=int(busy))
    if inflight:                         # graceful end with work leased:
        drained = eng.drain_requests()   # give it back, don't sit on it
        pool.release(server_id, [r.rid for r in drained])
        released = len(drained)
        inflight.clear()
    pool.retire(server_id)               # gone capacity must not look live
    stats = eng._stats(decoded, time.monotonic() - t_start)
    leaked = eng.block_leaks()
    telemetry["serve"] = {k: stats[k] for k in _SERVE_STAT_KEYS}
    telemetry["serve"]["fleet"] = {
        "server_id": server_id, "pool": pool.name, "fetched": fetched,
        "completed_here": completed_here, "released": released,
        "drained": entry.drain.is_set(),
        # leak audit on the now-idle engine: every cancel/hedge-loser/
        # revocation path must have returned its KV blocks to the pool
        "leaked_blocks": leaked}
    telemetry["tokens"] = {str(r.rid): r.tokens for r in eng.done.values()}
    telemetry["engine"] = {k: stats[k] for k in _ENGINE_STAT_KEYS}
    telemetry["engine"]["block_leaks"] = leaked
    return 0


def _train_loop(exe, seed, n_steps, entry, proctable, telemetry,
                spec) -> int:
    """Train payload with checkpoint-based resume (fault tolerance): it
    restores ``ckpt_dir``'s latest step (``resumed_from``), runs steps
    ``latest..n_steps-1`` on the image's synthetic batches, heartbeats per
    step, saves every ``ckpt_every`` steps and at the end, and reports
    ``first_loss`` and ``last_loss``.  A stop from the pilot exits 143, a
    loss that is not finite 3.  Every device call holds the device lock;
    a save copies to the host under it and writes to disk outside it.  On
    the card the step replays the state's CUDA graph from its second call
    (the image's ``fn``, `repro_torch.launch.steps.make_train_step`); a
    restore copies into the state in place, so a graph replays it, and
    the graph goes with the state when the payload ends.  The port's
    telemetry adds ``step_graph`` after each step: whether the state holds
    a graph (so a stopped payload reports it too)."""
    with DEVICE_LOCK:
        state, data = exe.make_inputs(seed)
    start_step = 0
    ckpt_dir = spec.get("ckpt_dir")
    ckpt_every = int(spec.get("ckpt_every", 0))
    if ckpt_dir:
        latest = ck.latest_step(ckpt_dir)
        if latest is not None:
            with DEVICE_LOCK:
                load_train_state(state, ck.restore(ckpt_dir, latest,
                                                   state_tree(state)))
            start_step = latest
            telemetry["resumed_from"] = latest

    def save(step):
        with DEVICE_LOCK:
            snap = ck.snapshot(state_tree(state))
        ck.save(ckpt_dir, step, snap)

    losses = []
    for i in range(start_step, n_steps):
        if entry.stop.is_set():
            return 143                                  # SIGTERM-by-pilot
        t0 = time.monotonic()
        batch = data.batch_at(i)
        with DEVICE_LOCK:
            state, metrics = exe.fn(state, to_device(batch, exe.device))
            loss = float(metrics["loss"])
        dt = time.monotonic() - t0
        proctable.heartbeat(entry.pid, dt)
        telemetry["steps"] = i + 1 - start_step
        telemetry["step_times"].append(dt)
        telemetry["step_graph"] = GRAPH_KEY in state
        losses.append(loss)
        if not math.isfinite(loss):
            return 3
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            save(i + 1)
    telemetry["first_loss"] = losses[0] if losses else None
    telemetry["last_loss"] = losses[-1] if losses else None
    if ckpt_dir and losses:
        save(n_steps)
    return 0


_SERVE_STAT_KEYS = (
    "completed", "decode_steps", "tokens_decoded", "slot_utilization",
    "idle_slot_steps", "d2h_transfers", "tok_per_s",
    "ttft_p50_s", "ttft_p99_s",
    "kv", "kv_memory_utilization", "kv_peak_live_tokens",
    "kv_capacity_tokens", "prefix_hit_rate", "prefill_chunks",
    "blocked_admissions",
    "spec", "spec_fallback_reason", "acceptance_rate", "tokens_per_step",
    "draft_overhead_s",
    "mesh_shape", "mesh_devices", "slots",
    "kv_pool_bytes", "kv_pool_bytes_per_device",
    "role", "prefills_exported", "handoffs_imported")

_ENGINE_STAT_KEYS = ("itl_p50_s", "itl_p99_s", "itl_max_s", "step_graph",
                     "decode_graph", "spec_graph", "prefill_graph",
                     "draft_prefill_graph", "chunk_graph", "graph_pool_bytes",
                     "graph_warm_launches", "launches", "device",
                     "handoff_export_ms", "handoff_import_ms",
                     "handoff_bytes")
