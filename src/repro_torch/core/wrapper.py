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
checkpoint directory and saves into it (`_train_loop`).  The fleet serve
loop (``dispatch``) is ROADMAP.md Queue 1 item 5.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from repro_torch.ckpt import checkpoint as ck
from repro_torch.core.arena import SharedArena
from repro_torch.core.images import sync
from repro_torch.core.proctable import PAYLOAD_UID, ProcessTable
from repro_torch.data.synthetic import to_device
from repro_torch.launch.steps import load_train_state, state_tree
from repro_torch.serving.graph import DEVICE_LOCK


@dataclasses.dataclass(frozen=True)
class PayloadCapability:
    """What user code gets after the privilege drop: its uid and the shared
    volume path.  No pilot token, no private volume, no pod patch rights."""
    uid: int
    shared_dir: str


def run_wrapper(arena: SharedArena, proctable: ProcessTable, exe, spec: dict):
    """Execute one payload under the payload uid.  Never raises: every
    outcome becomes an exit code in the arena (the paper's relay)."""
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
            exitcode = _serve_loop(exe, seed, n_steps, entry, proctable,
                                   telemetry, spec)
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
    the slice, driven by the request ``trace`` in the startup spec: JSON
    dicts ``{"rid", "prompt": [ints], "max_new_tokens", "at_step"}``; a
    request is admitted once the engine has ticked ``at_step`` times
    (staggered arrivals).  A spec that names a fleet pool (``dispatch``)
    raises: fleet serve is ROADMAP.md Queue 1 item 5.

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
    if spec.get("dispatch"):
        raise NotImplementedError(
            "fleet serve (a startup spec naming 'dispatch') is ROADMAP.md "
            "Queue 1 item 5")
    with DEVICE_LOCK:
        params = exe.make_inputs(seed)
    kv_kw = {k: spec[k] for k in ("kv", "prefill", "prefill_chunk",
                                  "num_blocks", "block_size",
                                  "prefix_sharing", "spec", "spec_k",
                                  "mesh_shape", "role")
             if spec.get(k) is not None}
    eng = exe.fn(params, slots=spec.get("slots"),
                 max_len=spec.get("max_len"), **kv_kw)

    def on_tick(tick, dt):
        if entry.stop.is_set():
            return False                                # SIGTERM-by-pilot
        proctable.heartbeat(entry.pid, dt)
        telemetry["steps"] = tick
        telemetry["step_times"].append(dt)
        # live cache-pressure sample rides every heartbeat, so the pilot's
        # monitor sees KV pressure mid-run, not only at exit
        telemetry["serve_live"] = eng.kv_pressure()
        return True

    stats = eng.run_trace(spec.get("trace") or [], max_ticks=n_steps,
                          on_tick=on_tick)
    if entry.stop.is_set():
        return 143
    # cache pressure rides along: the pilot's heartbeat consumer sees how
    # hot the slot-sized claim is running and what the prefix cache saves
    telemetry["serve"] = {k: stats[k] for k in _SERVE_STAT_KEYS}
    telemetry["tokens"] = {str(r.rid): r.tokens for r in eng.done.values()}
    telemetry["engine"] = {k: stats[k] for k in _ENGINE_STAT_KEYS}
    idle = not (eng.queue or eng._live or eng._jobs)
    telemetry["engine"]["block_leaks"] = eng.block_leaks() if idle else None
    return 0


def _train_loop(exe, seed, n_steps, entry, proctable, telemetry,
                spec) -> int:
    """Train payload with checkpoint-based resume (fault tolerance): it
    restores ``ckpt_dir``'s latest step (``resumed_from``), runs steps
    ``latest..n_steps-1`` on the image's synthetic batches, heartbeats per
    step, saves every ``ckpt_every`` steps and at the end, and reports
    ``first_loss`` and ``last_loss``.  A stop from the pilot exits 143, a
    loss that is not finite 3.  Every device call holds the device lock;
    a save copies to the host under it and writes to disk outside it."""
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
                     "graph_warm_launches", "launches", "device")
