"""Where a decode step's time goes: host clock, device busy time, kernels.

    python -m repro_torch.launch.profile_serve [--arch smollm-360m] \
        [--steps 20] [--spec draft] [--kv dense] [--eager] \
        [--prefill chunked --prefill-chunk 128] [--admission]

Builds the engine ``serve_direct`` serves from (``launch.serve.build_engine``:
``--arch`` at full width, smollm-360m by default, granite-moe-3b-a800m or
mamba2-370m (on the dense layout, its only one), random weights from seed
0, 8 slots, max_len 1024, block 16, the hand-written kernels; paged or
dense KV, speculation off or self-draft; the decode step as its captured
CUDA graph, or eager with ``--eager``; one-shot or chunked admission),
fills every slot with a request (and, chunked, waits for every admission
to land), then times ``--steps`` engine steps twice: once on the host clock alone (each step ends in the engine's
one device->host copy, which waits for the device), and once under
``torch.profiler`` for the device time of every kernel.  Prints one JSON
object: host ms per step, device-busy ms per step, the device's idle share,
the device operations (kernels, copies, fills) per step, and the kernels
and host-side operators that take the most time.

``--admission`` times admissions instead (`profile_admission`): on an
idle engine of the same build, after `ServeEngine.warm_admission` (which
captures each bucket's and chunk length's graph on the graphed engine),
``--steps`` requests of ``prompt`` tokens are admitted one at a time into
slot 0, and each one-shot admission, or each chunk tick of a chunked one,
is timed on the host clock (ending in a device synchronize) and, in a
second pass, under ``torch.profiler`` for its device-busy time; the slot
is freed after each request, and no decode step runs.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch.serve import build_engine
from repro_torch.serving.engine import Request, admit_length


def _busy_ms(events) -> float:
    """Union of device-kernel intervals (ms): overlapping kernels count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3                                    # us -> ms


def profile(arch: str = "smollm-360m", steps: int = 20, slots: int = 8,
            max_len: int = 1024, prompt: int = 200, kv: str | None = None,
            spec: str = "off", eager: bool = False, prefill: str = "oneshot",
            prefill_chunk: int = 32, device="cuda") -> dict:
    cfg = get_config(arch)
    eng = build_engine(cfg, slots, max_len, kv=kv, spec=spec,
                       prefill=prefill, prefill_chunk=prefill_chunk,
                       step_graph=False if eager else None, device=device)
    dev = eng.device
    rng = np.random.default_rng(0)
    # ticks until every slot decodes: one per chunk of every admission
    admit_ticks = (slots * -(-admit_length(prompt, max_len)
                             // eng.prefill_chunk)
                   if eng.prefill_mode == "chunked" else 0)
    # every slot stays live through both timed passes, at up to k+1 tokens
    # a step with speculation
    budget = (2 * steps + 8 + admit_ticks) * (
        eng.spec_k + 1 if eng.spec == "draft" else 1)
    for rid in range(slots):
        eng.submit(Request(rid, rng.integers(0, cfg.vocab_size, size=prompt)
                           .astype(np.int32), max_new_tokens=budget))
    ticks = 0
    while ticks < 3 or eng.queue or eng._jobs:   # admissions + warm-up
        eng.step()
        ticks += 1
    t0 = time.monotonic()
    for _ in range(steps):
        eng.step()
    host_ms = (time.monotonic() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            eng.step()
    events = prof.events()
    busy = _busy_ms(events) / steps
    device_ops = sum(e.device_type == torch.autograd.DeviceType.CUDA
                     for e in events)
    by_kernel: dict[str, float] = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    top_kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    host_ops = sorted(
        ((a.key, a.self_cpu_time_total / 1e3, a.count)
         for a in prof.key_averages()), key=lambda r: -r[1])[:12]
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "arch": cfg.name,
        "kv": eng.kv,
        "spec": eng.spec,
        "step_graph": eng.step_graph,
        "decode_graph": eng._graph is not None,
        "spec_graph": eng._spec_graphs is not None,
        "prefill": eng.prefill_mode,
        "slots_live": sum(m.active for m in eng.slot_meta),
        "steps": steps,
        "tokens_per_step": eng.tokens_emitted / eng.steps,
        "host_ms_per_step": host_ms,
        "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1.0 - busy / host_ms),
        "device_ops_per_step": device_ops / steps,
        "top_kernels_ms_per_step": [(k, v / steps) for k, v in top_kernels],
        "top_host_ops_self_ms_per_step": [(k, v / steps, c // steps)
                                          for k, v, c in host_ops],
    }


def profile_admission(arch: str = "smollm-360m", reps: int = 5,
                      slots: int = 8, max_len: int = 1024, prompt: int = 1000,
                      kv: str | None = None, eager: bool = False,
                      prefill: str = "oneshot", prefill_chunk: int = 32,
                      device="cuda") -> dict:
    cfg = get_config(arch)
    eng = build_engine(cfg, slots, max_len, kv=kv, prefill=prefill,
                       prefill_chunk=prefill_chunk,
                       step_graph=False if eager else None, device=device)
    dev = eng.device
    eng.warm_admission()
    rng = np.random.default_rng(0)

    def admit(rid):
        """Each admission tick of one request (one for a one-shot
        admission, one a chunk for a chunked one), as callables."""
        eng.submit(Request(rid, rng.integers(0, cfg.vocab_size, size=prompt)
                           .astype(np.int32), max_new_tokens=1))
        eng._admit()
        yield
        while eng._jobs:
            eng._prefill_tick()
            yield

    def timed(rid) -> list:
        out = []
        t0 = time.monotonic()
        for _ in admit(rid):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.monotonic()
            out.append((t1 - t0) * 1e3)
            t0 = t1
        eng.cancel(rid)
        return out
    chunked = eng.prefill_mode == "chunked"
    host = [timed(rid) for rid in range(reps)]
    # a chunked admission's first tick only claims the slot and its blocks
    ticks = [t for h in host for t in (h[1:] if chunked else h)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        n = sum(len(timed(reps + rid)) - chunked for rid in range(reps))
    busy = _busy_ms(prof.events()) / n
    st = eng._stats(0, 0.0)
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "arch": cfg.name, "kv": eng.kv, "prefill": eng.prefill_mode,
        "chunk": eng.prefill_chunk if chunked else None,
        "prompt": prompt, "bucket": admit_length(prompt, max_len),
        "step_graph": eng.step_graph, "prefill_graph": st["prefill_graph"],
        "chunk_graph": st["chunk_graph"],
        "graph_pool_bytes": st["graph_pool_bytes"],
        "admissions": reps, "ticks_per_admission": len(ticks) // reps,
        "host_ms_per_tick": float(np.mean(ticks)),
        "host_ms_per_tick_max": max(ticks),
        "host_ms_per_admission": float(np.mean([sum(h) for h in host])),
        "device_busy_ms_per_tick": busy,
        "device_idle_share": max(0.0, 1.0 - busy / float(np.mean(ticks))),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--kv", choices=("paged", "dense"), default=None)
    ap.add_argument("--spec", choices=("off", "draft"), default="off")
    ap.add_argument("--eager", action="store_true",
                    help="every function eager (step_graph=False), not its "
                         "CUDA graph")
    ap.add_argument("--prefill", choices=("oneshot", "chunked"),
                    default="oneshot")
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--admission", action="store_true",
                    help="time admissions (one-shot, or each chunk tick) "
                         "instead of decode steps; --steps requests")
    ap.add_argument("--prompt", type=int, default=None,
                    help="prompt tokens (default 200; 1000 with "
                         "--admission)")
    args = ap.parse_args(argv)
    if args.admission:
        print(json.dumps(profile_admission(
            args.arch, args.steps, kv=args.kv, eager=args.eager,
            prefill=args.prefill, prefill_chunk=args.prefill_chunk,
            prompt=args.prompt or 1000)))
        return
    print(json.dumps(profile(args.arch, args.steps, kv=args.kv,
                             spec=args.spec, eager=args.eager,
                             prefill=args.prefill,
                             prefill_chunk=args.prefill_chunk,
                             prompt=args.prompt or 200)))


if __name__ == "__main__":
    main()
