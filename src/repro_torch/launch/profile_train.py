"""Where a train step's time goes: host clock, device busy time, kernels.

    python -m repro_torch.launch.profile_train [--arch smollm-360m] \
        [--batch 8] [--seq 512] [--steps 5] [--eager]

Builds the train step ``train_direct`` runs (``launch.steps``: ``--arch``
at full width, random f32 weights from seed 0, AdamW, the synthetic data;
on the card a CUDA graph captured at the first step and replayed, or with
``--eager`` the step op by op), takes three warm-up steps (the first one
captures), then times ``--steps`` steps twice: once on the host clock
alone (each step ends in the loss's copy to the host, which waits for the
device), and once under ``torch.profiler`` for the device time of every
kernel.  Prints one JSON object: whether the step replayed a graph, the
first step's seconds (``capture_s``), host ms per step, device-busy ms per
step, the device's idle share, the device operations per step, the
kernels and the host-side operators that take the most time, the peak
memory and the graph's pool bytes.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM, to_device
from repro_torch.launch.profile_serve import _busy_ms
from repro_torch.launch.steps import (
    held_graph, init_train_state, make_train_step)
from repro_torch.models.api import resolve_device
from repro_torch.serving.graph import pool_bytes


def profile(arch: str = "smollm-360m", batch: int = 8, seq: int = 512,
            steps: int = 5, device="cuda", step_graph: bool = True) -> dict:
    dev = resolve_device(device)
    cfg = get_config(arch)
    step = make_train_step(cfg, step_graph=step_graph)
    state = init_train_state(cfg, 0, dev)
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, seq, batch))
    batches = [to_device(data.batch_at(i), dev) for i in range(2 * steps + 3)]
    t0 = time.monotonic()
    float(step(state, batches[0])[1]["loss"])
    capture_s = time.monotonic() - t0
    for b in batches[1:3]:
        float(step(state, b)[1]["loss"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    for b in batches[3:3 + steps]:
        float(step(state, b)[1]["loss"])
    host_ms = (time.monotonic() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for b in batches[3 + steps:]:
            float(step(state, b)[1]["loss"])
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    busy = _busy_ms(events) / steps
    by_kernel: dict[str, float] = {}
    for e in events:
        if e.device_type == cuda:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    graph = held_graph(state)
    top_kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    host_ops = sorted(
        ((a.key, a.self_cpu_time_total / 1e3, a.count)
         for a in prof.key_averages()), key=lambda r: -r[1])[:12]
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "arch": cfg.name, "batch": batch, "seq": seq, "steps": steps,
        "remat": cfg.remat, "step_graph": graph is not None,
        "capture_s": capture_s,
        "host_ms_per_step": host_ms,
        "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1.0 - busy / host_ms),
        "device_ops_per_step": sum(e.device_type == cuda
                                   for e in events) / steps,
        "top_kernels_ms_per_step": [(k, v / steps) for k, v in top_kernels],
        "top_host_ops_self_ms_per_step": [(k, v / steps, c // steps)
                                          for k, v, c in host_ops],
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
        "graph_pool_bytes": 0 if graph is None else pool_bytes([graph]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--eager", action="store_true",
                    help="the eager step, no CUDA graph")
    args = ap.parse_args(argv)
    print(json.dumps(profile(args.arch, args.batch, args.seq, args.steps,
                             step_graph=not args.eager)))


if __name__ == "__main__":
    main()
