"""Reads a ``torch.profiler`` sub-window: device busy time as the union of
device intervals (overlapping operations count once), device time by
operation name, and the longest idle gaps named by the host's CUDA call
open when each began (none open: the host is in Python)."""

from __future__ import annotations

import torch


def _raw(prof):
    """(device ops, host ops) as lists of (start_ns, end_ns, name)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        rec = (s, s + e.duration_ns(), e.name())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(rec)
        else:
            host.append(rec)
    return dev, host


def _merge(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, window_s: float) -> dict:
    """The sub-window's device record: ``busy_s``, ``window_s``,
    ``by_name`` (device seconds by operation name), ``device_ops`` and
    ``idle_gaps`` (each top 10, as [name, seconds]), ``ops`` (device
    operations counted)."""
    dev, host = _raw(prof)
    merged = _merge((s, e) for s, e, _ in dev)
    busy_ns = sum(e - s for s, e in merged)
    by_name: dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:10]
    named = []
    for length, at in gaps:
        open_ops = [(s, n) for s, e, n in host if s <= at < e]
        name = max(open_ops)[1] if open_ops else "host: no CUDA call open"
        named.append([name, length / 1e9])
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": window_s,
        "ops": len(dev),
        "by_name": by_name,
        "device_ops": sorted(([n, t] for n, t in by_name.items()),
                             key=lambda r: -r[1])[:10],
        "idle_gaps": named,
    }


def profiler():
    """A profiler of device operations and the CUDA calls that launch them
    (on the card), or of host operations (without one).  On the card no
    host operator is recorded: recording every operator of every thread
    slows the host enough to widen the idle gaps it measures."""
    acts = ([torch.profiler.ProfilerActivity.CUDA] if torch.cuda.is_available()
            else [torch.profiler.ProfilerActivity.CPU])
    return torch.profiler.profile(activities=acts)
