#!/usr/bin/env python3
"""The benchmark's one command (from the checkout's root):

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1]

Runs the cell named in ``BENCHMARK.json`` on one H100: set-up, a window of
``--seconds``, the drain, then the comparison with the plain reference
that decides ``correct``.  With ``--trace 0`` the result's metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profiled sub-window of the window.  ``--control 1`` puts the
control (the reference in float8) in the program's place: its numbers are
judged against the limits, so such a run reports ``correct`` false, and
the program's own follow as ``program_<number>``.  The last line of standard output is the result, one JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key, ``checks``.

Exits 2 without the chips the cell asks for, 3 where the program's
configuration differs from the cell's file, 4 where JAX or the JAX
package got loaded; each without a result.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The monotonic time this process started (``/proc``: its start in
    clock ticks since boot, against the seconds since boot now)."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level names, whole


class ConfigMismatch(Exception):
    """The program's registered configuration is not the cell's file."""


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules (``sys.modules`` unless given) whose top-level name
    is JAX's, or the JAX package's (``repro_torch`` is the port, and
    allowed)."""
    return sorted(m for m in list(sys.modules if modules is None else modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def check_program_config(c: dict):
    """Raise where the program's registered configuration differs from the
    cell's file in a size the file states."""
    from repro_torch.configs.base import get_config, get_smoke_config
    cfg = (get_smoke_config if c.get("smoke") else get_config)(c["arch"])
    want = {"num_layers": c["num_hidden_layers"], "d_model": c["hidden_size"],
            "vocab_size": c["vocab_size"], "norm_eps": c["rms_norm_eps"],
            "tie_embeddings": c["tie_word_embeddings"]}
    if c["family"] == "moe":
        want.update(num_heads=c["num_attention_heads"],
                    num_kv_heads=c["num_key_value_heads"],
                    head_dim=c["head_dim"], rope_theta=c["rope_theta"])
        have_moe = (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
                    cfg.moe.capacity_factor, cfg.moe_period)
        want_moe = (c["num_local_experts"], c["num_experts_per_tok"],
                    c["intermediate_size"], c["capacity_factor"], 1)
        if have_moe != want_moe:
            raise ConfigMismatch(f"MoE {have_moe} != {want_moe}")
    else:
        s = cfg.ssm
        have = (s.state_dim, s.head_dim, s.expand, s.conv_width, s.chunk_size,
                s.n_groups)
        exp = (c["state_size"], c["head_dim"], c["expand"], c["conv_kernel"],
               c["chunk_size"], c["n_groups"])
        if have != exp or not cfg.is_attention_free:
            raise ConfigMismatch(f"SSM {have} != {exp}")
    for k, v in want.items():
        have = getattr(cfg, k) or (cfg.d_model // cfg.num_heads
                                   if k == "head_dim" else 0)
        if have != v:
            raise ConfigMismatch(f"{k}: the program's {have} != the file's {v}")
    if cfg.family != c["family"]:
        raise ConfigMismatch(f"family {cfg.family} != {c['family']}")


def execute(cell: str, seed: int, seconds: float, traced: bool, device,
            control: bool = False, root: Path = ROOT,
            t_process: float = T_PROCESS) -> tuple[dict, dict]:
    """Run ``cell`` on ``device``; returns (the result line, the checks
    table).  Needs no chip: the tests drive it on the CPU."""
    import torch

    from perfbench import bench, correct
    from perfbench import serve as serve_mod
    from perfbench import train as train_mod

    b = bench.load_benchmark(root)
    w = bench.workload(b, cell)
    c = bench.config(b, w["config"], root)
    mix = bench.mix(w["traffic"], root / "perfbench")
    check_program_config(c)
    try:
        limits = bench.limits(cell, root / "perfbench")
    except FileNotFoundError:
        limits = None
    if mix["kind"] == "closed_loop":
        out = serve_mod.run(c, mix, seed, seconds, traced, device, t_process,
                            smoke=bool(c.get("smoke")))
        attempted = len(out["in_window"])
        done = {r["rid"] for r in out["requests"] if r["tokens"] is not None}
        failed = sum(1 for rid in out["in_window"] if rid not in done)
    elif mix["kind"] == "train":
        out = train_mod.run(c, mix, seed, seconds, traced, device, t_process,
                            smoke=bool(c.get("smoke")))
        attempted, failed = out["steps"], 0
    else:
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    out.update({"config": c, "mix": mix, "cell": cell, "seconds": seconds})
    metrics = {}
    for m in (bench.per_layer(b, cell) if traced else bench.end_to_end(b, cell)):
        value = bench.reader(m["name"], root / "perfbench").read(out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind = (torch.cuda.get_device_name(device) if torch.cuda.is_available()
            and torch.device(device).type == "cuda" else "cpu")
    dev = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
           "count": w["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": False, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    if traced and out["profile"] is not None:
        prof = out["profile"]
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = {"device_ops": prof["device_ops"],
                             "idle_gaps": prof["idle_gaps"]}
    # the program's state is gone with its payload; the reference runs now
    out.pop("profile", None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if mix["kind"] == "train":
        rec = correct.train_checks(out, c, device, control=control)
    else:
        rids = serve_mod.sample(out, seed, mix["check_requests"])
        rec = correct.serve_checks(out, c, rids, device, control=control)
    serve_mod.log(t_process, f"compared {rec['compared_requests']} requests,"
                             f" {rec['compared_tokens']} tokens; {rec['diag']}")
    checks = dict(rec["checks"])
    checks["failed"] = failed
    if rec["control"] is not None:
        checks = correct.in_place_of_program(checks, rec["control"])
    ok, table = correct.judge(checks, limits)
    line["correct"] = ok and attempted > 0
    line["checks"] = table
    return line, table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    faulthandler.enable()        # a SIGABRT prints every thread's stack

    from perfbench import bench
    w = bench.workload(bench.load_benchmark(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"needs {w['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        line, table = execute(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              control=bool(args.control))
    except ConfigMismatch as e:
        print(f"configuration mismatch: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 4
    for k, v in table.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
