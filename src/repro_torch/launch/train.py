"""End-to-end training driver of the port, direct or THROUGH the pilot system.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 300 --batch 8 --seq 512 --ckpt /tmp/ck [--smoke] [--direct] \\
        [--device cpu]

Port of ``repro.launch.train``, with its flags and a ``--device`` flag
("cuda" by default; without a card it raises unless the caller asks for
"cpu"; nothing falls back to the CPU).  The train step differentiates the
plain paths of the model (the hand-written kernels are forward only, as
the reference's are), so the configs are the registry's as they are.

``--direct`` runs a plain loop, no pilot system; on the card its step
replays a captured CUDA graph from the second step on.  Otherwise the run
is a ``train`` payload image that a pilot late-binds, checkpointing into
``--ckpt`` every tenth of the run; with ``--fail-at N`` a simulated node
failure kills the first pilot N seconds in, the lease expires, and a
replacement pilot picks the task up and resumes from the last checkpoint —
the fault-tolerance demo.  `train_via_pilots` can also fail the node once
a given checkpoint step is on disk (``fail_after_ckpt``), which makes the
resume point exact.
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.ckpt.checkpoint import latest_step
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.cluster import ClusterSim
from repro_torch.core.images import PayloadImage
from repro_torch.core.pilot import PilotConfig
from repro_torch.core.taskrepo import TaskRepo
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM, to_device
from repro_torch.launch.steps import (
    held_graph, init_train_state, make_train_step)
from repro_torch.models.api import resolve_device
from repro_torch.optim.adamw import OptimConfig
from repro_torch.serving.graph import pool_bytes


def train_direct(cfg, steps: int, batch: int, seq: int, *, log_every=10,
                 device="cuda", step_graph: bool = True) -> dict:
    """A plain loop of ``steps`` train steps on the synthetic data, from the
    weights of seed 0.  On the card the step is captured as a CUDA graph at
    its first call and replayed from the second (``step_graph``; False runs
    it eagerly; `repro_torch.launch.steps.make_train_step`).  Returns
    ``losses`` and ``step_seconds`` (each step's wall time, ending in the
    loss's copy to the host), ``step_graph`` (whether the steps replayed a
    graph), ``capture_s`` (the first call's seconds: the eager step 0 and,
    graphed, the capture), ``graph_pool_bytes`` (what the graph's memory
    pool holds; 0 eager), the ``device`` and the model's ``n_params``."""
    dev = resolve_device(device)
    step_fn = make_train_step(cfg, OptimConfig(
        total_steps=steps, warmup_steps=max(steps // 20, 5)),
        step_graph=step_graph)
    state = init_train_state(cfg, 0, dev)
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, seq, batch))
    losses, times = [], []
    t_start = time.monotonic()
    for i in range(steps):
        t0 = time.monotonic()
        state, metrics = step_fn(state, to_device(data.batch_at(i), dev))
        loss = float(metrics["loss"])   # before the next replay overwrites it
        times.append(time.monotonic() - t0)
        losses.append(loss)
        if i % log_every == 0 or i == steps - 1:
            dt = (time.monotonic() - t_start) / (i + 1)
            print(f"step {i:4d}  loss {loss:.4f}  ({dt*1e3:.0f} ms/step)")
    graph = held_graph(state)
    return {"losses": losses, "step_seconds": times, "device": str(dev),
            "step_graph": graph is not None,
            "capture_s": times[0] if times else None,
            "graph_pool_bytes": 0 if graph is None else pool_bytes([graph]),
            "n_params": sum(p.numel() for p in state["params"].parameters())}


def train_via_pilots(arch: str, smoke: bool, steps: int, *, ckpt: str | None,
                     fail_at: float | None = None, n_pilots: int = 1,
                     seq: int = 64, batch: int = 2, device="cuda",
                     ckpt_every: int | None = None,
                     fail_after_ckpt: int | None = None) -> dict:
    """One ``train`` payload of ``steps`` steps, late-bound by pilots on
    ``device``, checkpointing into ``ckpt`` every ``ckpt_every`` steps
    (default a tenth of the run).  A node failure kills the first pilot
    ``fail_at`` seconds in, or once step ``fail_after_ckpt``'s checkpoint
    is on disk; once its payload has stopped, a replacement pilot is
    spawned and resumes the task after the lease expires.

    Returns ``drained``, the repo's stats, the task's ``result``, the
    ``failure`` (the failed pilot, the latest checkpoint step once its
    payload stopped and whether that payload's steps replayed a CUDA
    graph, ``step_graph``; None without one), the ``sim`` and the
    ``pilots``."""
    repo = TaskRepo(lease_ttl=5.0)
    sim = ClusterSim(repo=repo, device=device)
    every = ckpt_every or max(steps // 10, 1)
    resume = {"ckpt_dir": ckpt, "ckpt_every": every} if ckpt else {}
    tid = repo.submit(
        PayloadImage(arch=arch, shape=f"custom:{seq}x{batch}", mode="train",
                     smoke=smoke),
        n_steps=steps, max_wall=3600.0, resume=resume)
    slices = sim.provision(n_pilots)
    pilots = [sim.spawn_pilot(s, PilotConfig(max_payloads=4, idle_grace=3.0))
              for s in slices]
    failure = None
    if fail_at is not None or fail_after_ckpt is not None:
        if fail_after_ckpt is not None:
            if not ckpt:
                raise ValueError("fail_after_ckpt needs a checkpoint dir")
            deadline = time.monotonic() + 3600.0
            while (latest_step(ckpt) or 0) < fail_after_ckpt:
                if time.monotonic() > deadline or pilots[0].done():
                    raise RuntimeError(
                        f"no checkpoint of step {fail_after_ckpt} appeared")
                time.sleep(0.02)
        else:
            time.sleep(fail_at)
        print(f"[train] injecting node failure on pilot {pilots[0].pilot_id}")
        sim.fail_node(slices[0].slice_id)
        ex = pilots[0].executor
        if ex is not None and ex.exit_event is not None:
            ex.exit_event.wait(600.0)        # the killed payload's last step
        killed = (pilots[0].arena.read_exit() or {}).get("telemetry", {})
        failure = {"pilot": pilots[0].pilot_id,
                   "ckpt_step": latest_step(ckpt) if ckpt else None,
                   "step_graph": killed.get("step_graph")}
        # a replacement pilot takes over after the lease expires
        (s2,) = sim.provision(1)
        pilots.append(sim.spawn_pilot(s2, PilotConfig(max_payloads=4,
                                                      idle_grace=6.0)))
    ok = sim.run_until_drained(timeout=3600.0)
    sim.join_all(timeout=30.0)
    res = repo.result(tid)
    print(f"[train] drained={ok} repo={repo.stats()}")
    if res is not None:
        t = res.telemetry
        print(json.dumps({
            "task": tid, "pilot": res.pilot_id, "exit": res.exitcode,
            "steps": t.get("steps"), "resumed_from": t.get("resumed_from"),
            "first_loss": t.get("first_loss"), "last_loss": t.get("last_loss"),
            "error": t.get("error"),
        }, indent=1))
    return {"drained": ok, "repo": repo.stats(), "result": res,
            "failure": failure, "sim": sim, "pilots": pilots}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--direct", action="store_true",
                    help="plain loop, no pilot system")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--fail-at", type=float, default=None,
                    help="seconds until a simulated node failure")
    ap.add_argument("--pilots", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.direct:
        cfg = (get_smoke_config(args.arch) if args.smoke
               else get_config(args.arch))
        out = train_direct(cfg, args.steps, args.batch, args.seq,
                           device=args.device)
        losses = out["losses"]
        print(f"[train] first={losses[0]:.4f} last={losses[-1]:.4f}")
        return 0
    out = train_via_pilots(args.arch, args.smoke, args.steps,
                           ckpt=args.ckpt, fail_at=args.fail_at,
                           n_pilots=args.pilots, seq=args.seq,
                           batch=args.batch, device=args.device)
    res = out["result"]
    return 0 if res is not None and res.exitcode == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
