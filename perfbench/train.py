"""A train cell's run: one pilot late-binds the configuration's train image
and runs its payload (the payload wrapper's ``_train_loop``: the step of
``launch/steps.py: make_train_step``, captured as one CUDA graph at its
first call and replayed from the second).  The registry is the program's
own, except that the image's ``make_inputs`` hands over the train state
built on the weights this benchmark made from the seed (f32, the
program's zero AdamW moments), and batches this benchmark makes from the
seed; its step function is wrapped to read the first steps' losses and
the optimizer's state for the comparison.

Timeline: set-up (weights, bind, ``warmup_steps`` steps: step 0 eager and
the capture, then replays, among them the compared steps); the window
(``seconds`` from the start of step ``warmup_steps``; the payload is
stopped at the first step boundary after it; with ``trace``, steps
``warmup_steps + 1`` and ``+ 2`` are profiled).
"""

from __future__ import annotations

import time

import torch

from perfbench import trace as trace_mod
from perfbench.generator import train_batch
from perfbench.reference.train import leaves, tree_map
from perfbench.serve import log
from perfbench.weights import make_weights


class Recorder:
    """What the run reads from the payload: each step's start on the host
    clock, the compared steps' losses, the gradients of step 0 (eager) and
    step 1 (the first replay of the captured step) as the optimizer got
    them (from its first moments: g_0 = m_0 / (1 - b1), g_1 = (m_1 - b1
    m_0) / (1 - b1)), and each parameter's change after the compared
    steps."""

    def __init__(self, init: dict, b1: float, compared: int, traced: bool,
                 profile_from: int, profile_steps: int):
        self.init = init
        self.b1 = b1
        self.compared = compared
        self.starts: dict[int, float] = {}
        self.calls = 0
        self.losses: list[float] = []
        self.grad_norms: list[dict] = []
        self._m0: dict | None = None
        self.change_norms: dict | None = None
        self.traced = traced
        self.profile_from = profile_from
        self.profile_to = profile_from + profile_steps
        self.prof = None
        self.profile: dict | None = None

    def on_step(self, i: int):
        now = time.monotonic()
        self.starts[i] = now
        if not self.traced:
            return
        if i == self.profile_from:
            self.prof = trace_mod.profiler()
            self.prof.__enter__()
            self.t_prof = time.monotonic()
        elif i == self.profile_to and self.prof is not None:
            t1 = time.monotonic()
            self.prof.__exit__(None, None, None)
            self.profile = trace_mod.summarize(self.prof, t1 - self.t_prof)
            self.prof = None

    def _read_grad(self, i: int, m):
        b1 = self.b1
        with torch.no_grad():
            m = dict(leaves(m))
            if i == 0:
                self._m0 = {k: v.detach().clone() for k, v in m.items()}
                g = {k: float(v.norm()) / (1 - b1) for k, v in m.items()}
            else:
                g = {k: float((v - b1 * self._m0[k]).norm()) / (1 - b1)
                     for k, v in m.items()}
                self._m0 = None
        self.grad_norms.append(g)

    def wrap(self, fn):
        def step(state, batch):
            i = self.calls
            self.calls += 1
            if i == self.compared:
                with torch.no_grad():
                    init = dict(leaves(self.init))
                    self.change_norms = {
                        k: float((p.detach() - init[k]).norm())
                        for k, p in leaves(state["params"].live())}
            state, metrics = fn(state, batch)
            if i < self.compared:
                self.losses.append(float(metrics["loss"]))
            if i < 2:
                self._read_grad(i, state["opt"]["m"])
            return state, metrics
        return step


class Batches:
    """The payload's data: batch ``i`` from the seed; each call marks the
    start of step ``i``."""

    def __init__(self, seed, B, S, V, rec: Recorder):
        self.args = (seed, B, S, V)
        self.rec = rec

    def batch_at(self, i: int) -> dict:
        self.rec.on_step(i)
        seed, B, S, V = self.args
        return train_batch(seed, i, B, S, V)


def run(c: dict, mix: dict, seed: int, seconds: float, traced: bool,
        device, t_process: float, smoke: bool = False) -> dict:
    from repro_torch.core import ClusterSim, PayloadImage, PilotConfig
    from repro_torch.core.images import ExecutableRegistry
    from repro_torch.core.proctable import PAYLOAD_UID
    from repro_torch.models.transformer import LMParams
    from repro_torch.optim.adamw import init_opt_state

    tr = c["train"]
    B, S = tr["batch"], tr["seq"]
    W = int(mix["warmup_steps"])
    compared = int(mix["compared_steps"])
    tree = make_weights(c, seed, device, dtype=torch.float32)
    init = tree_map(torch.clone, tree)        # the reference's start
    params = LMParams(tree)
    params.requires_grad_(True)
    holder = {"state": {"params": params, "opt": init_opt_state(params.live())}}
    del params, tree                   # the payload owns its state
    rec = Recorder(init, tr["optimizer"]["b1"], compared, traced, W + 1,
                   int(mix["profile_steps"]))
    batches = Batches(seed, B, S, c["vocab_size"], rec)
    log(t_process, "weights made")

    class Registry(ExecutableRegistry):
        """The program's registry; a pulled train image's inputs are the
        benchmark's state and batches, its step read by `Recorder`."""

        def _build(self, image, dev, mesh=None):
            exe = super()._build(image, dev, mesh)
            exe.fn = rec.wrap(exe.fn)
            exe.make_inputs = lambda _seed: (holder.pop("state"), batches)
            return exe

    if traced:
        with trace_mod.profiler():            # the tracing's one-off set-up
            pass
    image = PayloadImage(arch=c["arch"], shape=f"custom:{S}x{B}",
                         mode="train", smoke=smoke)
    sim = ClusterSim(registry=Registry(), device=device)
    fleet = sim.spawn_fleet(1, PilotConfig(max_payloads=1, idle_grace=1.0))
    pilot = fleet.members[0]
    try:
        tid = sim.repo.submit(image, n_steps=10 ** 6, max_wall=3600.0)
        while W not in rec.starts:
            ended = sim.repo.result(tid)
            if ended is not None or pilot.done():
                raise RuntimeError(f"the train payload ended in set-up: "
                                   f"{ended}, pilot {pilot.state}, "
                                   f"{pilot.error}, {pilot.history}")
            time.sleep(0.01)
        t0 = rec.starts[W]
        log(t_process, "window opens")
        time.sleep(max(0.0, t0 + seconds - time.monotonic()))
        t_close = time.monotonic()
        pilot.proctable.kill_uid(PAYLOAD_UID)  # stops at the next boundary
        while sim.repo.result(tid) is None and not pilot.done():
            time.sleep(0.01)
        log(t_process, "window closed")
        peak = (torch.cuda.max_memory_allocated()
                if torch.cuda.is_available() else 0)
    finally:
        fleet.drain_all()
        fleet.join_all(120.0)
    log(t_process, "pilot ended")
    result = sim.repo.result(tid)
    ends = sorted(i for i, t in rec.starts.items() if W < i and t <= t_close)
    last = ends[-1] if ends else W
    return {
        "kind": "train", "t_process": t_process, "t0": t0,
        "t1": rec.starts[last], "steps": last - W,
        "step_s": [rec.starts[i + 1] - rec.starts[i] for i in range(W, last)],
        "tokens_per_step": B * S,
        "t_ready": rec.starts.get(1), "pilot_started": pilot.t_started,
        "setup_s": t0 - t_process,
        "pilot_history": list(pilot.history),
        "telemetry": result.telemetry if result is not None else {},
        "profile": rec.profile, "memory_peak_bytes": peak,
        "losses": rec.losses, "grad_norms": rec.grad_norms,
        "change_norms": rec.change_norms,
        "batches": [train_batch(seed, i, B, S, c["vocab_size"])
                    for i in range(compared)],
        "init": init}
