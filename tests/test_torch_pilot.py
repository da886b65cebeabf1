"""The port's pilot system: the paper's functional claims, as tests.

Mirrors tests/test_pilot_system.py (and the prefetch and serve-payload
tests of tests/test_serving_continuous.py) on the port, on the CPU
(``device="cpu"``, the kernels' plain versions) with smoke configs: §3.3
unprivileged late binding (pod-scoped capability, image patch, warm
rebinding), §3.4 monitoring via the shared process table + uid model, §3.5
env setup + exit-code relay, §3.6 cleanup by restart, plus the dHTC
fault-tolerance substrate: leases, re-queue on node failure,
first-completion-wins.  Where the reference's tests run a train payload
only as a payload that takes time, they run a decode or serve payload
here; the train payload itself, its checkpoints and its resume across
pilots are tests/test_torch_train.py's.  mamba2-370m stands in for the
reference tests' gemma-2b (a second arch of another family);
tests/test_torch_archs.py binds the smollm-360m, gemma-2b pair.  Every
timeout is the reference test's.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from repro_torch.configs.base import get_smoke_config
from repro_torch.core.arena import SharedArena
from repro_torch.core.cluster import ClusterSim
from repro_torch.core.images import ExecutableRegistry, PLACEHOLDER, PayloadImage
from repro_torch.core.latebind import (
    PayloadExecutor, PermissionError_, PodPatchCapability)
from repro_torch.core.monitor import Monitor, MonitorLimits
from repro_torch.core.pilot import PilotConfig
from repro_torch.core.proctable import PAYLOAD_UID, PILOT_UID, ProcessTable
from repro_torch.core.taskrepo import TaskRepo, TaskResult
from repro_torch.launch.serve import make_trace

CPU = "cpu"
SMOKE_TRAIN = PayloadImage("smollm-360m", "smoke", "train")
SMOKE_DECODE = PayloadImage("smollm-360m", "smoke", "decode")
MAMBA_DECODE = PayloadImage("mamba2-370m", "smoke", "decode")


# ---------------------------------------------------------------------------
# §3.3 late binding
# ---------------------------------------------------------------------------

def _executor(tmp_path):
    arena = SharedArena(str(tmp_path / "arena"))
    pt = ProcessTable()
    reg = ExecutableRegistry()
    ex = PayloadExecutor("pod-A", arena, pt, reg, device=CPU)
    return ex, arena, pt, reg


def test_placeholder_installed_at_creation(tmp_path):
    ex, *_ = _executor(tmp_path)
    assert ex.image == PLACEHOLDER
    assert ex.state == "unbound"
    assert ex.exe.device.type == "cpu"


def test_pod_patch_capability_is_pod_scoped(tmp_path):
    """The §3.3 authorization: 'pod patch' only inside its own pod."""
    ex, *_ = _executor(tmp_path)
    with pytest.raises(PermissionError_):
        ex.patch_image(PodPatchCapability(pod_id="pod-B"), SMOKE_DECODE)
    exe = ex.patch_image(PodPatchCapability(pod_id="pod-A"), SMOKE_DECODE)
    assert ex.state == "bound" and exe.image == SMOKE_DECODE


def test_wait_for_spec_timeout_is_exit_124(tmp_path):
    """Payload container started but no startup spec ever appears."""
    ex, arena, _, _ = _executor(tmp_path)
    ex.patch_image(PodPatchCapability("pod-A"), SMOKE_DECODE)
    ex.start(spec_timeout=0.2)
    ex.join(timeout=10.0)
    assert arena.read_exit()["exitcode"] == 124


def test_warm_rebind_skips_the_pull(tmp_path):
    """The measurable late-binding win: the second bind of the same image is
    a cache hit (image already 'pulled' on the node)."""
    ex, _, _, reg = _executor(tmp_path)
    cap = PodPatchCapability("pod-A")
    e1 = ex.patch_image(cap, SMOKE_DECODE)
    e2 = ex.patch_image(cap, SMOKE_DECODE)
    assert not e1.cached and e2.cached
    assert e2.fn is e1.fn                       # the same built image
    assert reg.stats["hits"] == 1
    # single-flight: concurrent pulls build once
    reg2 = ExecutableRegistry()
    outs = []
    ts = [threading.Thread(target=lambda: outs.append(
        reg2.pull(SMOKE_DECODE, CPU))) for _ in range(4)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert reg2.stats["misses"] == 1 and len(outs) == 4
    assert len({id(e.fn) for e in outs}) == 1


def test_restart_invalidates_waiting_container(tmp_path):
    """reset() while the old container waits for a spec: the old generation
    must not execute a spec published after the restart."""
    ex, arena, pt, _ = _executor(tmp_path)
    cap = PodPatchCapability("pod-A")
    ex.patch_image(cap, SMOKE_DECODE)
    ex.start(spec_timeout=5.0)
    ex.reset()
    assert ex.state == "bound"
    ex.start(spec_timeout=5.0)
    arena.publish_startup_spec({"n_steps": 1})
    ex.join(timeout=30.0)
    assert arena.read_exit()["exitcode"] == 0


# ---------------------------------------------------------------------------
# §3.4 process table + uid model
# ---------------------------------------------------------------------------

def test_uid_visibility_and_signal_rules():
    pt = ProcessTable()
    pe = pt.register(PILOT_UID, "pilot")
    we = pt.register(PAYLOAD_UID, "payload")
    # pilot sees all; payload sees only its own uid
    assert {e.pid for e in pt.entries()} == {pe.pid, we.pid}
    assert {e.pid for e in pt.entries(viewer_uid=PAYLOAD_UID)} == {we.pid}
    # payload cannot signal the pilot (EPERM), pilot can signal payload
    assert not pt.kill(pe.pid, signaller_uid=PAYLOAD_UID)
    assert pt.kill(we.pid, signaller_uid=PILOT_UID)
    assert we.stop.is_set()


def test_monitor_wall_limit_kills():
    pt = ProcessTable()
    e = pt.register(PAYLOAD_UID, "payload")
    mon = Monitor(pt, MonitorLimits(max_wall=0.5))
    acts = mon.scan(now=e.started + 1.0)
    assert [a.kind for a in acts] == ["kill-wall"]
    assert e.stop.is_set()


def test_monitor_straggler_detection():
    pt = ProcessTable()
    e = pt.register(PAYLOAD_UID, "payload")
    for _ in range(5):
        pt.heartbeat(e.pid, 1.0)                 # 1 s/step
    mon = Monitor(pt, MonitorLimits(max_wall=1e9, straggler_factor=3.0),
                  fleet_median_fn=lambda: 0.1)   # fleet does 100 ms/step
    acts = mon.scan()
    assert [a.kind for a in acts] == ["kill-straggler"]


def test_monitor_healthy_payload_untouched():
    pt = ProcessTable()
    e = pt.register(PAYLOAD_UID, "payload")
    for _ in range(5):
        pt.heartbeat(e.pid, 0.1)
    mon = Monitor(pt, MonitorLimits(max_wall=1e9, straggler_factor=3.0),
                  fleet_median_fn=lambda: 0.1)
    assert mon.scan() == []
    assert not e.stop.is_set()


# ---------------------------------------------------------------------------
# §3.5 env + exit-code relay, §3.6 cleanup
# ---------------------------------------------------------------------------

def test_env_and_exit_relay_through_arena(tmp_path):
    arena = SharedArena(str(tmp_path / "a"))
    arena.write_env({"seed": 3, "pilot": "p1"})
    assert arena.read_env()["seed"] == 3
    arena.report_exit(7, {"steps": 2})
    got = arena.read_exit()
    assert got["exitcode"] == 7 and got["telemetry"]["steps"] == 2


def test_wipe_shared_preserves_private(tmp_path):
    arena = SharedArena(str(tmp_path / "a"))
    arena.stage_file("in/data.bin", b"x")
    with open(f"{arena.private}/lease.json", "w") as f:
        f.write("{}")
    arena.wipe_shared()
    assert arena.shared_files() == []
    import os
    assert os.path.exists(f"{arena.private}/lease.json")


# ---------------------------------------------------------------------------
# TaskRepo: matchmaking, leases, first-wins
# ---------------------------------------------------------------------------

def test_matchmaking_requirements_and_priority():
    repo = TaskRepo()
    t_gpu = repo.submit(SMOKE_TRAIN, priority=0,
                        requirements=lambda ad: ad["labels"].get("accel") == "gpu")
    t_any = repo.submit(SMOKE_DECODE, priority=5)
    ad = {"pilot_id": "p", "labels": {}}
    got = repo.match(ad)
    assert got.task_id == t_any                 # higher priority, matching
    assert repo.match(ad) is None               # gpu-only task doesn't match
    got2 = repo.match({"pilot_id": "p2", "labels": {"accel": "gpu"}})
    assert got2.task_id == t_gpu


def test_lease_expiry_requeues():
    repo = TaskRepo(lease_ttl=0.05)
    tid = repo.submit(SMOKE_TRAIN)
    task = repo.match({"pilot_id": "p1", "labels": {}})
    assert task.task_id == tid
    assert repo.stats()["leased"] == 1
    # the repo-owned deadline-heap timer expires the lease and hands the
    # re-queued task to a parked pilot — nobody polls or reaps by hand
    got = repo.match_wait({"pilot_id": "p2", "labels": {}}, timeout=10.0)
    assert got is not None and got.task_id == tid and got.attempts == 2
    repo.release(got)
    assert repo.stats() == {"queued": 1, "leased": 0, "done": 0,
                             "failed": 0, "pilots": 0}


def test_first_completion_wins():
    repo = TaskRepo()
    tid = repo.submit(SMOKE_TRAIN)
    repo.match({"pilot_id": "p1", "labels": {}})
    r1 = TaskResult(tid, "p1", 0, {})
    r2 = TaskResult(tid, "p2", 0, {})
    assert repo.complete(r1) is True
    assert repo.complete(r2) is False           # speculative duplicate dropped
    assert repo.result(tid).pilot_id == "p1"


def test_failed_payload_retries_then_fails():
    repo = TaskRepo()
    tid = repo.submit(SMOKE_TRAIN, max_attempts=2)
    for attempt in range(2):
        t = repo.match({"pilot_id": "p", "labels": {}})
        assert t is not None and t.attempts == attempt + 1
        repo.complete(TaskResult(tid, "p", 1, {}))
        repo.release(t, failed=True)
    assert repo.match({"pilot_id": "p", "labels": {}}) is None
    assert repo.stats()["failed"] == 1


# ---------------------------------------------------------------------------
# Integration: full pilot lifecycle
# ---------------------------------------------------------------------------

def test_pilot_runs_multiple_payloads_one_slice():
    """One resource claim, several different payloads — the core late-binding
    value proposition (multi-payload pilot)."""
    sim = ClusterSim(device=CPU)
    t1 = sim.repo.submit(SMOKE_DECODE, n_steps=2)
    t2 = sim.repo.submit(MAMBA_DECODE, n_steps=2)
    (s,) = sim.provision(1)
    assert s.device.type == "cpu" and s.devices
    p = sim.spawn_pilot(s, PilotConfig(max_payloads=4, idle_grace=1.0))
    assert sim.run_until_drained(timeout=300.0)
    sim.join_all(30.0)
    assert sim.repo.result(t1).exitcode == 0
    assert sim.repo.result(t2).exitcode == 0
    assert len(p.history) == 2
    assert s.released                            # step (h): slice released
    assert p.state == "terminated"


def test_node_failure_requeue_and_recovery():
    """Hard pilot death mid-payload -> lease expires -> second pilot
    completes the task (at-least-once delivery)."""
    repo = TaskRepo(lease_ttl=0.5)
    sim = ClusterSim(repo=repo, device=CPU)
    # 300 decode steps outlast the lease TTL, so the pilots renew within
    # it (the reference's train payload finishes inside one TTL)
    renew = 0.1
    tid = repo.submit(SMOKE_DECODE, n_steps=300, max_attempts=5)
    (s1,) = sim.provision(1)
    p1 = sim.spawn_pilot(s1, PilotConfig(max_payloads=2, idle_grace=0.5,
                                         lease_renew_interval=renew))
    deadline = time.monotonic() + 30.0           # until it runs the payload
    while "running" not in p1.state_log and time.monotonic() < deadline:
        time.sleep(0.005)
    assert "running" in p1.state_log
    sim.fail_node(s1.slice_id)
    p1.join(30.0)
    assert p1.state == "failed"
    (s2,) = sim.provision(1)
    sim.spawn_pilot(s2, PilotConfig(max_payloads=2, idle_grace=2.0,
                                    lease_renew_interval=renew))
    assert sim.run_until_drained(timeout=300.0)
    sim.join_all(30.0)
    res = repo.result(tid)
    assert res is not None and res.exitcode == 0
    assert res.pilot_id != p1.pilot_id
    assert res.telemetry["steps"] == 300


# ---------------------------------------------------------------------------
# prefetch and serve payloads (tests/test_serving_continuous.py)
# ---------------------------------------------------------------------------

def test_registry_prefetch_race_spawns_one_worker():
    reg = ExecutableRegistry()
    img = PayloadImage(arch="placeholder", shape="none", mode="noop")
    start = threading.Barrier(4)
    evs = []

    def go():
        start.wait()
        evs.append(reg.prefetch(img, CPU))

    threads = [threading.Thread(target=go) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert len(evs) == 4
    for ev in evs:
        assert ev.wait(timeout=30.0)
    assert reg.stats["prefetches"] == 1
    assert reg.stats["misses"] == 1


def test_prefetch_hint_warms_next_bind():
    """A matched task's prefetch hint overlaps the NEXT image's pull with
    the current payload's run: the follow-up bind is a cache hit."""
    sim = ClusterSim(device=CPU)
    sim.repo.submit(SMOKE_DECODE, n_steps=3, prefetch_hint=MAMBA_DECODE)
    sim.repo.submit(MAMBA_DECODE, n_steps=3)
    (s,) = sim.provision(1)
    pilot = sim.spawn_pilot(s, PilotConfig(max_payloads=3, idle_grace=1.0))
    assert sim.run_until_drained(timeout=300.0)
    sim.join_all(30.0)
    assert sim.registry.stats["prefetches"] == 1
    assert [h["exitcode"] for h in pilot.history] == [0, 0]
    assert pilot.history[0]["prefetch_started"] is True
    # the second bind found its image in the cache (pull overlapped or
    # joined via single-flight — either way the pull was not a fresh miss)
    assert pilot.history[1]["bind_cached"] is True


def test_serve_payload_via_pilot():
    """A pilot late-binds an inference SERVER the way it late-binds a step
    payload: the request trace rides in the startup spec, and the telemetry
    reports continuous-batching serving stats."""
    cfg = get_smoke_config("smollm-360m")
    trace = make_trace(cfg.vocab_size, 5, max_len=64, seed=3)
    sim = ClusterSim(device=CPU)
    tid = sim.repo.submit(
        PayloadImage("smollm-360m", "smoke", "serve"),
        n_steps=500, payload_spec={"trace": trace, "max_len": 64})
    (s,) = sim.provision(1)
    sim.spawn_pilot(s, PilotConfig(max_payloads=1, idle_grace=1.0))
    assert sim.run_until_drained(timeout=300.0)
    sim.join_all(30.0)
    r = sim.repo.result(tid)
    assert r is not None and r.exitcode == 0
    sv = r.telemetry["serve"]
    assert sv["completed"] == 5
    assert sv["d2h_transfers"] == sv["decode_steps"]
    assert 0.0 < sv["slot_utilization"] <= 1.0
    assert len(r.telemetry["tokens"]) == 5
    assert r.telemetry["engine"]["device"] == "cpu"
    assert r.telemetry["engine"]["block_leaks"] == 0


def test_a_failing_bind_releases_the_task():
    """An image the port cannot build (a train image on the kernel flags:
    the kernels are forward only) fails its bind: the pilot records the
    error, releases the task as failed and stays alive for the next one."""
    from repro_torch.launch.serve import KERNEL_FLAGS
    sim = ClusterSim(device=CPU)
    bad = sim.repo.submit(PayloadImage("smollm-360m", "smoke", "train",
                                       flags=KERNEL_FLAGS),
                          n_steps=1, max_attempts=1)
    good = sim.repo.submit(SMOKE_DECODE, n_steps=1)
    (s,) = sim.provision(1)
    p = sim.spawn_pilot(s, PilotConfig(max_payloads=3, idle_grace=1.0))
    assert sim.run_until_drained(timeout=300.0)
    sim.join_all(30.0)
    assert sim.repo.stats()["failed"] == 1
    assert sim.repo.result(good).exitcode == 0
    errs = [h["error"] for h in p.history if "error" in h]
    assert len(errs) == 1 and "no VJP" in errs[0]
    assert sim.repo.result(bad) is None


# ---------------------------------------------------------------------------
# the device lock: a prefetch on another thread and the payload's engine
# ---------------------------------------------------------------------------

def test_engine_step_waits_for_the_device_lock():
    """While another thread holds the device lock (a prefetch warming up),
    an engine step does not start; it runs once the lock is let go."""
    from repro_torch.serving.engine import Request
    from repro_torch.serving.graph import DEVICE_LOCK
    exe = ExecutableRegistry().pull(PayloadImage("smollm-360m", "smoke",
                                                 "serve"), CPU)
    eng = exe.fn(exe.make_inputs(0), max_len=64)
    eng.submit(Request(0, prompt=np.arange(1, 9, dtype=np.int32),
                       max_new_tokens=4))
    held, release, done = (threading.Event() for _ in range(3))

    def holder():
        with DEVICE_LOCK:
            held.set()
            release.wait(10.0)

    t = threading.Thread(target=holder)
    t.start()
    held.wait(10.0)
    stepper = threading.Thread(target=lambda: (eng.step(), done.set()))
    stepper.start()
    assert not done.wait(0.2)                    # parked on the lock
    release.set()
    assert done.wait(10.0) and eng.done == {} and len(eng._live) == 1
    t.join()
    stepper.join()


def test_engine_counts_only_its_own_launches():
    """An engine adds to its ``launches`` what wrappers counted while it held
    the device lock; launches other threads make under the lock (prefetch
    warm-ups) are not its own, and none is lost.  A stress run: more
    threads than cores, a short switch interval."""
    import os
    import sys
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused
    from repro_torch.serving.engine import Request
    from repro_torch.serving.graph import DEVICE_LOCK
    exe = ExecutableRegistry().pull(PayloadImage("smollm-360m", "smoke",
                                                 "serve"), CPU)
    eng = exe.fn(exe.make_inputs(0), max_len=64)
    step = eng._step_fn

    def counted(*args):                          # stands in for 2 launches
        rmsnorm_fused.launches += 2
        return step(*args)
    eng._step_fn = counted
    for rid in range(3):
        eng.submit(Request(rid, prompt=np.arange(1, 9, dtype=np.int32),
                           max_new_tokens=6))
    n_threads, n_each = 2 * (os.cpu_count() or 4), 200
    start = threading.Barrier(n_threads + 1)

    def other():
        start.wait(30.0)
        for _ in range(n_each):
            with DEVICE_LOCK:
                rmsnorm_fused.launches += 1

    before = rmsnorm_fused.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=other) for _ in range(n_threads)]
        for t in threads:
            t.start()
        start.wait(30.0)
        stats = eng.run()
        for t in threads:
            t.join(30.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert stats["completed"] == 3
    assert stats["launches"] == {"rmsnorm_fused": 2 * stats["decode_steps"]}
    assert rmsnorm_fused.launches - before == (n_threads * n_each
                                               + 2 * stats["decode_steps"])

