"""Fleet serve on the port: N pilots lease requests from one pool.

Mirrors the engine-bound scenarios of tests/test_fleet_serve.py,
tests/test_autoscaler.py and tests/test_chaos.py on torch payloads, on the
CPU (``device="cpu"``, the kernels' plain versions) at smoke widths:
requeue on a pilot's failure, a pilot joining mid-trace, a busy server's
scale-down, a chaos drill with a stall and a poison request, and an
autoscaled fleet that scales to zero.  The fleet's tokens are held bitwise
to the port's ``serve_direct`` on the same trace and weights (the direct
engine is held to JAX in tests/test_torch_engine.py), a self-drafting
fleet's to the plain fleet's, and the server telemetry to the reference's
keys.  The timeouts are the reference tests'; the fleets' lease TTL is
1 s (the reference's tests: 0.5 s), since these run in the fast lane
beside other test workers and a server's tick must stay under it.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.core.autoscaler import AutoscalePolicy
from repro_torch.core.chaos import FaultPlan, FaultSpec
from repro_torch.core.cluster import ClusterSim
from repro_torch.core.images import ExecutableRegistry, PayloadImage
from repro_torch.core.pilot import PilotConfig
from repro_torch.core.proctable import PAYLOAD_UID, PILOT_UID
from repro_torch.launch.serve import (
    build_engine, make_bursty_schedule, make_trace, serve_direct,
    serve_fleet, serve_fleet_schedule)
from repro_torch.serving.dispatch import FleetDispatcher, RobustnessPolicy
from repro_torch.serving.engine import Request

ARCH = "smollm-360m"
CPU = "cpu"
N, SLOTS, MAX_LEN = 10, 2, 64
FLEET = dict(slots=SLOTS, max_len=MAX_LEN, lease_ttl=1.0, smoke=True,
             device=CPU)
SERVER = PayloadImage(ARCH, "smoke", "serve")


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_op():
    """A fleet runs one engine a pilot thread in this process, beside the
    test run's other workers: at smoke widths an op gains nothing from
    intra-op threads, and N servers x every core oversubscribes the CPU
    into ticks longer than a lease."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """One registry for the module's fleets (one pull); the plain fleet, the
    same fleet with a lease-holding pilot killed after 2 settled requests,
    a self-drafting 2-pilot fleet with a kill, and ``serve_direct`` on
    the same trace and weights (seed 0) with a server's slot count."""
    reg = ExecutableRegistry()
    return {
        "ok": serve_fleet(ARCH, N, 3, registry=reg, **FLEET),
        "failed": serve_fleet(ARCH, N, 3, fail_at=2, registry=reg, **FLEET),
        "spec": serve_fleet(ARCH, N, 2, fail_at=2, draft="self",
                            registry=reg, **FLEET),
        "direct": serve_direct(get_smoke_config(ARCH), N, SLOTS, MAX_LEN,
                               device=CPU),
    }


def _servers_clean(out):
    """Every server that exited gracefully: exit 0, one device->host copy a
    step, no leaked block."""
    done = [s for s in out["servers"] if s["serve"].get("fleet")]
    assert done, out["servers"]
    for s in done:
        assert s["exitcode"] == 0, s["error"]
        assert s["serve"]["d2h_transfers"] == s["serve"]["decode_steps"]
        assert s["serve"]["fleet"]["leaked_blocks"] == 0
        assert s["engine"]["block_leaks"] == 0
    return done


def test_fleet_requeue_on_pilot_failure(runs):
    """Kill 1 of 3 serving pilots mid-trace: every request completes exactly
    once on a survivor, and the completed tokens match a no-failure run
    bitwise (replay-from-prompt over identical weights is deterministic)."""
    ok, failed = runs["ok"], runs["failed"]
    assert ok["completed"] == N and ok["replays"] == 0
    assert ok["duplicates"] == 0 and ok["drained"]
    assert failed["completed"] == N
    assert len(failed["failed_pilots"]) == 1
    # exactly once: N accepted results, every duplicate dropped visibly
    assert sorted(failed["results"]) == list(range(N))
    assert failed["results"] == ok["results"]
    assert failed["replays"] >= 1            # the dead pilot's in-flight work
    _servers_clean(ok)
    _servers_clean(failed)


def test_fleet_results_bitwise_serve_direct(runs):
    """The fleet spreads the trace over three engines; each stream equals
    the one engine of ``serve_direct`` bitwise."""
    assert runs["ok"]["results"] == runs["direct"]["streams"]
    assert runs["ok"]["distinct_servers"] >= 2


def test_self_draft_fleet_with_a_kill_matches_the_plain_fleet(runs):
    """Speculative servers (the target drafting for itself) with one pilot
    killed: requeued requests replay on the survivor, and every stream is
    the plain fleet's bitwise (spec == non-spec tokens)."""
    spec = runs["spec"]
    assert spec["completed"] == N and len(spec["failed_pilots"]) == 1
    assert spec["replays"] >= 1
    assert spec["spec_servers"] >= 1 and spec["tokens_per_step"] > 1
    assert spec["results"] == runs["ok"]["results"]
    for s in _servers_clean(spec):
        assert s["serve"]["spec"] == "draft"


def test_serve_telemetry_holds_the_reference_keys(runs):
    """A fleet server reports the reference's serve stats (its
    ``_SERVE_STAT_KEYS`` and ``fleet``) and the port's engine stats."""
    from repro.core.wrapper import _SERVE_STAT_KEYS as REF_KEYS
    from repro_torch.core.wrapper import _ENGINE_STAT_KEYS, _SERVE_STAT_KEYS
    assert _SERVE_STAT_KEYS == REF_KEYS
    for s in _servers_clean(runs["ok"]):
        assert set(s["serve"]) == set(REF_KEYS) | {"fleet"}
        assert set(s["engine"]) == set(_ENGINE_STAT_KEYS) | {"block_leaks"}
        assert set(s["serve"]["fleet"]) == {
            "server_id", "pool", "fetched", "completed_here", "released",
            "drained", "leaked_blocks"}
        assert s["engine"]["device"] == CPU and not s["engine"]["step_graph"]


def test_fleet_scale_up_joins_mid_trace():
    """A pilot provisioned AFTER serving started leases into the same pool
    and completes part of the trace — late-binding capacity growth without
    touching running requests."""
    cfg = get_smoke_config(ARCH)
    sim = ClusterSim(device=CPU)
    pool = FleetDispatcher(lease_ttl=1.0)
    fleet = sim.spawn_fleet(1, PilotConfig(max_payloads=2, idle_grace=0.5))
    try:
        fleet.submit_servers(SERVER, pool.name, n=1,
                             spec={"slots": 2, "max_len": 64})
        assert pool.wait_servers(1, timeout=300.0)
        trace = make_trace(cfg.vocab_size, 16, max_len=64, seed=1)
        pool.submit_trace(trace[:4])
        assert pool.wait_completed(2, timeout=120.0)
        fleet.scale_up(1)
        fleet.submit_servers(SERVER, pool.name, n=1,
                             spec={"slots": 2, "max_len": 64})
        # feed the bulk of the trace only once the joiner is up, so both
        # servers demonstrably hold leases side by side
        assert pool.wait_servers(2, timeout=300.0)
        pool.submit_trace(trace[4:])
        pool.seal()
        assert pool.wait_all(timeout=300.0)
        stats = pool.stats()
        assert stats["completed"] == 16
        assert stats["distinct_servers"] == 2     # the joiner did real work
    finally:
        pool.close()
        fleet.drain_all()
        fleet.join_all(30.0)


def test_a_join_beside_a_serving_server_loses_no_lease():
    """``chip_smoke.py``'s fleet_join on the CPU: a pilot joins while the
    one live server holds leases, read on the pool's side by
    ``profile_fleet._LeaseGaps``.  The live server renews its leases
    across the joiner's warm-ups and after its announce, no lease is lost
    or replayed, and both servers complete work."""
    from repro_torch.launch.profile_fleet import _LeaseGaps

    cfg = get_smoke_config(ARCH)
    trace = make_trace(cfg.vocab_size, 16, max_len=MAX_LEN, seed=1)
    with _LeaseGaps() as gaps:
        sim = ClusterSim(device=CPU)
        pool = FleetDispatcher(lease_ttl=FLEET["lease_ttl"])
        fleet = sim.spawn_fleet(1, PilotConfig(max_payloads=2,
                                               idle_grace=0.5))
        try:
            spec = {"slots": SLOTS, "max_len": MAX_LEN}
            fleet.submit_servers(SERVER, pool.name, n=1, spec=spec)
            assert pool.wait_servers(1, timeout=300.0)
            (live,) = pool.servers
            pool.submit_trace(trace)
            pool.seal()
            assert pool.wait_completed(1, timeout=120.0)
            assert pool.lease_holders().get(live)
            fleet.scale_up(1)
            fleet.submit_servers(SERVER, pool.name, n=1, spec=spec)
            assert pool.wait_servers(2, timeout=300.0)
            (joiner,) = pool.servers - {live}
            assert pool.wait_all(timeout=300.0)
        finally:
            pool.close()
            fleet.drain_all()
            fleet.join_all(30.0)
    stats = pool.stats()
    assert stats["completed"] == 16 and stats["distinct_servers"] == 2
    assert stats["replays"] == 0 == stats["lost_leases"]
    assert set(gaps.announced) == {live, joiner}
    renews = gaps.renew_times[live]
    assert renews == sorted(renews) and renews[-1] > gaps.announced[joiner]
    row = gaps.by_server[live]
    assert row["lost"] == 0 and row["renewals"] >= len(renews)
    assert max(row["fetch_to_renew_max_s"],
               row["renew_gap_max_s"]) < FLEET["lease_ttl"]


def test_scale_down_busy_serving_pilot_releases_leases():
    """A drained serving pilot must hand its leased requests straight back
    to the pool (release path) — with lease_ttl=600 the TTL can never be
    the requeue mechanism, so completion of the whole trace proves it.
    Back-to-back scale_downs must shed distinct pilots even while the
    first victim is mid-drain."""
    cfg = get_smoke_config(ARCH)
    sim = ClusterSim(device=CPU)
    pool = FleetDispatcher(lease_ttl=600.0)
    fleet = sim.spawn_fleet(3, PilotConfig(max_payloads=2, idle_grace=0.3))
    try:
        fleet.submit_servers(SERVER, pool.name, n=3,
                             spec={"slots": 2, "max_len": 64})
        assert pool.wait_servers(3, timeout=300.0)
        rng = np.random.default_rng(0)
        for rid in range(24):
            pool.submit({"rid": rid,
                         "prompt": rng.integers(
                             0, cfg.vocab_size, size=8).tolist(),
                         "max_new_tokens": 40})
        assert pool.wait_completed(3, timeout=120.0)
        (v1,) = fleet.scale_down(1)
        (v2,) = fleet.scale_down(1)       # v1 is mid-drain: must differ
        assert v1.pilot_id != v2.pilot_id
        held = (pool.lease_holders().get(v1.pilot_id, [])
                + pool.lease_holders().get(v2.pilot_id, []))
        pool.seal()
        # the survivor can only finish if the victims RELEASED their leases
        # (immediate requeue) — a lease-TTL wait would blow the timeout
        assert pool.wait_all(timeout=120.0)
        stats = pool.stats()
        assert stats["completed"] == 24 and stats["failed"] == 0
        assert stats["duplicates"] == 0
        if held:                          # victims were busy when drained
            assert stats["replays"] >= 1
        for v in (v1, v2):
            v.join(30.0)
            assert v.state == "drained"
    finally:
        pool.close()
        fleet.drain_all()
        fleet.join_all(30.0)


def test_chaos_drill_quarantines_poison_and_serves_the_rest(runs):
    """Gray-failure hardening on torch servers: a stalled server (its
    frozen leases revoked by the progress watchdog) and one poison request
    that kills each pilot fetching it until the pool quarantines it.  The
    poison settles failed, every other request completes once with the
    plain fleet's tokens, and no surviving server leaks a KV block."""
    policy = RobustnessPolicy(stall_deadline=0.5, sick_cooldown=0.5,
                              hedging=False, quarantine_after=2)
    plan = FaultPlan(faults=[FaultSpec(kind="stall", at_s=0.05,
                                       duration_s=1.0)], poison=True)
    out = serve_fleet(ARCH, N, 3, robustness=policy, chaos_plan=plan,
                      poison=1, registry=ExecutableRegistry(), **FLEET)
    assert out["drained"]
    assert out["quarantined_rids"] == out["poison_rids"] == [N]
    assert "quarantined" in out["fail_reasons"][N]
    assert out["completed"] == N and out["failed"] == 1
    assert sorted(out["results"]) == list(range(N))
    assert out["results"] == runs["ok"]["results"]
    assert sum(out["chaos"]["poison_kills"].values()) == 2
    assert any(e["kind"] == "stall" and "error" not in e
               for e in out["chaos"]["log"])
    assert out["leaked_blocks"] == 0
    _servers_clean(out)


def test_autoscaled_fleet_scales_to_zero_without_flapping(runs):
    """Two bursts into a 1-pilot fleet under the demand-driven autoscaler
    (scale-to-zero allowed): the fleet grows on the backlog, sheds every
    pilot once the pool drains, never flaps, and each stream equals the
    direct engine's."""
    trace = make_trace(get_smoke_config(ARCH).vocab_size, N, max_len=MAX_LEN)
    schedule = make_bursty_schedule(trace, bursts=2, burst_s=0.3, gap_s=1.0)
    policy = AutoscalePolicy(min_pilots=0, max_pilots=3,
                             slots_per_pilot=SLOTS, interval=0.1,
                             up_cooldown=0.3, down_cooldown=0.8,
                             down_stable_ticks=3)
    out = serve_fleet_schedule(ARCH, schedule, slots=SLOTS, max_len=MAX_LEN,
                               policy=policy, initial_pilots=1,
                               lease_ttl=FLEET["lease_ttl"], smoke=True,
                               device=CPU)
    assert out["drained"] and out["completed"] == N and out["failed"] == 0
    assert out["duplicates"] == 0
    assert out["autoscale"]["flaps"] == 0
    assert out["autoscale"]["scale_ups"] >= 1
    assert out["scaled_to_zero"]
    assert out["results"] == runs["direct"]["streams"]


def test_an_idle_fleet_server_meters_no_steps():
    """A fleet server's idle polls are not steps: the pilot's monitor kills
    a payload whose step-time EWMA exceeds 3x the fleet median of the
    pilots' step times, and metered, the ~0.1 ms idle polls of the servers
    that have nothing to do set that median (`straggler_witness`).  Idle,
    the payload meters nothing; serving a request, it meters each of its
    ticks."""
    sim = ClusterSim(device=CPU)
    pool = FleetDispatcher(lease_ttl=60.0)
    fleet = sim.spawn_fleet(1, PilotConfig(max_payloads=1, idle_grace=0.3))
    try:
        fleet.submit_servers(SERVER, pool.name, n=1,
                             spec={"slots": 2, "max_len": 64})
        assert pool.wait_servers(1, timeout=300.0)
        (pilot,) = fleet.members

        def payload():
            (e,) = [e for e in pilot.proctable.entries(
                uid=PAYLOAD_UID, viewer_uid=PILOT_UID)
                if e.state == "running"]
            return e

        time.sleep(0.5)                   # ~10 polls, each parked 0.05 s
        assert payload().steps_done == 0
        pool.submit({"rid": 0, "prompt": [1, 2, 3], "max_new_tokens": 4})
        assert pool.wait_completed(1, timeout=60.0)
        assert payload().steps_done == 4  # the admitting tick and 3 more
        assert pilot.history == []        # the payload still serves
    finally:
        pool.close()
        fleet.drain_all()
        fleet.join_all(30.0)
    assert [h["exitcode"] for h in pilot.history] == [0]
    assert pilot.history[0]["monitor_actions"] == []


def straggler_witness(pkg: str, *, n_servers: int = 3, idle_s: float = 0.5,
                      seed: int = 0) -> dict:
    """One request at a time into a fleet of ``n_servers`` smoke servers of
    package ``pkg`` (``"repro"``, the reference, or ``"repro_torch"`` on
    the CPU), a quiet spell of ``idle_s`` between the two: one server
    serves while the others poll an empty pool.  Returns the servers' exit
    codes, the pilots' monitor actions and how many of the 2 requests
    completed within 30 s of their submission (a lease held by a killed
    server waits out its 60 s TTL)."""
    import importlib

    mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    kw = {"device": CPU} if pkg == "repro_torch" else {}
    cfg = mod("configs.base").get_smoke_config(ARCH)
    trace = mod("launch.serve").make_trace(cfg.vocab_size, 2, max_len=MAX_LEN,
                                           seed=seed)
    sim = mod("core.cluster").ClusterSim(**kw)
    pool = mod("serving.dispatch").FleetDispatcher(lease_ttl=60.0)
    fleet = sim.spawn_fleet(n_servers, mod("core.pilot").PilotConfig(
        max_payloads=1, idle_grace=0.3))
    done = []
    try:
        fleet.submit_servers(mod("core.images").PayloadImage(
            ARCH, "smoke", "serve"), pool.name, n=n_servers,
            spec={"slots": SLOTS, "max_len": MAX_LEN})
        assert pool.wait_servers(n_servers, timeout=300.0)
        for k, entry in enumerate(trace):
            if k:
                time.sleep(idle_s)
            pool.submit(entry)
            done.append(pool.wait_completed(k + 1, timeout=30.0))
    finally:
        pool.close()
        fleet.drain_all()
        fleet.join_all(30.0)
    hist = [h for p in fleet.members for h in p.history]
    return {"pkg": pkg, "n_servers": n_servers, "idle_s": idle_s,
            "seed": seed, "completed_in_time": sum(done),
            "exitcodes": sorted(h["exitcode"] for h in hist),
            "monitor_actions": [a for h in hist
                                for a in h.get("monitor_actions", [])]}


def test_a_server_serving_beside_idle_ones_is_no_straggler():
    """One of 3 servers serves while 2 poll an empty pool, then a quiet
    spell, then one more request: no pilot's monitor kills a server, both
    requests complete at once, every server exits 0.  The reference's
    loop meters its idle polls, and the same run of it (``python
    tests/test_torch_fleet.py``) kills the serving server as a straggler."""
    out = straggler_witness("repro_torch")
    assert out["monitor_actions"] == [], out
    assert out["completed_in_time"] == 2, out
    assert out["exitcodes"] == [0, 0, 0], out


# ---------------------------------------------------------------------------
# the engine pieces the fleet loop calls
# ---------------------------------------------------------------------------

def _request(entry):
    return Request(rid=entry["rid"], prompt=np.asarray(entry["prompt"],
                                                       np.int32),
                   max_new_tokens=int(entry["max_new_tokens"]))


@pytest.mark.parametrize("kw", [dict(), dict(kv="dense"),
                                dict(spec="draft")],
                         ids=["paged", "dense", "self_draft"])
def test_warm_install_leaves_an_idle_engine(kw):
    """``warm_install`` admits, decodes and evicts one dummy per bucket,
    then leaves the engine idle: no leaked block, zeroed counters (the
    port's ITL samples and launches too), nothing in ``done``; the first
    live request after it streams bitwise as on a fresh engine."""
    cfg = get_smoke_config(ARCH)
    entry = make_trace(cfg.vocab_size, 1, max_len=MAX_LEN, seed=3)[0]
    fresh = build_engine(cfg, SLOTS, MAX_LEN, device=CPU, **kw)
    fresh.submit(_request(entry))
    fresh.run()
    eng = build_engine(cfg, SLOTS, MAX_LEN, device=CPU, **kw)
    eng.warm_install()
    assert not (eng._live or eng.queue or eng._jobs or eng.done)
    assert eng.block_leaks() == 0
    stats = eng._stats(0, 1.0)
    for k in ("decode_steps", "d2h_transfers", "idle_slot_steps",
              "blocked_admissions", "kv_peak_live_tokens", "completed"):
        assert stats[k] == 0, k
    assert stats["itl_max_s"] is None and stats["launches"] == {}
    assert stats["prefix_hit_rate"] == 0.0 == stats["acceptance_rate"]
    eng.submit(_request(entry))
    eng.run()
    assert eng.done[entry["rid"]].tokens == fresh.done[entry["rid"]].tokens
    assert eng.block_leaks() == 0


def test_unified_engine_rejects_a_handoff_through_the_pool():
    """A KV handoff resumes only on a role="decode" engine:
    a unified server's ``submit`` raises, so the fleet loop ``reject``s the
    entry and the pool settles it failed, while the rest complete."""
    eng = build_engine(get_smoke_config(ARCH), SLOTS, MAX_LEN, device=CPU)
    with pytest.raises(ValueError, match="cannot import a KV handoff"):
        eng.submit(Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                           handoff=object()))
    sim = ClusterSim(device=CPU)
    # one attempt: the rejection settles the handoff; no lease may expire
    pool = FleetDispatcher(lease_ttl=60.0, max_attempts=1)
    fleet = sim.spawn_fleet(1, PilotConfig(max_payloads=2, idle_grace=0.3))
    try:
        (tid,) = fleet.submit_servers(SERVER, pool.name, n=1,
                                      spec={"slots": 2, "max_len": 64})
        assert pool.wait_servers(1, timeout=300.0)
        pool.submit({"rid": 0, "prompt": [1, 2, 3], "max_new_tokens": 4,
                     "handoff": {"plen": 16}})
        pool.submit({"rid": 1, "prompt": [1, 2, 3], "max_new_tokens": 4})
        pool.seal()
        assert pool.wait_all(timeout=60.0)
        recs = pool.records()
        assert recs[0].failed and recs[0].fail_reason == \
            "rejected by every server"
        assert recs[1].tokens is not None and len(recs[1].tokens) == 5
    finally:
        pool.close()
        fleet.drain_all()
        fleet.join_all(30.0)
    deadline = time.monotonic() + 30.0
    while sim.repo.result(tid) is None and time.monotonic() < deadline:
        time.sleep(0.05)
    fl = sim.repo.result(tid).telemetry["serve"]["fleet"]
    assert fl["fetched"] == 1 and fl["leaked_blocks"] == 0


def test_fleet_mesh_raises_naming_item_8():
    """A fleet of servers on a mesh whose data axis is above 1 serves:
    each pilot's slice holds the (2, 1) mesh, every request is answered
    once, bitwise ``serve_direct``'s on one device (a (1, 2) fleet:
    tests/test_torch_tp.py)."""
    trace = make_trace(get_smoke_config(ARCH).vocab_size, 4, max_len=MAX_LEN,
                       seed=0)
    out = serve_fleet(ARCH, 4, 2, mesh_shape=(2, 1), trace=trace, **FLEET)
    direct = serve_direct(get_smoke_config(ARCH), 4, SLOTS, MAX_LEN,
                          trace=trace, device=CPU)
    assert out["drained"] and out["completed"] == 4
    assert out["results"] == direct["streams"]
    served = [s for s in out["servers"] if s["serve"].get("fleet")]
    assert served and all(s["serve"]["mesh_devices"] == 2 for s in served)


def test_fleet_cli_serves_and_kills(capsys):
    """``python -m repro_torch.launch.serve --pilots 2 --fail-at 2`` on the
    CPU: the pool's stats as JSON, every request completed, one pilot
    failed."""
    import json

    from repro_torch.launch.serve import main
    code = main(["--pilots", "2", "--fail-at", "2", "--requests", "6",
                 "--slots", "2", "--max-len", "64", "--smoke", "--device",
                 "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and out["drained"] and out["completed"] == 6
    assert len(out["failed_pilots"]) == 1 and "results" not in out


if __name__ == "__main__":
    # the witness on both packages: python tests/test_torch_fleet.py
    # (PYTHONPATH=src JAX_PLATFORMS=cpu), one JSON line a run
    import json
    torch.set_num_threads(1)
    for pkg in ("repro", "repro_torch"):
        for n_servers in (1, 3):
            for idle_s in (0.5, 2.0):
                for seed in range(3):
                    print(json.dumps(straggler_witness(
                        pkg, n_servers=n_servers, idle_s=idle_s,
                        seed=seed)), flush=True)
