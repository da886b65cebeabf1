"""The port's span recorder (``repro_torch.core.spans``) and the spans of
its serve path.

The recorder: parent links and request ids, the ring's bound and its
``dropped`` count, one thread's export and its limit, the switch that
turns every call site off, an export that survives JSON, threads that
record at once, and the clock pair that maps a span onto
``torch.profiler``'s clock (a ``record_function`` marker recorded inside
a span lies inside it).  The engine's step span is its tick time.  A
smoke-size fleet server on the CPU exports its own thread's spans: every
busy ``fleet.tick`` holds one ``engine.step`` and the four loop phases,
which sum to it; each request's lease wait, engine queue and admission
sum to the pool's ``first_token_s``; a bucket larger than
the admission graphs' shared output makes them be captured again, and
each capture is a ``graph.capture`` span.  On the card (``gpu``): the
mapped ``engine.decode`` span encloses its step's device-to-host copy in
the profiler's trace.
"""

from __future__ import annotations

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.core import spans
from repro_torch.core.cluster import ClusterSim
from repro_torch.core.images import PayloadImage
from repro_torch.core.pilot import PilotConfig
from repro_torch.launch.serve import build_engine, make_trace
from repro_torch.serving.dispatch import FleetDispatcher
from repro_torch.serving.engine import Request

ARCH = "smollm-360m"
SLOTS, MAX_LEN = 2, 64
LOOP = ("fleet.fetch", "engine.step", "fleet.complete", "fleet.renew",
        "fleet.report")


def _rows(export: dict) -> list[dict]:
    """The export's spans as one dict each, names and tags as strings."""
    names, cols = export["names"], export["spans"]
    rows = [dict(zip(cols, vals)) for vals in zip(*cols.values())]
    for r in rows:
        r["name"] = names[r["name"]]
        r["tag"] = names[r["tag"]] if r["tag"] >= 0 else None
    return rows


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_parents_and_rids():
    rec = spans.Recorder(64)
    a, b, c = (rec.intern(s) for s in ("a", "b", "c"))
    outer = rec.begin(a, 10, rid=7, attr=2)
    inner = rec.begin(b, 11)
    leaf = rec.record(c, 12, 13, rid=7, tag=rec.intern("server-1"))
    rec.end(inner, 14)
    after = rec.event(c, 15)
    rec.end(outer, 20, attr=3)
    top = rec.record(c, 21, 22)
    by_id = {r["id"]: r for r in _rows(rec.export())}
    assert by_id[outer] == {"id": outer, "name": "a", "t0": 10, "t1": 20,
                            "parent": -1, "rid": 7, "attr": 3, "tag": None,
                            "thread": rec.thread_index()}
    assert by_id[inner]["parent"] == outer
    assert by_id[leaf]["parent"] == inner and by_id[leaf]["rid"] == 7
    assert by_id[leaf]["tag"] == "server-1"
    assert by_id[after]["parent"] == outer
    assert by_id[after]["t0"] == by_id[after]["t1"] == 15
    assert by_id[top]["parent"] == -1
    assert {r["thread"] for r in by_id.values()} == {rec.thread_index()}


def test_ending_a_span_closes_what_it_left_open():
    rec = spans.Recorder(64)
    a = rec.intern("a")
    outer = rec.begin(a, 1)
    rec.begin(a, 2)                          # never ended
    rec.end(outer, 5)
    after = rec.record(a, 6, 7)
    rows = {r["id"]: r for r in _rows(rec.export())}
    assert rows[after]["parent"] == -1
    assert set(rows) == {outer, after}       # the open span is not exported


def test_the_ring_is_bounded_and_counts_what_it_dropped():
    rec = spans.Recorder(8)
    n = rec.intern("x")
    for i in range(20):
        rec.record(n, 100 + 10 * i, 105 + 10 * i)
    e = rec.export()
    assert e["capacity"] == 8 and e["dropped"] == 12
    assert e["spans"]["id"] == list(range(12, 20))
    assert e["kept_since_ns"] == 105 + 10 * 12
    assert len(spans.RECORDER.id) == spans.CAPACITY >= 2 ** 17
    assert e["cut"] == 0
    assert spans.Recorder(8).export()["dropped"] == 0
    with pytest.raises(ValueError):
        spans.Recorder(12)


def test_export_since_keeps_what_ends_after_it():
    rec = spans.Recorder(64)
    n = rec.intern("x")
    for i in range(10):
        rec.record(n, 1_000 * i, 1_000 * i + 500)
    got = rec.export(since_ns=5_000)["spans"]
    assert got["t1"] == [5_500, 6_500, 7_500, 8_500, 9_500]


def test_one_threads_export_and_its_limit():
    """``thread`` keeps the spans one thread recorded; ``limit`` keeps
    the newest, counts the rest in ``cut`` and moves ``kept_since_ns``
    past the start of every span it left out (a span recorded whole is
    claimed at its end, so a newer claim can start before an older one)."""
    rec = spans.Recorder(64)
    n = rec.intern("x")
    other = []
    th = threading.Thread(target=lambda: other.append(
        (rec.thread_index(), rec.record(n, 1, 2))))
    th.start()
    th.join()
    (other_thread, other_id), = other
    mine = rec.thread_index()
    assert mine != other_thread
    tick = rec.begin(n, 10)
    ids = [rec.record(n, 10 + i, 11 + i) for i in range(4)]
    late = rec.record(n, 5, 20)              # claimed last, started early
    rec.end(tick, 30)
    e = rec.export(thread=mine)
    assert e["spans"]["id"] == [tick, *ids, late]
    assert set(e["spans"]["thread"]) == {mine}
    assert e["cut"] == 0 and e["kept_since_ns"] is None
    assert rec.export(thread=other_thread)["spans"]["id"] == [other_id]
    cut = rec.export(thread=mine, limit=2)
    assert cut["spans"]["id"] == [ids[3], late]
    assert cut["cut"] == 4 and cut["kept_since_ns"] == 12
    assert rec.export(limit=7)["spans"]["id"] == [other_id, tick, *ids,
                                                   late]


def test_export_survives_json():
    rec = spans.Recorder(16)
    n = rec.intern("x")
    p = rec.begin(n, time.monotonic_ns(), rid=3, tag=rec.intern("s"))
    rec.record(n, time.monotonic_ns(), time.monotonic_ns(), attr=1024)
    rec.end(p, time.monotonic_ns())
    e = rec.export()
    assert json.loads(json.dumps(e)) == e
    assert len(e["clock_pairs"]) == 2
    assert all(len(pair) == 2 for pair in e["clock_pairs"])


def test_threads_record_at_once():
    """More threads than cores, switching every few microseconds: every
    span is kept once, whole, under its own thread's parent."""
    rec = spans.Recorder(1 << 14)
    outer, inner = rec.intern("outer"), rec.intern("inner")
    n_threads, per = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(t):
            for i in range(per):
                o = rec.begin(outer, i, rid=t)
                rec.record(inner, i, i + 1, rid=t, attr=i)
                rec.end(o, i + 2)
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60.0)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    rows = _rows(rec.export())
    assert len(rows) == 2 * n_threads * per
    assert len({r["id"] for r in rows}) == len(rows)
    by_id = {r["id"]: r for r in rows}
    for r in rows:
        if r["name"] == "inner":
            parent = by_id[r["parent"]]
            assert parent["name"] == "outer" and parent["rid"] == r["rid"]
            assert parent["t0"] == r["attr"] == r["t0"]
        else:
            assert r["parent"] == -1 and r["t1"] == r["t0"] + 2


def test_the_clock_pair_maps_a_span_onto_the_profiler_clock():
    """A ``record_function`` marker recorded inside a span lies inside the
    span once it is mapped through the export's clock pair (CPU
    activity), within 1 ms."""
    rec = spans.Recorder(16)
    n = rec.intern("x")
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic_ns()
        with torch.profiler.record_function("spans-marker"):
            time.sleep(0.005)
        rec.record(n, t0, time.monotonic_ns())
    e = rec.export()
    m, u = e["clock_pairs"][-1]
    (span,) = _rows(e)
    marks = [(ev.start_ns(), ev.start_ns() + ev.duration_ns())
             for ev in prof.profiler.kineto_results.events()
             if ev.name() == "spans-marker"]
    assert len(marks) == 1
    s, f = marks[0]
    assert span["t0"] + (u - m) - 1_000_000 <= s
    assert f <= span["t1"] + (u - m) + 1_000_000


# ---------------------------------------------------------------------------
# the serve path's spans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_thread_per_op():
    """(As in tests/test_torch_fleet.py: a server's ticks stay short.)"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fleet_run():
    """One smoke fleet server on the CPU serves 12 requests; the spans it
    exported with its telemetry and the pool's records."""
    cfg = get_smoke_config(ARCH)
    trace = make_trace(cfg.vocab_size, 12, max_len=MAX_LEN, seed=3)
    sim = ClusterSim(device="cpu")
    pool = FleetDispatcher(lease_ttl=2.0)
    fleet = sim.spawn_fleet(1, PilotConfig(max_payloads=1, idle_grace=0.5))
    try:
        (tid,) = fleet.submit_servers(
            PayloadImage(ARCH, "smoke", "serve"), pool.name, n=1,
            spec={"slots": SLOTS, "max_len": MAX_LEN})
        assert pool.wait_servers(1, timeout=300.0)
        pool.submit_trace(trace)
        pool.seal()
        assert pool.wait_all(timeout=300.0)
    finally:
        pool.close()
        fleet.drain_all()
        fleet.join_all(60.0)
    res = sim.repo.result(tid)
    assert res is not None and res.exitcode == 0, res
    return {"rows": _rows(res.telemetry["trace"]),
            "trace": res.telemetry["trace"], "records": pool.records()}


def test_every_busy_tick_holds_the_step_and_the_loop_phases(fleet_run):
    rows = fleet_run["rows"]
    kids: dict[int, list[dict]] = {}
    for r in rows:
        kids.setdefault(r["parent"], []).append(r)
    busy = [r for r in rows if r["name"] == "fleet.tick" and r["attr"] == 1]
    assert len(busy) >= 12
    within = 0
    for t in busy:
        names = sorted(k["name"] for k in kids.get(t["id"], ()))
        assert names == sorted(LOOP), names
        total = sum(k["t1"] - k["t0"] for k in kids[t["id"]])
        within += abs(total - (t["t1"] - t["t0"])) <= 0.02 * (
            t["t1"] - t["t0"])
        for k in kids[t["id"]]:
            assert t["t0"] <= k["t0"] <= k["t1"] <= t["t1"]
    # (the CPU's other threads can take the interpreter between two
    # phases; on the card PERF.md holds it to 99 %)
    assert within >= 0.95 * len(busy), (within, len(busy))
    steps = {r["id"]: r for r in rows if r["name"] == "engine.step"}
    for r in rows:
        if r["name"] in ("engine.decode", "engine.admit"):
            assert r["parent"] in steps, r
    assert {r["name"] for r in rows} >= {
        "pool.wait", "fleet.announce", "engine.admit", "engine.decode"}
    assert not any(r["name"] == "graph.capture" for r in rows)  # (the CPU)
    # the server's own thread, since its start, nothing cut
    assert len({r["thread"] for r in rows}) == 1
    assert fleet_run["trace"]["cut"] == 0


def test_ttft_is_lease_wait_plus_engine_queue_plus_admission(fleet_run):
    rows, records = fleet_run["rows"], fleet_run["records"]
    checked = 0
    for rid, rec in records.items():
        admits = [r for r in rows
                  if r["name"] == "engine.admit" and r["rid"] == rid]
        waits = [r for r in rows if r["name"] == "pool.wait"
                 and r["rid"] == rid and r["t1"] <= admits[-1]["t0"]]
        lease, admit = waits[-1], admits[-1]
        assert lease["t0"] == round(rec.submitted_s * 1e9)
        assert lease["attr"] == rec.attempts and lease["tag"] == rec.server
        total = ((lease["t1"] - lease["t0"]) + (admit["t0"] - lease["t1"])
                 + (admit["t1"] - admit["t0"])) / 1e9
        assert abs(total - rec.first_token_s) <= 1e-3, (rid, total)
        assert admit["attr"] in (16, 32, 63)          # the admit bucket
        checked += 1
    assert checked == 12


def test_the_step_span_is_the_tick_time():
    """`ServeEngine.step`'s span has the stamps of its tick time (the
    ITL, ``_tick_times``), which are ``last_step_ns``; its decode ends with it;
    a step that decodes nothing adds no tick time."""
    eng = build_engine(get_smoke_config(ARCH), SLOTS, MAX_LEN, device="cpu")
    t = time.monotonic_ns()
    eng.step()                               # nothing to do
    assert eng._tick_times == []
    eng.submit(Request(rid=1, prompt=np.arange(5, dtype=np.int32),
                       max_new_tokens=3))
    eng.step()
    eng.step()
    rows = _rows(spans.RECORDER.export(since_ns=t,
                                       thread=spans.thread_index()))
    steps = [r for r in rows if r["name"] == "engine.step"]
    decodes = [r for r in rows if r["name"] == "engine.decode"]
    assert len(steps) == 3 and len(decodes) == 2
    assert [(s["t1"] - s["t0"]) / 1e9 for s in steps[1:]] == \
        eng._tick_times
    assert eng.last_step_ns == (steps[-1]["t0"], steps[-1]["t1"])
    for s, d in zip(steps[1:], decodes):
        assert d["parent"] == s["id"] and d["t1"] == s["t1"]


def test_switched_off_the_serve_path_records_nothing(monkeypatch):
    eng = build_engine(get_smoke_config(ARCH), SLOTS, MAX_LEN, device="cpu")
    monkeypatch.setattr(spans, "enabled", False)
    before = spans.RECORDER.export(since_ns=time.monotonic_ns())
    t = time.monotonic_ns()
    eng.warm_admission()
    eng.warm_install()
    eng.submit(Request(rid=1, prompt=np.arange(5, dtype=np.int32),
                       max_new_tokens=4))
    eng.run()
    assert len(eng.done[1].tokens) == 5
    assert before["spans"]["id"] == []
    assert spans.RECORDER.export(since_ns=t)["spans"]["id"] == []


def test_a_larger_bucket_makes_the_admission_graphs_captured_again(
        monkeypatch):
    """The admission graphs' capture stands in for CUDA on the CPU: each
    "replay" runs the function again, and the shared output takes the
    first capture's output, as under a CUDA capture.  A bucket larger
    than that output becomes the shared one and drops the other graphs,
    so the smaller bucket's next admission captures again: three
    ``graph.capture`` spans (prefill 16, 64, 16), each inside the
    ``engine.admit`` that made it."""
    from repro_torch.serving import graph

    capturing = []

    def capture(self, fn, device, reset, warmup, pool):
        self.first = fn()
        capturing.append(True)
        try:
            self.out = fn()
        finally:
            capturing.pop()
        self.launches, self.warm_launches = {}, {}
        self.graph = type("Replay", (), {"replay": staticmethod(fn)})()

    monkeypatch.setattr(graph.StepGraph, "_capture", capture)
    monkeypatch.setattr(graph, "_capturing", lambda device: bool(capturing))
    eng = build_engine(get_smoke_config(ARCH), SLOTS, 128, device="cpu")
    eng._admit_pool = "cpu"                  # admissions go through graphs
    t = time.monotonic_ns()
    for rid, n in enumerate((10, 40, 12)):
        eng.submit(Request(rid=rid, prompt=np.arange(n, dtype=np.int32),
                           max_new_tokens=2))
        while eng.queue or eng._live:
            eng.step()
    rows = _rows(spans.RECORDER.export(since_ns=t))
    caps = [r for r in rows if r["name"] == "graph.capture"]
    assert [(r["tag"], r["attr"]) for r in caps] == [
        ("prefill", 16), ("prefill", 64), ("prefill", 16)]
    admits = {r["id"]: r for r in rows if r["name"] == "engine.admit"}
    steps = {r["id"] for r in rows if r["name"] == "engine.step"}
    for c in caps:
        assert c["parent"] in steps
        assert any(a["t0"] <= c["t0"] <= c["t1"] <= a["t1"]
                   for a in admits.values())
    assert eng._admit_out["prefill"].generation == 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_the_mapped_decode_span_encloses_its_device_to_host_copy():
    """A graphed smoke engine on the card decodes under ``torch.profiler``
    (CUDA activity): each ``engine.decode`` span of the profiled steps,
    mapped through the export's clock pair, encloses the device-to-host
    copy of its step's packed result (the kineto events' clock)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphed engine runs only there")
    eng = build_engine(get_smoke_config(ARCH), SLOTS, MAX_LEN)
    t = time.monotonic_ns()
    eng.warm_admission()
    eng.warm_install()
    caps = [r for r in _rows(spans.RECORDER.export(since_ns=t))
            if r["name"] == "graph.capture"]
    assert {r["tag"] for r in caps} == {"prefill"}
    for rid in range(SLOTS):
        eng.submit(Request(rid=rid, prompt=np.arange(9, dtype=np.int32),
                           max_new_tokens=40))
    for _ in range(3):
        eng.step()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.monotonic_ns()
        for _ in range(8):
            eng.step()
        torch.cuda.synchronize()
    e = spans.RECORDER.export(since_ns=t)
    m, u = e["clock_pairs"][-1]
    decodes = [(r["t0"] + u - m, r["t1"] + u - m) for r in _rows(e)
               if r["name"] == "engine.decode"]
    copies = [(ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == torch.autograd.DeviceType.CUDA
              and "DtoH" in ev.name()]
    assert len(decodes) == 8 and len(copies) >= 8, (len(decodes), copies)
    lead = [min((c0 - d0 for c0, c1 in copies if d0 <= c0 and c1 <= d1),
                default=None) for d0, d1 in decodes]
    print(json.dumps({"decode_spans": decodes, "copies": copies,
                      "copy_after_decode_start_ns": lead}))
    assert all(x is not None for x in lead), lead
