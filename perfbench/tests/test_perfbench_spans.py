"""The readers of the program's spans (``perfbench/spans.py`` and the ten
metrics that use it): each reads a number in a traced run of the smoke
checkout; a span before the window or inside the profiled sub-window is
left out; a ring that dropped spans newer than the window's start, an
export whose limit cut them, or a run without a trace (a program without
the recorder), reads None."""

import time

import pytest

from perfbench import bench
from perfbench import spans as spans_mod
from perfbench.run import execute
from perfbench.tests.smoke import checkout
from repro_torch.core import spans

LIMITS = {"logit_gap": 0.03, "wrong_length": 0, "failed": 0}
METRICS = ("lease_wait_ms.p95", "admit_wait_ms.p95", "admit_ms.p50",
           "decode_ms.p50", "loop_host_ms.p50", "fetch_ms.p50",
           "complete_ms.p50", "renew_ms.p50", "report_ms.p50",
           "graph_captures")


@pytest.fixture(scope="module")
def smoke_root(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("bench"), limits=LIMITS)


@pytest.fixture
def one_thread_per_op():
    """The server's ticks stay short beside the test run's other workers
    (as in tests/test_torch_fleet.py), so the window holds many."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_each_metric_reads_a_number(smoke_root, monkeypatch,
                                    one_thread_per_op):
    """A traced smoke run reads all ten; its spans cover the window with
    ticks, each busy tick's phases sum to it, and each request's three
    parts to its time to first token."""
    from perfbench import serve
    runs = []

    def run(*a, **kw):
        out = serve_run(*a, **kw)
        runs.append(dict(out))         # (``execute`` drops its profile)
        return out
    serve_run = serve.run
    monkeypatch.setattr(serve, "run", run)
    line, _ = execute("granite-smoke.tiny", 2 ** 33 + 7, 3.0, True, "cpu",
                      root=smoke_root, t_process=time.monotonic())
    (out,) = runs
    acc = spans_mod.accounting(spans_mod.load(out), {
        r["rid"]: r["first"] for r in out["requests"]})
    assert acc["tick_cover"] > 0.95 and acc["busy_ticks"] > 0
    assert acc["children_within"] > 0.9
    assert acc["requests"] > 0 and acc["ttft_within"] == 1.0
    got = {m: line["metrics"][m]["value"] for m in METRICS}
    assert got["graph_captures"] == 0        # the CPU captures no graph
    for m in METRICS[:-1]:
        assert got[m] > 0, (m, got)
    assert got["loop_host_ms.p50"] >= got["renew_ms.p50"]
    assert line["correct"] is True
    b = bench.load_benchmark()
    units = {m["name"]: m["unit"] for m in b["per_layer"]}
    assert {m: line["metrics"][m]["unit"] for m in METRICS} == {
        m: units[m] for m in METRICS}


def _run(rec, t0, t1, prof_t0=None, limit=None):
    """A run record holding ``rec``'s export (its newest ``limit`` spans),
    its window [t0, t1) and its profiled sub-window from ``prof_t0``
    (seconds)."""
    return {"t0": t0 / 1e9, "t1": t1 / 1e9,
            "profile": None if prof_t0 is None else {"t0": prof_t0 / 1e9},
            "telemetry": {"trace": rec.export(limit=limit)}}


def _serve(rec, t, admit_ms, decode_ms, rid, bucket=1024):
    """One tick at ``t`` (ns): a request submitted at ``t`` and leased
    1 ms later, admitted at ``t`` + 3 ms in ``admit_ms``, then a decode
    of ``decode_ms``, and the loop's phases: fetch 2 ms, completions
    0.1 ms, a renewal of ``decode_ms`` / 50 ms, the report 0.1 ms;
    returns the tick's end."""
    ms = 1_000_000
    n = rec.intern
    tick = rec.begin(n("fleet.tick"), t)
    fetch = rec.begin(n("fleet.fetch"), t)
    rec.record(n("pool.wait"), t, t + ms, rid=rid, attr=1)
    rec.end(fetch, t + 2 * ms)
    step = rec.begin(n("engine.step"), t + 2 * ms)
    a1 = t + 3 * ms + admit_ms * ms
    rec.record(n("engine.admit"), t + 3 * ms, a1, rid=rid, attr=bucket)
    rec.record(n("engine.decode"), a1, a1 + decode_ms * ms)
    s1 = a1 + decode_ms * ms
    rec.end(step, s1)
    renew = decode_ms * ms // 50
    rec.record(n("fleet.complete"), s1, s1 + ms // 10)
    rec.record(n("fleet.renew"), s1 + ms // 10, s1 + ms // 10 + renew,
               attr=1)
    end = s1 + ms // 5 + renew
    rec.record(n("fleet.report"), end - ms // 10, end)
    rec.end(tick, end, attr=1)
    return end


def test_only_the_window_before_the_profiler_is_read():
    """Ticks before the window's start and inside the profiled sub-window
    carry other lengths: none of them shows in any reading."""
    rec = spans.Recorder(1 << 10)
    t = 10 ** 12
    for i in range(3):                       # before the window
        t = _serve(rec, t, 90, 30, rid=i)
    t0 = t
    for i in range(3, 8):                    # the window
        t = _serve(rec, t, 40 + i, 10, rid=i)
    rec.record(rec.intern("graph.capture"), t, t + 1)
    t = _serve(rec, t + 2, 40, 10, rid=8)
    prof = t
    for i in range(9, 12):                   # the profiled sub-window
        t = _serve(rec, t, 90, 30, rid=i)
    rec.record(rec.intern("graph.capture"), t, t + 1)
    run = _run(rec, t0, t + 2, prof)
    read = {m: bench.reader(m).read(run) for m in METRICS}
    assert read == {"lease_wait_ms.p95": pytest.approx(1.0),
                    "admit_wait_ms.p95": pytest.approx(2.0),
                    "admit_ms.p50": pytest.approx(44.5),
                    "decode_ms.p50": pytest.approx(10.0),
                    "loop_host_ms.p50": pytest.approx(2.4),
                    "fetch_ms.p50": pytest.approx(2.0),
                    "complete_ms.p50": pytest.approx(0.1),
                    "renew_ms.p50": pytest.approx(0.2),
                    "report_ms.p50": pytest.approx(0.1),
                    "graph_captures": 1}
    # without a profiled sub-window the window runs to t1
    whole = _run(rec, t0, t + 2)
    assert bench.reader("graph_captures").read(whole) == 2
    assert bench.reader("decode_ms.p50").read(whole) == pytest.approx(10.0)
    assert bench.reader("admit_ms.p50").read(whole) == pytest.approx(46.0)


def test_a_request_admitted_again_after_the_window_is_not_the_windows():
    """A request whose lease was lost after the window (the profiler's
    stop holds the host) is admitted again there: its time to first
    token is that attempt's, so the window's lease and queue readings
    leave it out; a replay inside the window counts with its last lease,
    from the first submit."""
    rec = spans.Recorder(1 << 10)
    t0 = t = 10 ** 12
    for i in range(4):
        t = _serve(rec, t, 40, 10, rid=i)
    t = _serve(rec, t, 40, 10, rid=3)        # replayed inside the window
    prof = t
    t = _serve(rec, t, 40, 10, rid=1)        # again after the window
    run = _run(rec, t0, t + 1, prof)
    tr = spans_mod.load(run)
    leases = spans_mod._leases(tr)
    assert [rid for rid, _, _ in leases] == [0, 2, 3]
    (_, w3, a3), = [x for x in leases if x[0] == 3]
    assert tr.t0[a3] > tr.t0[max(i for i in tr.inside("engine.admit")
                                 if tr.rid[i] == 3 and i != a3)]
    assert tr.t1[w3] <= tr.t0[a3]
    assert spans_mod.requests(tr).tolist() == [
        pytest.approx([1.0, 2.0, 40.0])] * 3


def test_the_main_bucket_is_the_most_common_one():
    rec = spans.Recorder(1 << 10)
    t0 = t = 10 ** 12
    for i, (bucket, ms) in enumerate([(1024, 60), (512, 20), (1024, 70),
                                      (512, 30), (1024, 80), (2047, 200)]):
        t = _serve(rec, t, ms, 10, rid=i, bucket=bucket)
    assert bench.reader("admit_ms.p50").read(_run(rec, t0, t + 1)) == \
        pytest.approx(70.0)


def test_a_ring_that_dropped_spans_of_the_window_reads_nothing():
    rec = spans.Recorder(16)
    t = 10 ** 12
    t = _serve(rec, t, 40, 10, rid=0)
    t0 = t
    for i in range(1, 4):                    # 9 spans a tick: 36 in all
        t = _serve(rec, t, 40, 10, rid=i)
    run = _run(rec, t0, t + 1)
    assert run["telemetry"]["trace"]["dropped"] == 20
    assert spans_mod.load(run) is None
    assert all(bench.reader(m).read(run) is None for m in METRICS)
    # what was dropped ended before the window: the window reads
    rec2 = spans.Recorder(16)
    t = 10 ** 12
    for i in range(3):
        t = _serve(rec2, t, 40, 10, rid=i)
    t0 = t + 10 ** 9
    t = _serve(rec2, t0, 40, 10, rid=9)
    run = _run(rec2, t0, t + 1)
    assert run["telemetry"]["trace"]["dropped"] > 0
    assert bench.reader("decode_ms.p50").read(run) == pytest.approx(10.0)


def test_an_export_cut_inside_the_window_reads_nothing():
    """The payload's exit trace holds its newest spans only: cut inside
    the window it reads nothing; cut before the window, the window reads
    as the whole export does."""
    rec = spans.Recorder(1 << 10)
    t = 10 ** 12
    for i in range(3):
        t = _serve(rec, t, 40, 10, rid=i)
    t0 = t + 10 ** 9
    t = _serve(rec, t0, 40, 10, rid=9)
    for limit in (12, 9):                    # one tick: 9 spans
        run = _run(rec, t0, t + 1, limit=limit)
        assert run["telemetry"]["trace"]["cut"] == 36 - limit
        assert run["telemetry"]["trace"]["dropped"] == 0
        assert spans_mod.load(run) is not None
        assert bench.reader("decode_ms.p50").read(run) == \
            pytest.approx(10.0)
    run = _run(rec, t0, t + 1, limit=5)
    assert spans_mod.load(run) is None
    assert all(bench.reader(m).read(run) is None for m in METRICS)


def test_a_run_without_a_trace_reads_nothing():
    run = {"t0": 1.0, "t1": 2.0, "profile": None, "telemetry": {}}
    assert all(bench.reader(m).read(run) is None for m in METRICS)
