"""A configuration, a mix, a cell and a per-layer metric are found by
name once their files and entries exist: adding them edits no file."""

import json

from perfbench import bench
from perfbench.tests.smoke import checkout


def test_new_cell_from_data_files_only(tmp_path):
    root = checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*")
              if p.is_file()}
    here = root / "perfbench"
    (here / "traffic" / "burst.json").write_text(json.dumps(
        {"name": "burst", "kind": "closed_loop", "clients": 2,
         "prompt_tokens": {"dist": "log_normal", "median": 8, "sigma": 0.1,
                           "low": 8, "high": 9},
         "output_tokens": {"dist": "log_normal", "median": 4, "sigma": 0.1,
                           "low": 4, "high": 5},
         "warmup_s": 0.1, "drain_s": 5, "profile_s": 0.1,
         "check_requests": 1}))
    c = json.loads((here / "configs" / "mamba2-smoke.json").read_text())
    c["name"] = "mamba2-other"
    (here / "configs" / "mamba2-other.json").write_text(json.dumps(c))
    (here / "metrics" / "queue_depth.py").write_text(
        "def read(run):\n    return 3.0\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "mamba2-other", "source": "x",
                         "file": "perfbench/configs/mamba2-other.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "mamba2-other.burst",
                           "config": "mamba2-other", "traffic": "burst",
                           "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "queue_depth", "unit": "count",
                           "better": "lower", "source": "program_counter",
                           "layer": "client pool", "moves": "setup_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    loaded = bench.load_benchmark(root)
    w = bench.workload(loaded, "mamba2-other.burst")
    assert bench.config(loaded, w["config"], root)["name"] == "mamba2-other"
    assert bench.mix(w["traffic"], here)["clients"] == 2
    names = [m["name"] for m in bench.per_layer(loaded, w["name"])]
    assert "queue_depth" in names            # no list: every setup_s cell
    assert "tick_ms.p50" not in names        # its list names other cells
    assert bench.reader("queue_depth", here).read({}) == 3.0
    assert {m["name"] for m in bench.end_to_end(loaded, w["name"])} == {
        "setup_s"}
    for p, data in before.items():           # nothing that was there moved
        assert p.read_bytes() == data


def test_every_metric_has_a_reader():
    b = bench.load_benchmark()
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(bench.reader(m["name"]).read), m["name"]
    for w in b["workloads"]:
        bench.config(b, w["config"])
        bench.mix(w["traffic"])
