"""A run's last line holds exactly the contract's keys, the numbers
compared come last, and a run without the chips prints nothing."""

import subprocess
import sys
import time
from pathlib import Path

import pytest

from perfbench.run import execute
from perfbench.tests.smoke import checkout

ROOT = Path(__file__).resolve().parents[2]
LIMITS = {"logit_gap": 0.03, "wrong_length": 0, "failed": 0}


@pytest.fixture(scope="module")
def smoke_root(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("bench"), limits=LIMITS)


@pytest.mark.parametrize("traced", [False, True])
def test_result_keys(smoke_root, traced):
    line, table = execute("mamba2-smoke.tiny", 2 ** 32 + 3, 1.0, traced,
                          "cpu", root=smoke_root,
                          t_process=time.monotonic())
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown", "checks"] if traced else ["checks"]
    assert list(line) == want
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "setup_s" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {"setup_s", "serve_tokens_per_s",
                                        "ttft_p95_ms", "tpot_p95_ms"}
    assert line["correct"] is True and line["attempted"] > 0
    assert set(table) == {"logit_gap", "wrong_length", "failed"}
    assert all(set(v) == {"value", "limit"} for v in table.values())


def test_no_chip_exits_without_a_result():
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "granite-moe-3b-a800m.chat", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    if r.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert r.returncode == 2 and r.stdout == ""


def test_without_the_program_exits_without_a_result(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    import shutil
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "-c",
                        "import sys, runpy; sys.argv[1:] = ['--workload', "
                        "'granite-moe-3b-a800m.chat', '--seed', '1', "
                        "'--seconds', '1']; "
                        "from perfbench import run; "
                        "sys.exit(run.execute('granite-moe-3b-a800m.chat', 1,"
                        " 1.0, False, 'cpu') and 0)"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120, env={"PATH": "/usr/bin:/bin",
                                         "PYTHONPATH": str(tmp_path)})
    assert r.returncode != 0 and r.stdout == ""
    assert "repro_torch" in r.stderr
