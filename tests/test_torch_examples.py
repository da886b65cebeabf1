"""The paper's examples on the port (``examples/torch/``), on the CPU.

Each example's ``main`` runs in-process with ``--device cpu --smoke`` (the
reference's smoke configs; every kernel wrapper runs its plain version on
CPU tensors) and must return 0 and print the reference example's lines in
its order.  ``fixed_sequence`` and ``late_binding_serve`` are held line for
line against the reference examples, run here with ``JAX_PLATFORMS=cpu``,
with only bind milliseconds and tokens/s masked.  The other three are held
to the reference's print statements: their losses, pilot ids and the step
a killed payload last checkpointed depend on the run (the port's weights
come from its own seeded init, not JAX's), and are checked for what they
must be instead; ``elastic_train``'s plans are compared unmasked with the
reference's ``plan_remesh`` for the same memberships.
"""

from __future__ import annotations

import ast
import contextlib
import importlib.util
import io
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "examples" / "torch"
NAMES = ("fixed_sequence", "late_binding_serve", "quickstart",
         "dynamic_pilot", "elastic_train")
CPU = ("--device", "cpu", "--smoke")
HELD = ("fixed_sequence", "late_binding_serve")   # run against the reference


def _load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  PORT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run():
    """``run(name)``: the example's ``main`` on the CPU at the smoke
    widths, once per module: its return code, its printed lines and its
    record."""
    done = {}

    def get(name):
        if name not in done:
            rec, out = {}, io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = _load(name).main(list(CPU), record=rec)
            done[name] = rc, out.getvalue().splitlines(), rec
        return done[name]

    return get


def _mask(line: str) -> str:
    """A printed line with its run-dependent timings masked: bind
    milliseconds and tokens/s."""
    line = re.sub(r"bind \d+\.\d ms", "bind <ms> ms", line)
    return re.sub(r"\d+\.\d tok/s", "<x> tok/s", line)


@pytest.fixture(scope="module")
def reference():
    """The reference examples of ``HELD``, started together in their own
    processes (JAX on the CPU); ``reference(name)`` waits for one and
    returns its stdout lines."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    procs = {n: subprocess.Popen([sys.executable, f"examples/{n}.py"],
                                 cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for n in HELD}
    outs = {}

    def get(name):
        if name not in outs:
            out, err = procs[name].communicate(timeout=300)
            assert procs[name].returncode == 0, err[-2000:]
            outs[name] = out.splitlines()
        return outs[name]

    yield get
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def test_every_reference_example_has_a_port():
    ref = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    assert ref == sorted(NAMES)
    assert sorted(p.stem for p in PORT.glob("*.py")) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_example_prints_the_reference_lines_in_order(name):
    """Every string the port's example prints, from its f-strings' literal
    parts, in the order the reference example prints them."""
    def literals(path):
        out = []
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "print" and node.args):
                arg = node.args[0]
                parts = ([arg] if isinstance(arg, ast.Constant)
                         else [v for v in getattr(arg, "values", [])
                               if isinstance(v, ast.Constant)])
                out.append((node.lineno, "".join(p.value for p in parts)))
        return [s for _, s in sorted(out)]

    assert literals(PORT / f"{name}.py") == literals(
        ROOT / "examples" / f"{name}.py")


@pytest.mark.parametrize("name", HELD)
def test_held_against_the_reference_run(name, run, reference):
    rc, lines, _ = run(name)
    assert rc == 0
    assert [_mask(s) for s in lines] == [_mask(s) for s in reference(name)]


def test_fixed_sequence_exit_relayed(run):
    rc, _, rec = run("fixed_sequence")
    assert rc == 0 and rec["exit"]["exitcode"] == 0
    assert rec["exit"]["telemetry"]["steps"] == 3
    assert rec["bind"][1] is False
    assert rec["registry"].pull(rec["images"][0], rec["device"]).cached


def test_late_binding_serve_engines(run):
    rc, _, rec = run("late_binding_serve")
    assert rc == 0
    assert [r["bind_cached"] for r in rec["runs"]] == [False, True]
    for r in rec["runs"]:
        st = r["stats"]
        assert st["completed"] == 4 and r["block_leaks"] == 0
        assert st["d2h_transfers"] == st["decode_steps"] > 0
        # the admission's token and a budget of 6 within max_len 64
        assert sorted(len(t) for t in r["tokens"].values()) == [7] * 4


def test_quickstart(run):
    rc, lines, rec = run("quickstart")
    assert rc == 0
    want = ["== direct training =="] + [
        rf"  step {i}: loss \d+\.\d{{4}}" for i in (0, 3, 6, 9)] + [
        "== pilot system: one slice, three payloads, two models =="] + [
        rf"  payload {n}: {a}/{m} exit=0 bind=\d+\.\dms cached=False"
        for n, (a, m) in enumerate((("smollm-360m", "train"),
                                    ("smollm-360m", "decode"),
                                    ("gemma-2b", "decode")), 1)] + [
        re.escape("  repo: {'queued': 0, 'leased': 0, 'done': 3, "
                  "'failed': 0, 'pilots': 0}"), "quickstart OK"]
    assert len(lines) == len(want)
    for got, pat in zip(lines, want):
        assert re.fullmatch(pat, got), (got, pat)
    # random weights: the first loss sits near ln(vocab) and all are finite
    vocab = rec["images"][0].config().vocab_size
    assert all(math.isfinite(x) for x in rec["losses"])
    assert abs(rec["losses"][0] - math.log(vocab)) < 0.5


def test_dynamic_pilot_resumes_from_the_killed_payloads_checkpoint(run):
    rc, lines, rec = run("dynamic_pilot")
    assert rc == 0
    want = [re.escape("== dynamic PoC (paper §4, second YAML): image "
                      "fetched at runtime ==")] + [
        rf"  ran {a}: exit=0 bind_cached=False"
        for a in ("smollm-360m/train", "gemma-2b/decode",
                  "mamba2-370m/decode")] + [
        "== failure injection: lease re-queue \\+ checkpoint resume ==",
        r"  pilot 1 \(pilot-[0-9a-f]{8}\): state=failed \(hard node loss\)",
        r"  pilot 2 \(pilot-[0-9a-f]{8}\): exit=0 resumed_from=(\d+) "
        r"steps_run=(\d+)", "dynamic PoC OK"]
    assert len(lines) == len(want)
    for got, pat in zip(lines, want):
        assert re.fullmatch(pat, got), (got, pat)
    resumed, steps = map(int, re.fullmatch(want[-2], lines[-2]).groups())
    # a checkpoint step (every 10), the last the killed payload wrote
    assert resumed % 10 == 0 and 10 <= resumed < 200
    assert resumed == rec["killed_at"] and steps == 200 - resumed
    assert rec["result"].pilot_id == rec["p2"].pilot_id
    assert rec["p2"].history[0]["bind_cached"] is True
    assert not Path(rec["ckpt_dir"]).exists()      # removed at the end


def test_elastic_train_plans_equal_the_references(run):
    from repro.runtime.elastic import plan_remesh
    rc, lines, rec = run("elastic_train")
    assert rc == 0
    want, old = [], None
    for n_live in (2, 1, 3):
        p = plan_remesh(old, n_live, 16, 256)
        old = p.new_mesh
        want.append(p)
    assert lines == [
        "== elastic scale-down ==",
        f"  2 live pilots -> mesh {want[0].new_mesh.shape} "
        f"(per-slice batch {want[0].new_per_data})",
        f"  after drain (drained) -> mesh {want[1].new_mesh.shape} "
        f"(per-slice batch {want[1].new_per_data}); actions: "
        f"{want[1].actions}",
        "  queue drained by the remaining pilot: {'queued': 0, 'leased': 0, "
        "'done': 4, 'failed': 0, 'pilots': 1}",
        "== elastic scale-up ==",
        f"  3 live pilots -> mesh {want[2].new_mesh.shape} "
        f"(per-slice batch {want[2].new_per_data}); actions: "
        f"{want[2].actions}",
        "elastic demo OK"]
    assert [(p.new_mesh.shape, p.new_per_data, p.actions)
            for p in rec["plans"]] == [
        (p.new_mesh.shape, p.new_per_data, p.actions) for p in want]
    repo = rec["sim"].repo
    assert [repo.result(t).exitcode for t in rec["tids"]] == [0] * 4


@pytest.mark.parametrize("name", NAMES)
def test_example_raises_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main([])


# ---------------------------------------------------------------------------
# the CLIs: every flag of the reference's serve and train entry points
# ---------------------------------------------------------------------------

def _flags(path: Path) -> set:
    return {n.args[0].value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "add_argument" and n.args
            and isinstance(n.args[0], ast.Constant)
            and str(n.args[0].value).startswith("--")}


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_port_cli_takes_every_reference_flag(cli):
    ref = _flags(ROOT / "src" / "repro" / "launch" / f"{cli}.py")
    port = _flags(ROOT / "src" / "repro_torch" / "launch" / f"{cli}.py")
    assert ref <= port, sorted(ref - port)


def test_serve_cli_num_blocks_and_dup_rate(capsys):
    import json
    from repro_torch.launch.serve import main
    small = ["--smoke", "--device", "cpu", "--requests", "6", "--slots", "2",
             "--max-len", "64"]

    def stats(argv):
        main(small + argv)
        return json.loads(capsys.readouterr().out.splitlines()[-1])

    # the pool's blocks but the scratch block hold 16 tokens each
    assert stats(["--num-blocks", "12"])["kv_capacity_tokens"] == 11 * 16
    assert stats([])["kv_capacity_tokens"] == 8 * 16      # dense-equivalent
    # repeated prompts hit the prefix cache more than fresh ones (whose
    # left-padded blocks can hit too)
    longer = ["--max-len", "256", "--requests", "8"]
    dup = stats(longer + ["--dup-rate", "0.5"])
    assert dup["completed"] == 8
    assert dup["prefix_hit_rate"] > stats(longer)["prefix_hit_rate"]
