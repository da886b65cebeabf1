"""The port's static checks: the copies of the reference's lint and
schedule fuzzer, and the port's own torch and graph rules.

The reference's lint and fuzzer cases (``tests/test_analysis.py``) run
against the copies on ``src/repro_torch/`` paths; a table of snippets
gives the same rules from the reference's lint on a ``src/repro/`` path as
from the copy on the matching ``src/repro_torch/`` path; the fuzzer makes
the reference's decisions for the same seed and thread name.  Each of
``torch_rules``' three rules has a positive and a negative case, and the
port's whole tree (``src/repro_torch``, ``examples/torch``,
``chip_smoke.py``, ``tests/test_torch_*.py``) lints clean with every
suppression justified.
"""

from __future__ import annotations

import threading
from pathlib import Path

import pytest

from repro_torch.analysis import torch_rules
from repro_torch.analysis.fuzz import ScheduleFuzzer, six_server_stress
from repro_torch.analysis.lint import lint_source
from repro_torch.analysis.locks import make_lock

ROOT = Path(__file__).resolve().parents[1]
ENGINE = ROOT / "src" / "repro_torch" / "serving" / "engine.py"
GATE = [ROOT / "src" / "repro_torch", ROOT / "examples" / "torch",
        ROOT / "chip_smoke.py",
        *sorted((ROOT / "tests").glob("test_torch_*.py"))]


def _rules(findings, *, suppressed=None):
    return [f.rule for f in findings
            if suppressed is None or f.suppressed == suppressed]


# ---------------------------------------------------------------------------
# the reference's lint cases, on the copy and the port's paths
# ---------------------------------------------------------------------------

def test_lint_bare_lock_positive_and_negative():
    bad = "import threading\nlk = threading.Lock()\n"
    assert "bare-lock" in _rules(lint_source(bad, "src/repro_torch/x.py"))
    bad2 = "from threading import RLock\nlk = RLock()\n"
    assert "bare-lock" in _rules(lint_source(bad2, "src/repro_torch/x.py"))
    good = ("from repro_torch.analysis.locks import make_lock\n"
            "lk = make_lock('x')\n")
    assert not lint_source(good, "src/repro_torch/x.py")
    # the port's factory module itself is exempt
    exempt = "import threading\nlk = threading.Lock()\n"
    assert not lint_source(exempt, "src/repro_torch/analysis/locks.py")


def test_lint_wallclock_in_step_builder():
    bad = ("import time\n"
           "def make_engine_step(cfg):\n"
           "    t = time.time()\n"
           "    return t\n")
    assert "wallclock-in-step" in _rules(lint_source(bad, "x.py"))
    good = ("import time\n"
            "def make_engine_step(cfg):\n"
            "    t = time.monotonic()\n"
            "    return t\n"
            "def helper():\n"
            "    return time.time()\n")
    assert not lint_source(good, "x.py")


def test_lint_one_transfer_scoped_to_engine_step_paths():
    bad = ("import jax\n"
           "class ServeEngine:\n"
           "    def step(self):\n"
           "        return jax.device_get(self.x)\n")
    path = "src/repro_torch/serving/engine.py"
    assert "one-transfer" in _rules(lint_source(bad, path))
    itemy = ("class ServeEngine:\n"
             "    def step(self):\n"
             "        return self.x.item()\n")
    assert "one-transfer" in _rules(lint_source(itemy, path))
    assert not lint_source(bad, "src/repro_torch/serving/other.py")
    good = ("import jax\n"
            "class ServeEngine:\n"
            "    def drain(self):\n"
            "        return jax.device_get(self.x)\n")
    assert not lint_source(good, path)


def test_lint_blocking_under_lock():
    bad = ("import time\n"
           "def f(self):\n"
           "    with self._lock:\n"
           "        time.sleep(0.1)\n")
    assert "blocking-under-lock" in _rules(lint_source(bad, "x.py"))
    joiny = ("def f(self, t):\n"
             "    with self._lock:\n"
             "        t.join()\n")
    assert "blocking-under-lock" in _rules(lint_source(joiny, "x.py"))
    foreign = ("def f(self):\n"
               "    with self._lock:\n"
               "        self._cond.wait()\n")
    assert "blocking-under-lock" in _rules(lint_source(foreign, "x.py"))
    good = ("def f(self):\n"
            "    with self._cond:\n"
            "        self._cond.wait()\n")
    assert not lint_source(good, "x.py")
    good2 = ("import time\n"
             "def f(self):\n"
             "    with self._lock:\n"
             "        x = 1\n"
             "    time.sleep(0.1)\n")
    assert not lint_source(good2, "x.py")


def test_lint_suppression_requires_justification():
    code = ("import threading\n"
            "a = threading.Lock()  # lint: allow[bare-lock] -- test fixture\n"
            "b = threading.Lock()  # lint: allow[bare-lock]\n")
    fs = lint_source(code, "src/repro_torch/x.py")
    assert _rules(fs, suppressed=True) == ["bare-lock"]
    unsup = [f for f in fs if not f.suppressed]
    assert {f.rule for f in unsup} == {"bare-lock", "bad-suppression"}
    above = ("import threading\n"
             "# lint: allow[bare-lock] -- fixture\n"
             "a = threading.Lock()\n")
    assert not [f for f in lint_source(above, "src/repro_torch/x.py")
                if not f.suppressed]
    wrong = ("import threading\n"
             "a = threading.Lock()  # lint: allow[one-transfer] -- nope\n")
    assert "bare-lock" in _rules(
        [f for f in lint_source(wrong, "src/repro_torch/x.py")
         if not f.suppressed])


# ---------------------------------------------------------------------------
# the copy gives the reference's findings, path for path
# ---------------------------------------------------------------------------

SNIPPETS = {
    "bare-lock": ("import threading\nlk = threading.Lock()\n", "x.py"),
    "bare-lock-from-import": ("from threading import Condition\n"
                              "c = Condition()\n", "core/x.py"),
    "bare-lock-exempt": ("import threading\nlk = threading.RLock()\n",
                         "analysis/locks.py"),
    "bare-lock-alias": ("import threading as th\nlk = th.Lock()\n",
                        "serving/x.py"),
    "wallclock": ("import time, datetime\n"
                  "def make_step():\n"
                  "    a = time.time()\n"
                  "    b = datetime.datetime.now()\n", "launch/steps.py"),
    "wallclock-jit": ("import jax, time\n"
                      "@jax.jit\n"
                      "def f(x):\n"
                      "    return x + time.time()\n", "x.py"),
    "one-transfer": ("import jax, numpy as np\n"
                     "class ServeEngine:\n"
                     "    def step(self):\n"
                     "        a = np.asarray(self.x)\n"
                     "        return jax.device_get(a).item()\n",
                     "serving/engine.py"),
    "one-transfer-builder": ("import numpy as np\n"
                             "def make_draft_step(b):\n"
                             "    return np.array(b)\n",
                             "serving/engine.py"),
    "one-transfer-elsewhere": ("class ServeEngine:\n"
                               "    def step(self):\n"
                               "        return self.x.item()\n",
                               "serving/other.py"),
    "blocking": ("import time\n"
                 "def f(self, t):\n"
                 "    with self._lock, self._cond:\n"
                 "        self._cond.wait()\n"
                 "        t.join()\n"
                 "        time.sleep(1)\n", "x.py"),
    "not-lockish": ("def f(self, aud):\n"
                    "    with self._auditor_lock:\n"
                    "        aud.join()\n", "x.py"),
    "suppressed": ("import threading\n"
                   "# lint: allow[bare-lock] -- fixture\n"
                   "a = threading.Lock()\n"
                   "b = threading.Lock()  # lint: allow[bare-lock]\n",
                   "x.py"),
    "syntax-error": ("def f(:\n", "x.py"),
}


@pytest.mark.parametrize("case", sorted(SNIPPETS))
def test_copy_flags_what_the_reference_flags(case):
    from repro.analysis.lint import lint_source as ref_lint_source
    src, rel = SNIPPETS[case]

    def seen(findings):
        return sorted((f.line, f.rule, f.suppressed, f.justification)
                      for f in findings)

    assert seen(lint_source(src, f"src/repro_torch/{rel}")) == seen(
        ref_lint_source(src, f"src/repro/{rel}"))


# ---------------------------------------------------------------------------
# the port's rules: torch transfers, clocks in step builders, graph rebinds
# ---------------------------------------------------------------------------

ENGINE_PATH = "src/repro_torch/serving/engine.py"


def _torch(src, path=ENGINE_PATH, suppressed=False):
    return [f.rule for f in torch_rules.lint_source(src, path)
            if f.suppressed == suppressed]


@pytest.mark.parametrize("call", [
    "self.x.cpu()", "self.x.numpy()", "self.x.tolist()", "self.x.item()",
    "self.x.to('cpu')", "self.x.to(device='cpu')",
    "self.x.to(torch.device('cpu'))", "torch.cuda.synchronize()"])
@pytest.mark.parametrize("method", ["step", "_step", "_spec_step"])
def test_one_transfer_flags_torch_copies(call, method):
    src = ("import torch\n"
           "class ServeEngine:\n"
           f"    def {method}(self):\n"
           f"        return {call}\n")
    assert "one-transfer" in _torch(src)


def test_one_transfer_in_step_builders_and_nowhere_else():
    builder = ("def make_engine_step(bundle, max_len):\n"
               "    def step(params, state):\n"
               "        return state['token'].cpu()\n"
               "    return step\n")
    assert "one-transfer" in _torch(builder)
    # out of scope: another file, or an engine method off the step path
    assert not _torch(builder, "src/repro_torch/launch/steps.py")
    other = ("class ServeEngine:\n"
             "    def block_leaks(self):\n"
             "        return int(self.x.cpu().numpy().sum())\n")
    assert not _torch(other)


def test_one_transfer_leaves_cuda_event_reads_and_takes_a_suppression():
    events = ("import torch\n"
              "class ServeEngine:\n"
              "    def _spec_step(self):\n"
              "        ev = (torch.cuda.Event(enable_timing=True),\n"
              "              torch.cuda.Event(enable_timing=True))\n"
              "        ev[0].record()\n"
              "        ev[1].record()\n"
              "        return ev[0].elapsed_time(ev[1])\n")
    assert not torch_rules.lint_source(events, ENGINE_PATH)
    allowed = ("class ServeEngine:\n"
               "    def _step(self, packed):\n"
               "        # lint: allow[one-transfer] -- the one copy\n"
               "        return packed.cpu().numpy()\n")
    assert not _torch(allowed)
    assert _torch(allowed, suppressed=True) == ["one-transfer"]
    bare = allowed.replace(" -- the one copy", "")
    assert set(_torch(bare)) == {"one-transfer", "bad-suppression"}


@pytest.mark.parametrize("clock", ["time.monotonic", "time.perf_counter",
                                   "time.time", "time.perf_counter_ns"])
def test_wallclock_in_a_torch_step_builder(clock):
    bad = ("import time\n"
           "def make_train_step(cfg):\n"
           "    def step(state, batch):\n"
           f"        t = {clock}()\n"
           "        return state, t\n"
           "    return step\n")
    assert _torch(bad, "src/repro_torch/launch/steps.py") == [
        "wallclock-in-step"]
    # a clock read outside a builder is the host's business
    good = bad.replace("make_train_step", "run_steps")
    assert not _torch(good, "src/repro_torch/launch/steps.py")


GRAPHED = '''
class Engine:
    def __init__(self):
        self.state = {"token": 0}
        self.active = 0
        self.budget = 0
        self.other = 0

    def _capture_step(self):
        step, state = self._step_fn, self.state
        active, budget = self.active, self.budget

        def reset():
            budget.zero_()

        return StepGraph(lambda: step(state, active), self.device, reset)

    def admit(self, si):
        {body}
'''


@pytest.mark.parametrize("body", [
    "self.state = {}", "self.state['token'] = si",
    "self.active, n = si, 1", "self._step_fn = None",
    "self.budget: int = 0", "for self.active in (1, 2): pass"])
def test_graph_rebind_flags_a_captured_attribute(body):
    fs = torch_rules.lint_source(GRAPHED.replace("{body}", body), "x.py")
    assert [f.rule for f in fs] == ["graph-rebind"]
    assert "_capture_step" in fs[0].message


@pytest.mark.parametrize("body", [
    "self.state['token'][si, 0] = 1", "self.active[si] = True",
    "self.budget.zero_()", "self.budget -= 1", "self.other = si",
    "self.device = si", "self.state[si] = 1"])
def test_graph_rebind_leaves_writes_in_place(body):
    assert not torch_rules.lint_source(GRAPHED.replace("{body}", body),
                                       "x.py")


def test_graph_rebind_only_where_a_class_captures():
    src = GRAPHED.replace("{body}", "self.state = {}").replace(
        "return StepGraph(", "return run(")
    assert not torch_rules.lint_source(src, "x.py")


TRANSFORM = """
def build(cfg, params):
    residuals = init_residuals(params)
    box = {"residuals": residuals}

    def transform(grads):
        out, new = compress(grads, residuals)
        BODY
        return out

    return make_train_step(cfg, grad_transform=transform)
"""


@pytest.mark.parametrize("body", [
    "nonlocal residuals; residuals = new",
    "box['residuals'] = new",
    "global residuals; residuals, n = new, 1"])
def test_graph_rebind_flags_a_grad_transform_that_rebinds(body):
    """``make_train_step`` captures its ``grad_transform`` with the step:
    a transform that rebinds its residuals (a ``nonlocal`` name, or a
    key of a dict it closes over) is flagged, since every replay would
    read the residuals of the capture."""
    fs = torch_rules.lint_source(TRANSFORM.replace("BODY", body), "x.py")
    assert [f.rule for f in fs] == ["graph-rebind"]
    assert "transform rebinds" in fs[0].message
    assert "grad_transform" in fs[0].message


@pytest.mark.parametrize("body", [
    "[r.copy_(n) for r, n in zip(residuals, new)]",
    "box['residuals'][0].copy_(new[0])",
    "mine = {}; mine['residuals'] = new",
    "residuals_seen = new"])
def test_graph_rebind_leaves_a_grad_transform_writing_in_place(body):
    assert not torch_rules.lint_source(TRANSFORM.replace("BODY", body),
                                       "x.py")


def test_graph_rebind_flags_a_rebind_in_a_step_builders_closure():
    """Inside a ``make_*step`` builder's nested functions: a ``nonlocal``
    rebind is flagged; a write to the state the step is given (as the
    train step's ``state[GRAPH_KEY] = ...``) and the same closure in a
    function that builds no step are not."""
    bad = ("def make_train_step(cfg):\n"
           "    scale = zeros()\n"
           "    def step(state, batch):\n"
           "        nonlocal scale\n"
           "        scale = state['params'].sum()\n"
           "        state['held'] = scale\n"
           "        return state\n"
           "    return step\n")
    fs = torch_rules.lint_source(bad, "x.py")
    assert [f.rule for f in fs] == ["graph-rebind"]
    assert "step rebinds scale in make_train_step's captured step" in (
        fs[0].message)
    assert fs[0].line == 5
    assert not torch_rules.lint_source(
        bad.replace("make_train_step", "run_steps"), "x.py")


def test_engine_captures_what_it_must_and_draft_cache_is_pinned():
    """``ServeEngine._capture_step`` captures the step function, the
    params, the state, ``active`` and ``budget``, and ``_capture_spec``
    the draft chain's and verify's functions, params and the draft cache
    besides; no method but ``__init__`` rebinds any of them.
    ``_spec_step`` writes the draft cache in place; the moment it rebinds
    it again (as it did before the spec pair was captured), that line is
    flagged."""
    import ast
    src = ENGINE.read_text()
    tree = ast.parse(src)
    caps = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
            and n.name in ("_capture_step", "_capture_spec")}
    assert torch_rules.captured_attrs(caps["_capture_step"]) == {
        "_step_fn", "params", "state", "active", "budget"}
    # (and ``device``: the verify closure reads the draft graph's output,
    # a local bound from a call the rule reads whole)
    assert torch_rules.captured_attrs(caps["_capture_spec"]) == {
        "_draft_fn", "_verify_fn", "draft_params", "_draft_cache", "params",
        "state", "active", "budget", "device"}
    assert not _torch(src, ENGINE_PATH)
    rebinds = src.replace("            drafts, _ = self._draft_fn(\n",
                          "            drafts, self._draft_cache = "
                          "self._draft_fn(\n", 1)
    assert rebinds != src
    fs = [f for f in torch_rules.lint_source(rebinds, ENGINE_PATH)
          if not f.suppressed]
    assert [f.rule for f in fs] == ["graph-rebind"]
    line = rebinds.splitlines()[fs[0].line - 1]
    assert "self._draft_cache = self._draft_fn(" in line, line
    assert "_spec_step rebinds self._draft_cache" in fs[0].message


def test_the_port_lints_clean_with_every_suppression_justified(capsys):
    findings = torch_rules.lint_paths([str(p) for p in GATE])
    assert not [f.format() for f in findings if not f.suppressed]
    assert all(f.justification for f in findings)
    assert torch_rules.main([str(p) for p in GATE]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_the_gate_fails_on_a_finding(tmp_path, capsys):
    bad = tmp_path / "engine.py"
    bad.write_text("import threading\nlk = threading.Lock()\n")
    assert torch_rules.main([str(tmp_path)]) == 1
    assert "[bare-lock]" in capsys.readouterr().out


def test_the_repaired_locks_come_from_the_factory():
    for rel in ("kernels/_build.py", "core/spans.py"):
        text = (ROOT / "src" / "repro_torch" / rel).read_text()
        assert "threading.Lock()" not in text and "make_lock(" in text
    # profile_fleet reads the span recorder after a run: it holds no lock
    text = (ROOT / "src" / "repro_torch" / "launch/profile_fleet.py"
            ).read_text()
    assert "threading.Lock()" not in text
    from repro_torch.analysis.locks import TrackedLock
    from repro_torch.kernels import _build
    assert isinstance(_build._lock, TrackedLock)


# ---------------------------------------------------------------------------
# the schedule fuzzer
# ---------------------------------------------------------------------------

def _scripted_trace(fuzzer_cls, lock_factory, seed, thread_name="fuzz-det"):
    """A fixed single-thread lock workload under a fuzzer; that thread's
    decision sequence."""
    fz = fuzzer_cls(seed, p_preempt=0.3, sleep_s=0.0)
    a = lock_factory("test.det-A")
    b = lock_factory("test.det-B")

    def work():
        with fz.auditor():
            for _ in range(60):
                with a:
                    with b:
                        pass

    t = threading.Thread(target=work, name=thread_name)
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive()
    return fz.decisions[thread_name]


def test_fuzzer_seed_determinism():
    t1 = _scripted_trace(ScheduleFuzzer, make_lock, 1234)
    t2 = _scripted_trace(ScheduleFuzzer, make_lock, 1234)
    assert t1 == t2 and len(t1) >= 120
    assert sum(t1) > 0, "p=0.3 over 240 boundaries must preempt sometimes"
    assert _scripted_trace(ScheduleFuzzer, make_lock, 4321) != t1
    assert _scripted_trace(ScheduleFuzzer, make_lock, 1234,
                           "fuzz-det-other") != t1


@pytest.mark.parametrize("seed,name", [(1234, "fuzz-det"), (7, "fuzz-det"),
                                       (1234, "fuzz-server-3")])
def test_fuzzer_decides_as_the_reference(seed, name):
    from repro.analysis.fuzz import ScheduleFuzzer as RefFuzzer
    from repro.analysis.locks import make_lock as ref_make_lock
    assert _scripted_trace(ScheduleFuzzer, make_lock, seed, name) == \
        _scripted_trace(RefFuzzer, ref_make_lock, seed, name)


def test_fuzz_stress_race_small():
    """One fuzzed six-server stress race on the port's copies of the task
    repo, the block allocator and the fleet dispatcher: exactly-once
    settlement, zero stranded leases, zero block leaks, zero cycles."""
    from repro_torch.serving.blockpool import BlockAllocator
    alloc = BlockAllocator(num_blocks=41, block_size=16)
    assert alloc.capacity_blocks >= 40
    r = six_server_stress(7, n_requests=10, timeout=60.0)
    assert r["completed"] == 10
    assert r["preemptions"] > 0
    assert r["lock_acquisitions"] > 0


def test_fuzz_cli(capsys):
    from repro_torch.analysis import fuzz
    assert fuzz.main(["--seeds", "1", "--requests", "8"]) == 0
    assert "1 seed(s) clean" in capsys.readouterr().out
