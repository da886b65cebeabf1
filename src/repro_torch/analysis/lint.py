"""Repo-specific AST lint for the concurrency + transfer invariants.

The rules encode discipline that general-purpose linters cannot know:

``bare-lock``
    No ``threading.Lock()`` / ``RLock()`` / ``Condition()`` outside
    :mod:`repro_torch.analysis` — every lock must come from the instrumented
    factory (``make_lock`` / ``make_rlock`` / ``make_condition``) so the
    auditor and the schedule fuzzer see it.

``wallclock-in-step``
    No ``time.time()`` / ``datetime.now()`` / ``utcnow()`` inside jitted
    step builders (functions named ``make_*step`` or decorated with
    ``jax.jit``): a traced wall-clock read bakes one timestamp into the
    compiled step forever.

``one-transfer``
    The serve engine's step path performs EXACTLY ONE device->host
    transfer per step (the packed result read).  Statically: no
    ``jax.device_get`` / ``.item()`` / ``np.asarray`` / ``np.array`` in
    ``ServeEngine.step`` or the ``make_*step`` builders in
    ``serving/engine.py`` outside the whitelisted (suppressed) single
    transfer.

``blocking-under-lock``
    No ``time.sleep`` / ``<x>.wait(...)`` / ``<x>.join(...)`` lexically
    inside a ``with <lock-like>:`` block.  A condition waiting on
    *itself* (``with self._cond: ... self._cond.wait()``) is the one
    legal shape and is auto-allowed — provided no OTHER lock-like
    context is active, since ``wait`` releases only its own lock.

Suppression syntax (same line or the line above)::

    something_flagged()   # lint: allow[rule-id] -- why this is safe

The justification after ``--`` is REQUIRED: an ``allow`` without one is
itself an (unsuppressable) finding, so zero silent suppressions survive
CI.  Multiple rules: ``allow[rule-a,rule-b] -- ...``.

CLI::

    python -m repro_torch.analysis.lint src tests benchmarks
    # exit 1 if any unsuppressed finding; --show-suppressed lists the rest
"""

from __future__ import annotations

import ast
import dataclasses
import re
import sys
from pathlib import Path
from typing import List, Optional

RULES = {
    "bare-lock": "threading lock constructed outside repro_torch.analysis.locks",
    "wallclock-in-step": "wall-clock read inside a jitted step builder",
    "one-transfer": "device->host transfer in an engine step path",
    "blocking-under-lock": "blocking call under a held lock",
    "bad-suppression": "lint suppression without a justification",
}

_ALLOW_RE = re.compile(
    r"#\s*lint:\s*allow\[([\w,\- ]+)\]\s*(?:--\s*(\S.*))?")
_LOCKISH_RE = re.compile(r"lock|cond|mutex", re.IGNORECASE)
# context managers that merely *mention* locks — the auditor installs
# instrumentation, it doesn't hold a lock across its body
_NOT_LOCKISH_RE = re.compile(r"auditor", re.IGNORECASE)
_STEP_BUILDER_RE = re.compile(r"^make_\w*step$")
_LOCK_CTORS = {"Lock", "RLock", "Condition"}


@dataclasses.dataclass
class Finding:
    path: str
    line: int
    rule: str
    message: str
    suppressed: bool = False
    justification: Optional[str] = None

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{tag}"


def _is_jit_decorated(fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        try:
            txt = ast.unparse(target)
        except Exception:  # noqa: BLE001
            continue
        if txt in ("jax.jit", "jit", "functools.partial(jax.jit"):
            return True
        if "jax.jit" in txt:
            return True
    return False


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, in_analysis: bool, in_engine: bool):
        self.path = path
        self.in_analysis = in_analysis      # repro/analysis is exempt
        self.in_engine = in_engine          # serving/engine.py step scope
        self.findings: List[Finding] = []
        self._threading_aliases = {"threading"}
        self._lock_ctor_names: set = set()  # from-imported ctor names
        self._fn_stack: List[dict] = []
        self._class_stack: List[str] = []
        # stack of active lock-like with-context expressions (unparsed)
        self._with_locks: List[str] = []

    # -- helpers -------------------------------------------------------

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(
            Finding(self.path, getattr(node, "lineno", 0), rule, message))

    def _in_step_builder(self) -> bool:
        return any(f["step_builder"] for f in self._fn_stack)

    def _in_engine_step(self) -> bool:
        if not self.in_engine:
            return False
        return any(f["engine_step"] or f["step_builder"]
                   for f in self._fn_stack)

    # -- imports -------------------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.name == "threading":
                self._threading_aliases.add(a.asname or "threading")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "threading":
            for a in node.names:
                if a.name in _LOCK_CTORS:
                    self._lock_ctor_names.add(a.asname or a.name)
        self.generic_visit(node)

    # -- scopes --------------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_fn(self, node) -> None:
        self._fn_stack.append({
            "step_builder": (bool(_STEP_BUILDER_RE.match(node.name))
                             or _is_jit_decorated(node)),
            "engine_step": (node.name == "step"
                            and bool(self._class_stack)
                            and self._class_stack[-1] == "ServeEngine"),
        })
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            try:
                txt = ast.unparse(item.context_expr)
            except Exception:  # noqa: BLE001
                continue
            if _LOCKISH_RE.search(txt) and not _NOT_LOCKISH_RE.search(txt):
                self._with_locks.append(txt)
                pushed += 1
        self.generic_visit(node)
        for _ in range(pushed):
            self._with_locks.pop()

    # -- calls ---------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        name_txt = None
        try:
            name_txt = ast.unparse(func)
        except Exception:  # noqa: BLE001
            pass

        # bare-lock: threading.Lock() / Lock() via from-import
        if not self.in_analysis:
            if (isinstance(func, ast.Attribute)
                    and func.attr in _LOCK_CTORS
                    and isinstance(func.value, ast.Name)
                    and func.value.id in self._threading_aliases):
                self._emit(node, "bare-lock",
                           f"threading.{func.attr}() — use repro_torch.analysis."
                           f"locks.make_{func.attr.lower()} so the auditor "
                           f"and schedule fuzzer can see this lock")
            elif (isinstance(func, ast.Name)
                  and func.id in self._lock_ctor_names):
                self._emit(node, "bare-lock",
                           f"{func.id}() imported from threading — use the "
                           f"repro_torch.analysis.locks factory")

        # wallclock-in-step
        if self._in_step_builder() and name_txt in (
                "time.time", "datetime.now", "datetime.datetime.now",
                "datetime.utcnow", "datetime.datetime.utcnow"):
            self._emit(node, "wallclock-in-step",
                       f"{name_txt}() inside a jitted step builder bakes "
                       f"one timestamp into the compiled step")

        # one-transfer (engine.py step paths only)
        if self._in_engine_step():
            if name_txt in ("jax.device_get", "np.asarray", "np.array",
                            "numpy.asarray", "numpy.array"):
                self._emit(node, "one-transfer",
                           f"{name_txt}() in an engine step path — the step "
                           f"performs exactly one device->host transfer")
            elif (isinstance(func, ast.Attribute) and func.attr == "item"
                  and not node.args and not node.keywords):
                self._emit(node, "one-transfer",
                           ".item() in an engine step path — implicit "
                           "device->host transfer")

        # blocking-under-lock
        if self._with_locks:
            blocked = None
            if name_txt == "time.sleep":
                blocked = "time.sleep"
            elif isinstance(func, ast.Attribute) and func.attr in (
                    "wait", "join"):
                try:
                    target = ast.unparse(func.value)
                except Exception:  # noqa: BLE001
                    target = None
                # the one legal shape: a condition waiting on ITSELF with
                # no other lock-like context active (wait releases only
                # its own lock)
                if not (func.attr == "wait"
                        and target is not None
                        and target in self._with_locks
                        and len(self._with_locks) == 1):
                    blocked = f"{target or '?'}.{func.attr}"
            if blocked is not None:
                self._emit(node, "blocking-under-lock",
                           f"{blocked}(...) while holding "
                           f"{self._with_locks[-1]!r} — blocks every other "
                           f"thread contending for the lock")

        self.generic_visit(node)


def _apply_suppressions(findings: List[Finding], lines: List[str],
                        path: str) -> List[Finding]:
    out: List[Finding] = []
    for f in findings:
        allow = None
        for ln in (f.line, f.line - 1):
            if 1 <= ln <= len(lines):
                m = _ALLOW_RE.search(lines[ln - 1])
                if m:
                    allow = (m.group(1), m.group(2), ln)
                    break
        if allow is None:
            out.append(f)
            continue
        rules = {r.strip() for r in allow[0].split(",")}
        if f.rule not in rules:
            out.append(f)
            continue
        if not allow[1] or not allow[1].strip():
            out.append(f)
            out.append(Finding(
                path, allow[2], "bad-suppression",
                f"allow[{f.rule}] without a justification — write "
                f"`# lint: allow[{f.rule}] -- <why this is safe>`"))
            continue
        f.suppressed = True
        f.justification = allow[1].strip()
        out.append(f)
    return out


def lint_source(src: str, path: str = "<string>") -> List[Finding]:
    """Lint one source string; returns all findings (suppressed included)."""
    posix = Path(path).as_posix()
    in_analysis = "repro_torch/analysis/" in posix
    in_engine = posix.endswith("serving/engine.py")
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "bad-suppression",
                        f"syntax error: {e.msg}")]
    v = _Visitor(path, in_analysis, in_engine)
    v.visit(tree)
    return _apply_suppressions(v.findings, src.splitlines(), path)


def lint_paths(paths: List[str]) -> List[Finding]:
    findings: List[Finding] = []
    for root in paths:
        p = Path(root)
        files = ([p] if p.is_file()
                 else sorted(f for f in p.rglob("*.py")
                             if "__pycache__" not in f.parts))
        for f in files:
            findings.extend(
                lint_source(f.read_text(encoding="utf-8"), str(f)))
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repo-specific concurrency/transfer lint")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also list suppressed findings with justifications")
    args = ap.parse_args(argv)

    findings = lint_paths(args.paths)
    unsuppressed = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]
    for f in unsuppressed:
        print(f.format())
    if args.show_suppressed:
        for f in suppressed:
            print(f"{f.format()} -- {f.justification}")
    print(f"lint: {len(unsuppressed)} finding(s), "
          f"{len(suppressed)} suppressed, "
          f"{len(set(f.path for f in findings)) if findings else 0} file(s) "
          f"with findings")
    return 1 if unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
