"""The port's own static rules, run beside the copy of the reference's lint.

The reference's rules (:mod:`repro_torch.analysis.lint`, a copy kept line
for line) know JAX's transfers and clocks.  The port's step paths are
PyTorch and its decode step replays as a captured CUDA graph, so three
rules are added here, over the same `Finding`, the same suppression
syntax (``# lint: allow[rule] -- why``, on the line or the line above;
an ``allow`` without a justification is itself a finding) and the same
`_apply_suppressions`:

``one-transfer`` (torch)
    In ``ServeEngine.step`` and ``_step`` (the body ``step`` runs under
    the device lock), ``ServeEngine._spec_step`` and the ``make_*step``
    builders of ``serving/engine.py``: no ``.cpu()``, ``.numpy()``,
    ``.tolist()``, ``.item()``, ``.to("cpu")`` or
    ``torch.cuda.synchronize``.  The step's one packed copy carries a
    justified suppression.  The rule is lexical, like the reference's: it
    cannot tell a host array from a tensor, so a ``.tolist()`` on the
    host result of the one copy takes a justified suppression too.  CUDA
    event reads (``record``, ``elapsed_time``) are not transfers.

``wallclock-in-step`` (torch)
    No ``time.monotonic`` / ``time.perf_counter`` / ``time.time`` (nor
    their ``_ns`` forms) inside a ``make_*step`` builder: a captured graph
    replays no host code, so a clock read there measures the capture.

``graph-rebind``
    In a class where a method builds a ``StepGraph``, the attributes that
    method reads into the captured closure (read inside a lambda or a
    nested function, or bound to a local that one reads, or handed to
    ``StepGraph`` as its function) hold the tensors the graph replays at
    fixed addresses.  Any other method but ``__init__`` that rebinds one
    (``self.state = ...``, or ``self.state["k"] = ...`` with a constant
    key) is flagged.  Writes in place are not: ``self.state["token"][si,
    0] = ...``, ``self.active[si] = ...``, ``.zero_()``, ``.copy_()``, and
    augmented assignments (a tensor's ``-=`` is in place).
    A captured step built by a function, not a class (the train step,
    whose whole body ``make_train_step`` captures, ``grad_transform``
    included), holds its closure's tensors the same way: inside a
    ``make_*step`` builder's nested functions, and inside a function
    handed to a call as ``grad_transform=``, an assignment to a name
    declared ``nonlocal`` or ``global`` (``residuals = new``), or to a
    constant key of a dict the function does not bind itself
    (``box["residuals"] = new``), is flagged: the capture runs it once and
    every replay reads the old tensor.

CLI::

    python -m repro_torch.analysis.torch_rules src/repro_torch \\
        examples/torch chip_smoke.py tests/test_torch_*.py
    # exit 1 if any unsuppressed finding (the copy's rules or these)
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis import lint
from repro_torch.analysis.lint import Finding, _apply_suppressions

_TRANSFER_METHODS = ("cpu", "numpy", "tolist", "item")
_ENGINE_STEP_METHODS = ("step", "_step", "_spec_step")
_CLOCKS = {f"time.{c}{ns}" for c in ("monotonic", "perf_counter", "time")
           for ns in ("", "_ns")}


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001
        return ""


def _self_attr(node: ast.AST) -> Optional[str]:
    """``X`` for a ``self.X`` node, else None."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _is_cpu(node: ast.AST) -> bool:
    return ((isinstance(node, ast.Constant) and node.value == "cpu")
            or _unparse(node) in ("torch.device('cpu')",
                                  'torch.device("cpu")'))


def _transfer(call: ast.Call) -> Optional[str]:
    """What device->host transfer ``call`` is, or None."""
    func = call.func
    if _unparse(func) == "torch.cuda.synchronize":
        return "torch.cuda.synchronize()"
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr in _TRANSFER_METHODS:
        return f".{func.attr}()"
    if func.attr == "to" and (
            any(_is_cpu(a) for a in call.args)
            or any(k.arg == "device" and _is_cpu(k.value)
                   for k in call.keywords)):
        return '.to("cpu")'
    return None


class _StepVisitor(ast.NodeVisitor):
    """The torch ``one-transfer`` and ``wallclock-in-step`` rules."""

    def __init__(self, path: str, in_engine: bool):
        self.path = path
        self.in_engine = in_engine
        self.findings: List[Finding] = []
        self._fn_stack: List[dict] = []
        self._class_stack: List[str] = []

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(
            Finding(self.path, getattr(node, "lineno", 0), rule, message))

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_fn(self, node) -> None:
        self._fn_stack.append({
            "step_builder": bool(lint._STEP_BUILDER_RE.match(node.name)),
            "engine_step": (node.name in _ENGINE_STEP_METHODS
                            and bool(self._class_stack)
                            and self._class_stack[-1] == "ServeEngine"),
        })
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Call(self, node: ast.Call) -> None:
        in_builder = any(f["step_builder"] for f in self._fn_stack)
        name = _unparse(node.func)
        if in_builder and name in _CLOCKS:
            self._emit(node, "wallclock-in-step",
                       f"{name}() inside a step builder: a captured graph "
                       f"replays no host code, so the read times only the "
                       f"capture")
        if self.in_engine and any(f["step_builder"] or f["engine_step"]
                                  for f in self._fn_stack):
            what = _transfer(node)
            if what is not None:
                self._emit(node, "one-transfer",
                           f"{what} in an engine step path: the step makes "
                           f"exactly one device->host copy")
        self.generic_visit(node)


def _builds_graph(method: ast.AST) -> List[ast.Call]:
    return [n for n in ast.walk(method) if isinstance(n, ast.Call)
            and _unparse(n.func).split(".")[-1] == "StepGraph"]


def _pairs(target: ast.AST, value: ast.AST):
    """(target node, value node) pairs of one assignment, element by
    element where both sides are tuples or lists of one length."""
    if (isinstance(target, (ast.Tuple, ast.List))
            and isinstance(value, (ast.Tuple, ast.List))
            and len(target.elts) == len(value.elts)):
        for t, v in zip(target.elts, value.elts):
            yield from _pairs(t, v)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for t in target.elts:
            yield from _pairs(t, value)
    elif isinstance(target, ast.Starred):
        yield from _pairs(target.value, value)
    else:
        yield target, value


def captured_attrs(method: ast.AST) -> set:
    """The ``self`` attributes a graph-building ``method`` reads into its
    captured closure."""
    closures = [n for n in ast.walk(method) if n is not method and
                isinstance(n, (ast.Lambda, ast.FunctionDef,
                               ast.AsyncFunctionDef))]
    attrs, names = set(), set()
    for c in closures:
        for n in ast.walk(c):
            a = _self_attr(n)
            if a is not None and isinstance(n.ctx, ast.Load):
                attrs.add(a)
            elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                names.add(n.id)
    for call in _builds_graph(method):
        if call.args and _self_attr(call.args[0]) is not None:
            attrs.add(_self_attr(call.args[0]))
    pairs = [p for n in ast.walk(method) if isinstance(n, ast.Assign)
             for t in n.targets for p in _pairs(t, n.value)]
    grown = True
    while grown:                       # locals bound from locals, to a fixpoint
        grown = False
        for t, v in pairs:
            if isinstance(t, ast.Name) and t.id in names:
                for n in ast.walk(v):
                    a = _self_attr(n)
                    if a is not None:
                        attrs.add(a)
                    elif (isinstance(n, ast.Name) and n.id not in names
                          and isinstance(n.ctx, ast.Load)):
                        names.add(n.id)
                        grown = True
    return attrs


def _rebound(target: ast.AST, captured: set) -> Optional[tuple]:
    """``(attribute, what is rebound)`` where ``target`` rebinds a
    captured attribute, else None."""
    a = _self_attr(target)
    if a in captured:
        return a, f"self.{a}"
    if (isinstance(target, ast.Subscript)
            and _self_attr(target.value) in captured
            and isinstance(target.slice, ast.Constant)):
        a = _self_attr(target.value)
        return a, f"self.{a}[{target.slice.value!r}]"
    return None


def _targets(node: ast.AST) -> list:
    if isinstance(node, ast.Assign):
        raw = node.targets
    elif isinstance(node, ast.AnnAssign):
        raw = [node.target]
    elif isinstance(node, (ast.For, ast.AsyncFor)):
        raw = [node.target]
    elif isinstance(node, ast.withitem) and node.optional_vars is not None:
        raw = [node.optional_vars]
    else:
        return []
    return [t for r in raw for t, _ in _pairs(r, r)]


def graph_rebind_findings(tree: ast.AST, path: str) -> List[Finding]:
    """The ``graph-rebind`` rule over one module."""
    out: List[Finding] = []
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        methods = [m for m in cls.body
                   if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))]
        capturing = {m.name: captured_attrs(m) for m in methods
                     if _builds_graph(m)}
        if not capturing:
            continue
        captured = set().union(*capturing.values())
        for m in methods:
            if m.name == "__init__" or m.name in capturing:
                continue
            for node in ast.walk(m):
                for t in _targets(node):
                    hit = _rebound(t, captured)
                    if hit is None:
                        continue
                    attr, what = hit
                    by = [c for c, attrs in capturing.items() if attr in attrs]
                    out.append(Finding(
                        path, t.lineno, "graph-rebind",
                        f"{cls.name}.{m.name} rebinds {what}, which "
                        f"{cls.name}.{by[0]} captured into a CUDA graph: "
                        f"the replay keeps reading the old tensor; write "
                        f"it in place"))
    return out


def _bound_names(fn: ast.AST) -> set:
    """The names ``fn`` binds itself: its parameters and the names it
    stores to (not those it declares ``nonlocal`` or ``global``)."""
    a = fn.args
    names = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    names |= {x.arg for x in (a.vararg, a.kwarg) if x is not None}
    names |= {n.id for n in ast.walk(fn)
              if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}
    return names - _declared(fn)


def _declared(fn: ast.AST) -> set:
    return {name for n in ast.walk(fn)
            if isinstance(n, (ast.Nonlocal, ast.Global)) for name in n.names}


def closure_rebinds(fn: ast.AST) -> list:
    """``(target node, what)`` for each rebind of a tensor that ``fn``
    holds from its closure: a name it declares ``nonlocal``/``global``, or
    a constant key of a dict it does not bind itself."""
    declared, bound = _declared(fn), _bound_names(fn)
    out = []
    for node in ast.walk(fn):
        for t in _targets(node):
            if isinstance(t, ast.Name) and t.id in declared:
                out.append((t, t.id))
            elif (isinstance(t, ast.Subscript)
                  and isinstance(t.value, ast.Name)
                  and t.value.id not in bound
                  and isinstance(t.slice, ast.Constant)):
                out.append((t, f"{t.value.id}[{t.slice.value!r}]"))
    return out


def closure_rebind_findings(tree: ast.AST, path: str) -> List[Finding]:
    """The ``graph-rebind`` rule over the captured closures of function
    builders: the nested functions of every ``make_*step`` builder, and
    every function handed to a call as ``grad_transform=``."""
    fns = [n for n in ast.walk(tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    checked = {}
    for b in fns:
        if lint._STEP_BUILDER_RE.match(b.name):
            for n in ast.walk(b):
                if n is not b and isinstance(
                        n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    checked[id(n)] = (n, f"{b.name}'s captured step")
    transforms = {k.value.id for n in ast.walk(tree) if isinstance(n, ast.Call)
                  for k in n.keywords if k.arg == "grad_transform"
                  and isinstance(k.value, ast.Name)}
    for n in fns:
        if n.name in transforms:
            checked.setdefault(id(n), (n, "a captured grad_transform"))
    out = []
    for fn, where in checked.values():
        for t, what in closure_rebinds(fn):
            out.append(Finding(
                path, t.lineno, "graph-rebind",
                f"{fn.name} rebinds {what} in {where}: a CUDA graph runs "
                f"the rebind once, at its capture, and every replay reads "
                f"the old tensor; write it in place (copy_)"))
    return out


def torch_source(src: str, path: str = "<string>") -> List[Finding]:
    """The port's three rules over one source string; all findings,
    suppressed included."""
    posix = Path(path).as_posix()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "bad-suppression",
                        f"syntax error: {e.msg}")]
    v = _StepVisitor(path, posix.endswith("serving/engine.py"))
    v.visit(tree)
    found = (v.findings + graph_rebind_findings(tree, path)
             + closure_rebind_findings(tree, path))
    return _apply_suppressions(found, src.splitlines(), path)


def lint_source(src: str, path: str = "<string>") -> List[Finding]:
    """The copy's rules and the port's over one source string; a line
    flagged for one rule by both is reported once."""
    out, seen = [], set()
    for f in lint.lint_source(src, path) + torch_source(src, path):
        key = (f.path, f.line, f.rule, f.suppressed)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


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
        prog="python -m repro_torch.analysis.torch_rules",
        description="the reference's lint rules and the port's torch and "
                    "graph rules")
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
    print(f"torch_rules: {len(unsuppressed)} finding(s), "
          f"{len(suppressed)} suppressed, "
          f"{len({f.path for f in findings})} file(s) with findings")
    return 1 if unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
