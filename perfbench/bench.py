"""Finds what a cell is made of, by name: the entries of ``BENCHMARK.json``
at the checkout's root, a configuration's file, a traffic mix
(``traffic/<mix>.json``), a cell's limits (``limits/<cell>.json``) and each
per-layer metric's reader (``metrics/<metric>.py``).  Adding a cell, a
mix, a configuration or a metric adds files and entries; nothing here
names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(bench["configs"], name, "configuration")
    with open(root / entry["file"]) as f:
        return json.load(f)


def mix(name: str, here: Path = HERE) -> dict:
    with open(here / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits(cell: str, here: Path = HERE) -> dict:
    """The cell's limits: ``{number: limit}`` for each number compared."""
    with open(here / "limits" / f"{cell}.json") as f:
        return json.load(f)["limits"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(bench: dict, cell: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if _applies(m, cell)]


def per_layer(bench: dict, cell: str) -> list[dict]:
    """Per-layer metrics of ``cell``: those that list it, and those with
    no list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in e2e)]


def reader(metric: str, here: Path = HERE):
    """The module ``metrics/<metric>.py``; its ``read(run)`` returns the
    metric's value, or None where the run holds nothing to read."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
