"""Nothing the benchmark runs loads JAX or the JAX package: top-level
module names compared whole, so the port ``repro_torch`` passes."""

import ast
from pathlib import Path

import pytest

from perfbench.run import FORBIDDEN, forbidden_modules

HERE = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("mods, bad", [
    (["repro_torch", "repro_torch.core", "numpy"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.images"], ["repro.core.images"]),
    (["jax", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jaxlib.xla_client"]),
    (["jaxtyping", "reprox", "flaxen"], []),
])
def test_top_level_names_compared_whole(mods, bad):
    assert forbidden_modules(mods) == bad


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN + ("repro_torch",), (
                path, name)
            if name.startswith("perfbench"):
                assert name.startswith("perfbench.reference"), (path, name)
