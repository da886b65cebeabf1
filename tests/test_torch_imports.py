"""Import hygiene of the port and its CUDA-by-default entry points.

The port (``src/repro_torch/``) and ``chip_smoke.py`` import neither JAX
nor anything of the JAX package ``repro``: every module is parsed with
``ast`` and its imports checked.  No file of the port names Triton: every
kernel is CUDA C++ built by ``kernels/_build.py``.  The entry points default to
``device="cuda"`` and raise without a card (reached here by making
``torch.cuda.is_available`` report no card)."""

from __future__ import annotations

import ast
import inspect
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
SOURCES = sorted((ROOT / "src" / "repro_torch" / "kernels" / "csrc").glob(
    "*.cu*"))


def _imports(path: Path) -> list[str]:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return out


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_files_exist():
    assert len(FILES) > 15 and all(p.exists() for p in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", FILES + SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_triton(path):
    assert "triton" not in path.read_text().lower(), path.relative_to(ROOT)


def test_forbidden_names_are_caught():
    src = "import jax\nfrom repro.models import api\nimport repro_torch\n"
    tree = ast.parse(src)
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names] + [n.module for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)]
    assert [n for n in names if _forbidden(n)] == ["jax", "repro.models"]


def test_entry_points_default_to_cuda():
    from repro_torch.launch.serve import serve_direct
    from repro_torch.models.api import init_decode_state
    from repro_torch.serving.engine import ServeEngine
    for fn in (ServeEngine.__init__, serve_direct, init_decode_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.serve import serve_direct
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("smollm-360m")
    bundle = build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_direct(cfg, 1, 1, 32)
    params = bundle.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)
