"""Nothing the benchmark runs imports JAX or the JAX package, and its
reference imports nothing of the program: every module of ``benchmark/`` is
parsed and each import's top-level name compared whole."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

from benchmark import harness

HERE = Path(harness.__file__).resolve().parent
MODULES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)
PORT = "audio_few_shot_learning_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=[str(p.relative_to(HERE)) for p in MODULES])
def test_module_imports_no_jax(path):
    found = top_level_imports(path) & set(harness.FORBIDDEN)
    assert not found, f"{path} imports {found}"
    if "reference" in path.relative_to(HERE).parts:
        assert PORT not in top_level_imports(path), f"{path} imports the program"


def test_forbidden_names_compare_whole(monkeypatch):
    """The port's name begins with the JAX package's and is not flagged; the
    JAX package itself, and ``jax``'s submodules, are."""
    monkeypatch.setitem(sys.modules, "audio_few_shot_learning_tpu_torch_probe.x", object())
    assert "audio_few_shot_learning_tpu_torch_probe.x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "audio_few_shot_learning_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert {"audio_few_shot_learning_tpu.ops", "jax.numpy"} <= set(harness.forbidden_modules())
