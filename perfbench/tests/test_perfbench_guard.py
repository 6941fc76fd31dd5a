"""The guard against JAX and the JAX package compares whole top-level
names."""

import sys
import types

import pytest

from perfbench.harness import common


@pytest.mark.parametrize("name,found", [
    ("pings_tpu_torch.models", []), ("pings_tpu_torch", []),
    ("pings_tpu", ["pings_tpu"]), ("pings_tpu.ops.rasterize", ["pings_tpu"]),
    ("jax.numpy", ["jax"]), ("jaxlib", ["jaxlib"]), ("flax.linen", ["flax"]),
    ("jaxtyping", []), ("pings_tpu2", [])])
def test_top_level_names_are_compared_whole(monkeypatch, name, found):
    for mod in list(sys.modules):
        if mod.split(".")[0] in common.FORBIDDEN:
            monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert common.forbidden_modules() == found
    if found:
        with pytest.raises(SystemExit):
            common.require_no_forbidden("test")
    else:
        common.require_no_forbidden("test")


def test_the_benchmark_sources_import_no_jax():
    import ast
    for path in common.BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in common.FORBIDDEN, (path, n)


def test_the_reference_imports_nothing_of_the_program():
    import ast
    for path in (common.BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module])
                for m in mods:
                    assert m.split(".")[0] in ("torch", "numpy", "math",
                                               "typing", "__future__",
                                               "perfbench"), (path, m)
                    if m.startswith("perfbench"):
                        assert m.startswith("perfbench.reference"), (path, m)
