"""Nothing of the benchmark imports JAX or the JAX package, and nothing of
the reference imports the program: an `ast` walk over benchmark/, top-level
module names compared whole (umgen_tpu_torch begins with umgen_tpu)."""

import ast

from benchmark.tests.cells import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "umgen_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_anywhere():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = FORBIDDEN & set(_imports(f))
        assert not bad, f"{f}: imports {bad}"


def test_reference_stands_apart():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "umgen_tpu_torch" not in set(_imports(f)), f


def test_run_guard_compares_whole_names(monkeypatch):
    import sys
    import types

    from benchmark import run
    monkeypatch.setitem(sys.modules, "umgen_tpu_torchlike",
                        types.ModuleType("x"))
    assert run.jax_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert run.jax_loaded() == ["jax.numpy"]


def test_guard_catches_a_planted_import(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import umgen_tpu.models\nfrom jaxlib import xla\n")
    assert set(_imports(p)) == {"umgen_tpu", "jaxlib"}
    p.write_text("import umgen_tpu_torch\n")
    assert not FORBIDDEN & set(_imports(p))
