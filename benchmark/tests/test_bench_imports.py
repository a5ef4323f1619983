"""No run loads JAX or the JAX package, compared by whole top-level names;
the references import nothing of the program."""

import ast
import sys
import types
from pathlib import Path

from benchmark import harness
from benchmark.tests import _tiny

BENCH = Path(harness.__file__).resolve().parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_banned_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "matfac_tpu_torch_x",
                        types.ModuleType("matfac_tpu_torch_x"))
    assert "matfac_tpu" not in harness.banned_loaded()
    monkeypatch.setitem(sys.modules, "matfac_tpu.ops",
                        types.ModuleType("matfac_tpu.ops"))
    assert "matfac_tpu" in harness.banned_loaded()
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert "jax" in harness.banned_loaded()


def test_no_source_imports_jax():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.BANNED, (path, name)


def test_references_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in ("__future__", "torch", "numpy", "benchmark"), \
                (path, name)
            if top == "benchmark":
                assert name.startswith("benchmark.reference"), (path, name)


def test_a_run_that_loads_jax_prints_no_result(tmp_path):
    tiny = _tiny.tiny_copy(tmp_path)
    patch = ("import sys, types\n"
             "sys.modules['matfac_tpu'] = types.ModuleType('matfac_tpu')")
    rc, out, err = _tiny.run(tiny, ["--workload", "ml10m-bpr-serve-1user",
                                    "--seed", "1", "--seconds", "0.2"],
                             patch)
    assert rc == 3 and out == "" and "matfac_tpu" in err


def test_a_run_loads_no_banned_module(tmp_path):
    tiny = _tiny.tiny_copy(tmp_path)
    rc, out, err = _tiny.run(tiny, ["--workload", "ml20m-mf-sgd", "--seed",
                                    "1", "--seconds", "0.2"])
    assert rc == 0 and _tiny.result(out)["correct"] is True, err[-2000:]
