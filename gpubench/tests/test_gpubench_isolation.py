"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program; names compare whole."""

import ast
import sys
import types

import _paths

import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "trino_tpu"}


def imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(sub=""):
    return sorted((_paths.BENCH / sub).rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    assert sources()
    for path in sources():
        bad = imported_top_names(path) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    assert sources("reference")
    for path in sources("reference"):
        names = imported_top_names(path)
        assert not {n for n in names if n.startswith("trino_tpu")}, path
        assert names <= {"__future__", "datetime", "decimal", "importlib",
                         "concurrent", "dataclasses", "typing", "numpy"}, \
            (path, names)


def test_the_runtime_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "trino_tpu_torch_fake",
                        types.ModuleType("trino_tpu_torch_fake"))
    monkeypatch.setitem(sys.modules, "jaxtyping_fake",
                        types.ModuleType("jaxtyping_fake"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "trino_tpu.sub",
                        types.ModuleType("trino_tpu.sub"))
    assert harness.forbidden_modules() == ["trino_tpu"]
