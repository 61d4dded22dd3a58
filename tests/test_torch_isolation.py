"""The PyTorch engine stands alone: it imports neither jax nor the JAX
engine (trino_tpu), not even that engine's jax-free modules."""

import pathlib
import re
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "trino_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py")


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from trino_tpu_torch.runner import LocalQueryRunner\n"
        "r = LocalQueryRunner(device='cpu')\n"
        "r.execute('SELECT count(*) FROM lineitem WHERE l_tax > 0.02')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'trino_tpu' or m.startswith('trino_tpu.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(PKG.parent), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_IMPORT = re.compile(
    r"^\s*(?:import\s+(?:jax|jaxlib|trino_tpu)\b"
    r"|from\s+(?:jax|jaxlib|trino_tpu)(?:\.|\s))", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(PKG)) for p in PKG.rglob("*.py")))
def test_source_has_no_jax_or_trino_tpu_import(path):
    src = (PKG / path).read_text()
    assert not _IMPORT.search(src), path
