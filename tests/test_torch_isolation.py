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


def test_the_statement_layer_modules_are_covered():
    """The memory and system connectors are the port's own copies, and
    the checks above reach them."""
    for m in ("trino_tpu_torch.connectors.memory",
              "trino_tpu_torch.connectors.system",
              "trino_tpu_torch.runner"):
        assert m in MODULES


def test_the_file_geometry_and_validation_modules_are_covered():
    """The formats, the localfile and jdbc connectors, the plugin loader,
    the test toolkit, the geometry functions, the plan wire format, the
    metrics, the sanity checker and the access controls are the port's
    own copies, and the checks above reach them."""
    for m in ("trino_tpu_torch.formats.parquet",
              "trino_tpu_torch.formats.parquet_writer",
              "trino_tpu_torch.formats.orc",
              "trino_tpu_torch.formats.orc_writer",
              "trino_tpu_torch.formats.record_decoder",
              "trino_tpu_torch.formats.lanes",
              "trino_tpu_torch.connectors.localfile",
              "trino_tpu_torch.connectors.jdbc",
              "trino_tpu_torch.plugin", "trino_tpu_torch.testing",
              "trino_tpu_torch.ops.geo", "trino_tpu_torch.ops.native",
              "trino_tpu_torch.plan.serde", "trino_tpu_torch.obs.metrics",
              "trino_tpu_torch.analysis.sanity",
              "trino_tpu_torch.security"):
        assert m in MODULES


def test_the_new_paths_load_no_jax():
    """Files written and read back in both formats, a sqlite table, a
    geometry query and a validated plan: still no jax and no trino_tpu
    module in the process."""
    code = (
        "import sys, tempfile\n"
        "from trino_tpu_torch.runner import LocalQueryRunner\n"
        "from trino_tpu_torch.plugin import create_connector\n"
        "r = LocalQueryRunner(device='cpu')\n"
        "r.session.set('plan_validation', True)\n"
        "roots = [tempfile.TemporaryDirectory() for _ in range(2)]\n"
        "for fmt, root in zip(('parquet', 'orc'), roots):\n"
        "    c = create_connector('localfile', fmt, {'localfile.root': "
        "root.name}, device='cpu')\n"
        "    c.write_format = fmt\n"
        "    r.catalogs.register(fmt, c)\n"
        "    r.execute(f'CREATE TABLE {fmt}.default.n AS SELECT * FROM "
        "nation')\n"
        "    assert r.execute(f'SELECT count(*) FROM {fmt}.default.n')"
        ".rows == [[25]]\n"
        "lite = create_connector('jdbc', 'lite', {}, device='cpu')\n"
        "lite.execute_remote('CREATE TABLE t (x BIGINT)')\n"
        "r.catalogs.register('lite', lite)\n"
        "r.execute('SELECT * FROM lite.public.t WHERE x > 1')\n"
        "r.execute(\"SELECT ST_Contains(ST_GeometryFromText('POLYGON "
        "((0 0, 1 0, 1 1, 0 0))'), ST_Point(0.5, 0.1))\")\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'trino_tpu' or m.startswith('trino_tpu.'))\n"
        "for root in roots:\n"
        "    root.cleanup()\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(PKG.parent), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_imports_no_jax_or_trino_tpu():
    """chip_smoke.py, which the card's machine runs without jax, imports
    neither jax nor the JAX engine, at its top or inside a phase."""
    src = (PKG.parent / "chip_smoke.py").read_text()
    assert not _IMPORT.search(src)
    code = ("import sys, chip_smoke\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'trino_tpu' or "
            "m.startswith('trino_tpu.')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(PKG.parent), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
