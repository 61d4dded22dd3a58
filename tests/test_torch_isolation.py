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


def test_the_server_entry_point_loads_no_jax():
    """``python -m trino_tpu_torch.server.main --device cpu`` answers a
    statement through the port's client, and the server process imported
    neither jax nor trino_tpu (``-X importtime`` logs every import the
    process makes, lazy ones included)."""
    import tempfile
    from trino_tpu_torch.client import StatementClient
    # the import log goes to a file: a pipe nobody reads while the
    # banner is awaited would fill and stall the server
    with tempfile.TemporaryFile("w+") as log:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m",
             "trino_tpu_torch.server.main", "--device", "cpu", "--port",
             "0"], cwd=str(PKG.parent), stdout=subprocess.PIPE,
            stderr=log, text=True)
        try:
            banner = proc.stdout.readline()
            uri = re.search(r"listening on (http://\S+)", banner)
            assert uri, banner
            res = StatementClient(uri.group(1)).execute(
                "SELECT r_name FROM region ORDER BY r_regionkey LIMIT 2")
            assert res.rows == [["AFRICA"], ["AMERICA"]]
        finally:
            proc.terminate()
            proc.communicate(timeout=60)
        log.seek(0)
        err = log.read()
    imported = {line.rsplit("|", 1)[-1].strip()
                for line in err.splitlines()
                if line.startswith("import time:")}
    assert "trino_tpu_torch.server.coordinator" in imported
    bad = sorted(m for m in imported if m in ("jax", "jaxlib", "trino_tpu")
                 or m.startswith(("jax.", "jaxlib.", "trino_tpu.")))
    assert bad == []


def test_the_coordinator_modules_are_covered():
    """The coordinator slice's modules are the port's own copies, and the
    checks above reach them."""
    for m in ("trino_tpu_torch.server.coordinator",
              "trino_tpu_torch.server.main", "trino_tpu_torch.server.memory",
              "trino_tpu_torch.server.events",
              "trino_tpu_torch.server.resourcegroups",
              "trino_tpu_torch.server.failure",
              "trino_tpu_torch.server.proxy", "trino_tpu_torch.client",
              "trino_tpu_torch.cli", "trino_tpu_torch.dbapi",
              "trino_tpu_torch.errors", "trino_tpu_torch.obs.trace",
              "trino_tpu_torch.obs.history", "trino_tpu_torch.fte.spool",
              "trino_tpu_torch.fte.recovery",
              "trino_tpu_torch.fte.faultpoints",
              "trino_tpu_torch.exec.progkey",
              "trino_tpu_torch.exec.learnedstats",
              "trino_tpu_torch.exec.resultcache"):
        assert m in MODULES
