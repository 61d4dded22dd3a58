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


def test_the_worker_entry_point_loads_no_jax(tmp_path):
    """``python -m trino_tpu_torch.server.main --role worker --device
    cpu`` announces itself to a port coordinator, which runs one query
    through it (the stage DAG), and the worker process imported neither
    jax nor trino_tpu (``-X importtime``, as above)."""
    import tempfile
    import time
    from trino_tpu_torch.client import StatementClient
    from trino_tpu_torch.server.coordinator import Coordinator
    co = Coordinator(device="cpu", history_dir=str(tmp_path)).start()
    with tempfile.TemporaryFile("w+") as log:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m",
             "trino_tpu_torch.server.main", "--role", "worker",
             "--device", "cpu", "--port", "0", "--coordinator-uri",
             co.base_uri], cwd=str(PKG.parent), stdout=subprocess.PIPE,
            stderr=log, text=True)
        try:
            banner = proc.stdout.readline()
            assert "joined" in banner, banner
            deadline = time.time() + 30
            while not co.live_workers() and time.time() < deadline:
                time.sleep(0.05)
            assert len(co.live_workers()) == 1
            res = StatementClient(co.base_uri).execute(
                "SELECT n_regionkey, count(*) FROM nation "
                "GROUP BY n_regionkey ORDER BY n_regionkey")
            assert res.rows == [[r, 5] for r in range(5)]
        finally:
            proc.terminate()
            proc.communicate(timeout=60)
            co.stop()
        log.seek(0)
        err = log.read()
    imported = {line.rsplit("|", 1)[-1].strip()
                for line in err.splitlines()
                if line.startswith("import time:")}
    # the worker ran the query's tasks: its executor and exchange loaded
    assert {"trino_tpu_torch.server.task_worker",
            "trino_tpu_torch.exec.executor",
            "trino_tpu_torch.serde"} <= imported
    bad = sorted(m for m in imported if m in ("jax", "jaxlib", "trino_tpu")
                 or m.startswith(("jax.", "jaxlib.", "trino_tpu.")))
    assert bad == []


def test_the_worker_slice_modules_are_covered():
    """The worker slice's modules are the port's own copies, and the
    checks above reach them."""
    for m in ("trino_tpu_torch.serde", "trino_tpu_torch.verifier",
              "trino_tpu_torch.verifier_main",
              "trino_tpu_torch.stage.fragmenter",
              "trino_tpu_torch.stage.repartition",
              "trino_tpu_torch.stage.exchange",
              "trino_tpu_torch.stage.scheduler",
              "trino_tpu_torch.exec.remote", "trino_tpu_torch.exec.taskexec",
              "trino_tpu_torch.fte.retry", "trino_tpu_torch.fte.speculate",
              "trino_tpu_torch.fte.objectstore",
              "trino_tpu_torch.server.task_worker",
              "trino_tpu_torch.server.diagnostics"):
        assert m in MODULES


def test_the_streaming_otlp_and_lint_modules_are_covered():
    """The streaming slice, the OTLP exporter and the source lint are
    the port's own copies, and the checks above reach them."""
    for m in ("trino_tpu_torch.streaming.log",
              "trino_tpu_torch.streaming.offsets",
              "trino_tpu_torch.streaming.continuous",
              "trino_tpu_torch.connectors.stream",
              "trino_tpu_torch.obs.otlp",
              "trino_tpu_torch.analysis.lint"):
        assert m in MODULES
    assert (PKG / "streaming" / "__init__.py").exists()


def test_a_stream_scan_continuous_job_and_otlp_export_load_no_jax():
    """A stream topic scanned through SQL, a continuous insert job that
    drains it, an OTLP export to a file sink and a lint run: still no
    jax and no trino_tpu module in the process."""
    code = (
        "import json, sys, tempfile, threading, time\n"
        "d = tempfile.TemporaryDirectory()\n"
        "from trino_tpu_torch.config import CONFIG\n"
        "CONFIG.stream_dir = d.name + '/stream'\n"
        "CONFIG.otlp_file = d.name + '/otlp.jsonl'\n"
        "from trino_tpu_torch.runner import LocalQueryRunner\n"
        "from trino_tpu_torch.fte.spool import make_spool\n"
        "from trino_tpu_torch.streaming import get_log, OffsetStore\n"
        "from trino_tpu_torch.streaming.continuous import "
        "ContinuousQueryManager\n"
        "from trino_tpu_torch.analysis.lint import lint_source\n"
        "r = LocalQueryRunner(device='cpu', collect_node_stats=True)\n"
        "r.execute('CREATE TABLE stream.default.e (k BIGINT, v DOUBLE)')\n"
        "r.execute('CREATE TABLE memory.default.s (k BIGINT, v DOUBLE)')\n"
        "get_log().append('e', [json.dumps({'k': i, 'v': i / 2})"
        ".encode() for i in range(10)])\n"
        "assert r.execute('SELECT count(*) FROM stream.default.e')"
        ".rows == [[10]]\n"
        "lock = threading.Lock()\n"
        "def run(sql):\n"
        "    with lock:\n"
        "        return r.execute(sql)\n"
        "m = ContinuousQueryManager(run, r.catalogs, OffsetStore("
        "make_spool('local', local_base_dir=d.name + '/spool')), "
        "device='cpu')\n"
        "m.create({'kind': 'insert', 'topic': 'e', 'poll_interval_ms': 50,"
        " 'sql': 'INSERT INTO memory.default.s SELECT k, v FROM "
        "stream.default.e'})\n"
        "deadline = time.time() + 60\n"
        "while run('SELECT count(*) FROM memory.default.s').rows != [[10]]:"
        "\n"
        "    assert time.time() < deadline\n"
        "    time.sleep(0.05)\n"
        "m.stop()\n"
        "assert open(CONFIG.otlp_file).readline().startswith("
        "'{\"resourceSpans\"')\n"
        "lint_source('x = 1\\n')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'trino_tpu' or m.startswith('trino_tpu.'))\n"
        "d.cleanup()\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(PKG.parent), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_mesh_and_prewarm_modules_are_covered():
    """The device mesh, the mesh executor, the stage DAG on the mesh, the
    hot-shape registry, the pre-warm and the q18 oracle are the port's
    own modules, and the checks above reach them."""
    for m in ("trino_tpu_torch.parallel.mesh",
              "trino_tpu_torch.parallel.spmd",
              "trino_tpu_torch.exec.distributed",
              "trino_tpu_torch.stage.ici",
              "trino_tpu_torch.exec.hotshapes",
              "trino_tpu_torch.exec.aot",
              "trino_tpu_torch.benchmarks.q18_oracle"):
        assert m in MODULES


def test_the_mesh_path_loads_no_jax():
    """A query over an 8-shard CPU mesh and a warm-up of its shapes:
    still no jax and no trino_tpu module in the process."""
    code = (
        "import sys\n"
        "from trino_tpu_torch.runner import LocalQueryRunner\n"
        "from trino_tpu_torch.exec import aot\n"
        "from trino_tpu_torch.exec.hotshapes import HOT_SHAPES\n"
        "r = LocalQueryRunner(device='cpu', distributed=True, "
        "n_devices=8)\n"
        "r.execute('SELECT l_returnflag, count(*) FROM lineitem "
        "GROUP BY 1 ORDER BY 1')\n"
        "LocalQueryRunner(device='cpu').execute('SELECT o_orderpriority, "
        "count(*) FROM orders GROUP BY 1 ORDER BY 1')\n"
        "assert aot.compile_entries(HOT_SHAPES.top(8), 'cpu')"
        "['errors'] == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'trino_tpu' or m.startswith('trino_tpu.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(PKG.parent), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
