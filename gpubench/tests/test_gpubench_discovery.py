"""A new cell is a configuration file, a traffic mix, a metric reader and
a ``workloads`` entry: added to a copy of the benchmark, the harness finds
each by its name without any file that was there being edited."""

import json
import shutil
import subprocess
import sys

import _paths


def test_new_files_make_a_new_cell(tmp_path):
    dst = tmp_path / "gpubench"
    shutil.copytree(_paths.BENCH, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in dst.rglob("*") if p.is_file()}
    bench = json.loads((_paths.ROOT / "BENCHMARK.json").read_text())
    (dst / "configs" / "tpch_sf1_cached.json").write_text(json.dumps(dict(
        json.loads((dst / "configs" / "tpch_sf10_cached.json").read_text()),
        name="tpch_sf1_cached", schema="sf1")))
    mix = json.loads((dst / "traffic" / "scan_agg.json").read_text())
    mix["templates"] = mix["templates"][:1]
    (dst / "traffic" / "q1_only.json").write_text(json.dumps(mix))
    (dst / "metrics" / "median_s.py").write_text(
        "def read(ctx):\n    return 0.5\n")
    bench["configs"].append({"name": "tpch_sf1_cached", "source": "x",
                             "file": "gpubench/configs/tpch_sf1_cached.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tpch_sf1_cached.q1_only",
                               "config": "tpch_sf1_cached",
                               "traffic": "q1_only", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "median_s", "unit": "s",
                                "better": "lower", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tpch_sf1_cached.q1_only"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data
    probe = (
        "import harness, traffic\n"
        "b = harness.load_json(harness.ROOT / 'BENCHMARK.json')\n"
        "wl, cfg = harness.find_cell(b, 'tpch_sf1_cached.q1_only')\n"
        "c = harness.load_json(harness.ROOT / cfg['file'])\n"
        "m = traffic.load_mix(harness.HERE / 'traffic' / "
        "(wl['traffic'] + '.json'), 5)\n"
        "names = [x['name'] for x in harness.metrics_of(b, wl['name'], "
        "False)]\n"
        "print(c['schema'], [t.name for t in m.templates], names,"
        " harness.reader('median_s')(None))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=dst,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(dst)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [
        "sf1", "['q1']", "['queries_per_s',", "'latency_p95_s',",
        "'peak_device_gib',", "'setup_s',", "'median_s']", "0.5"]
