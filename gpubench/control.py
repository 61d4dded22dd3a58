"""The control of the check: the reference in float32 in the program's place.

    python3 gpubench/control.py --workload <cell> --seeds 1,2,3 \
        [--schema s] [--per-stream n]

For each seed, deals the parameter sets of the first ``n`` queries of each
of the cell's streams as a run does (60 by default, more than a run's
window sends), computes every answer with the reference in float64 (as
the configuration states) and in float32 (the nearest precision below),
and holds the float32 rows against the float64 ones with the comparison a
run makes. Prints one JSON line a seed: the compared numbers and whether
the control came out correct, which it must not. Runs on the host
(numpy); the benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import compare as cmp  # noqa: E402
import harness  # noqa: E402
import traffic  # noqa: E402
from reference import answers, tpch_gen  # noqa: E402


def control(bench: dict, cell: str, seed: int, schema=None,
            threads: int = 8, per_stream: int = 60) -> dict:
    wl, cfg_entry = harness.find_cell(bench, cell)
    cfg = harness.load_json(harness.ROOT / cfg_entry["file"])
    schema = schema or cfg["schema"]
    mix = traffic.load_mix(harness.HERE / "traffic" /
                           f"{wl['traffic']}.json", seed)
    limit = harness.check_limits(cell)["max_rel_gap"]
    asked = {}
    for s in range(mix.streams):
        for t, p in mix.first(s, per_stream):
            asked.setdefault((t, traffic.params_key(p)), p)
    items = [(mix.templates[t].reference, p) for (t, _), p in asked.items()]
    sf = tpch_gen.SCHEMAS[schema]
    t0 = time.perf_counter()
    want = answers(sf, items, np.float64, threads)
    low = answers(sf, items, np.float32, threads)
    wrong, gap, by_template = 0, 0.0, {}
    for (name, _), w, got in zip(items, want, low):
        diffs, g = cmp.compare(got.rows, w, limit)
        wrong += bool(diffs)
        gap = max(gap, g)
        by_template[name] = max(by_template.get(name, 0.0), g)
    return {"cell": cell, "seed": seed, "schema": schema,
            "parameter_sets": len(items), "max_rel_gap": gap,
            "limit": limit,
            "queries_with_wrong_rows": wrong, "gap_by_template": by_template,
            "correct": wrong == 0 and gap <= limit,
            "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--schema")
    ap.add_argument("--per-stream", type=int, default=60)
    args = ap.parse_args()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for seed in args.seeds.split(","):
        print(json.dumps(control(bench, args.workload, int(seed),
                                 args.schema,
                                 per_stream=args.per_stream)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
