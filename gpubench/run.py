"""The benchmark of trino_tpu_torch: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs from the root of a checkout that holds the program and
``BENCHMARK.json``, on a machine with the CUDA cards the cell asks for;
without them it exits with code 3 and prints no result. The last line of
standard output is the result (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last the
compared numbers with their limits); the lines before it on standard error
say what the run did, the compared numbers last. ``harness.py`` says what
a run does.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--records", help="write each query of the window "
                    "(template, parameters, times) to this JSONL file")
    args = ap.parse_args(argv)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    try:
        out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                               bool(args.trace), T_PROCESS,
                               records_path=args.records)
    except harness.NoDevice as e:
        print(f"gpubench: {e}; the benchmark runs on CUDA cards only",
              file=sys.stderr)
        return 3
    except ImportError as e:
        print(f"gpubench: the program cannot be imported: {e}",
              file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"gpubench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
