"""``python -m trino_tpu_torch.verifier_main``: replay a query file
against two HTTP endpoints (service/trino-verifier's CLI shape), for
example a single-node port coordinator and one with workers.
Counterpart of ``trino_tpu/verifier_main.py``."""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trino-tpu-verifier")
    ap.add_argument("--control", required=True,
                    help="control coordinator URI")
    ap.add_argument("--test", required=True,
                    help="test coordinator URI")
    ap.add_argument("--queries", required=True,
                    help="file of queries, ';'-separated")
    args = ap.parse_args(argv)

    from .client import StatementClient
    from .verifier import Verifier, report
    with open(args.queries) as f:
        text = f.read()
    queries = [q.strip() for q in text.split(";") if q.strip()]
    v = Verifier(StatementClient(args.control),
                 StatementClient(args.test))
    results = v.run_suite(queries)
    print(report(results))
    bad = sum(1 for r in results if r.status not in ("MATCH",))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
