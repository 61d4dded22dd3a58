"""Interactive SQL console.

Counterpart of ``trino_tpu/cli.py`` (host only).

Reference parity: client/trino-cli (Console.java, QueryRunner,
StatusPrinter, aligned output) — a readline REPL over StatementClient,
or directly over an in-process LocalQueryRunner with --local (on
``--device``, ``cuda`` unless ``cpu`` is asked for).

Usage:
    python -m trino_tpu_torch.cli --local [--device cpu] [--distributed]
    python -m trino_tpu_torch.cli --server http://127.0.0.1:8080 \
        --execute "SELECT 1"
"""

from __future__ import annotations

import argparse
import sys
import time


def _render(columns, rows, elapsed_s: float) -> str:
    if not columns:
        return ""
    cells = [[("NULL" if v is None else str(v)) for v in row]
             for row in rows]
    widths = [max([len(c)] + [len(r[i]) for r in cells])
              for i, c in enumerate(columns)]
    sep = "-+-".join("-" * w for w in widths)
    out = [" | ".join(c.ljust(w) for c, w in zip(columns, widths)), sep]
    for r in cells:
        out.append(" | ".join(v.ljust(w) for v, w in zip(r, widths)))
    out.append(f"({len(rows)} row{'s' if len(rows) != 1 else ''}, "
               f"{elapsed_s:.2f}s)")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="trino-tpu-torch")
    ap.add_argument("--server", default=None,
                    help="coordinator URI (client mode)")
    ap.add_argument("--local", action="store_true",
                    help="run the engine in-process")
    ap.add_argument("--distributed", action="store_true",
                    help="[--local] run over the device mesh (one shard "
                         "per visible card; 8 shards on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="[--local] torch device: cuda (default) or cpu")
    ap.add_argument("--catalog", default="tpch")
    ap.add_argument("--schema", default="tiny")
    ap.add_argument("--execute", "-e", default=None,
                    help="run one statement and exit")
    args = ap.parse_args(argv)

    if args.server:
        from .client import ClientError, StatementClient
        client = StatementClient(args.server, catalog=args.catalog,
                                 schema=args.schema)

        def run(sql):
            t0 = time.time()
            res = client.execute(sql)
            if res.update_type:
                n = f" ({res.update_count} rows)" \
                    if res.update_count is not None else ""
                return f"{res.update_type}{n}"
            return _render(res.column_names, res.rows, time.time() - t0)
        errtype = ClientError
    else:
        from .exec.executor import QueryError
        from .runner import LocalQueryRunner
        from .session import Session
        runner = LocalQueryRunner(
            session=Session(catalog=args.catalog, schema=args.schema),
            device=args.device, distributed=args.distributed,
            n_devices=8 if args.distributed and args.device == "cpu"
            else None)

        def run(sql):
            t0 = time.time()
            res = runner.execute(sql)
            if res.update_type:
                n = f" ({res.update_count} rows)" \
                    if res.update_count is not None else ""
                return f"{res.update_type}{n}"
            return _render(res.columns, res.rows, time.time() - t0)
        errtype = QueryError

    if args.execute:
        try:
            print(run(args.execute))
            return 0
        except errtype as e:
            print(f"Query failed: {e}", file=sys.stderr)
            return 1

    print("trino-tpu-torch console (quit/exit to leave)")
    buf = []
    while True:
        try:
            line = input("trino-tpu> " if not buf else "        -> ")
        except EOFError:
            break
        except KeyboardInterrupt:
            print()
            buf = []      # abandon the half-typed statement
            continue
        if not buf and line.strip().lower() in ("quit", "exit"):
            break
        buf.append(line)
        if line.rstrip().endswith(";") or (len(buf) == 1
                                           and not line.strip()):
            sql = "\n".join(buf).strip().rstrip(";")
            buf = []
            if not sql:
                continue
            try:
                print(run(sql))
            except errtype as e:
                print(f"Query failed: {e}", file=sys.stderr)
            except KeyboardInterrupt:
                print("(interrupted)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
