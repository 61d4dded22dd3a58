"""Query verifier: replay queries against two engines and compare.

Counterpart of ``trino_tpu/verifier.py`` (host code).

Reference parity: service/trino-verifier (PrestoVerifier.java — runs a
control and a test cluster over the same query suite, compares row
sets with float tolerance, reports per-query verdicts). Ours accepts
any pair of objects with ``execute(sql).rows`` — LocalQueryRunner,
distributed runner, or the HTTP client — so it doubles as the
local-vs-distributed and engine-vs-oracle harness."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence


@dataclass
class VerifierResult:
    sql: str
    status: str                  # MATCH | MISMATCH | CONTROL_ERROR |
    #                              TEST_ERROR | BOTH_ERROR
    detail: str = ""
    control_wall_s: float = 0.0
    test_wall_s: float = 0.0


def _normalize(rows: Sequence[Sequence], sort: bool) -> List[tuple]:
    out = [tuple(r) for r in rows]
    if sort:
        out.sort(key=lambda r: tuple(
            (v is None, str(type(v)), str(v)) for v in r))
    return out


def _values_match(a, b, rel_tol: float) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) or isinstance(b, float):
        try:
            return math.isclose(float(a), float(b), rel_tol=rel_tol,
                                abs_tol=1e-9)
        except (TypeError, ValueError):
            return False
    return a == b


def rows_match(control: Sequence[Sequence], test: Sequence[Sequence],
               ordered: bool = False,
               rel_tol: float = 1e-9) -> Optional[str]:
    """None when equal; else a human-readable first difference."""
    ca = _normalize(control, not ordered)
    cb = _normalize(test, not ordered)
    if len(ca) != len(cb):
        return f"row count {len(ca)} != {len(cb)}"
    for i, (ra, rb) in enumerate(zip(ca, cb)):
        if len(ra) != len(rb):
            return f"row {i}: arity {len(ra)} != {len(rb)}"
        for j, (va, vb) in enumerate(zip(ra, rb)):
            if not _values_match(va, vb, rel_tol):
                return f"row {i} col {j}: {va!r} != {vb!r}"
    return None


class Verifier:
    """Drives the comparison over a suite of queries."""

    def __init__(self, control, test, rel_tol: float = 1e-9):
        self.control = control
        self.test = test
        self.rel_tol = rel_tol

    def verify(self, sql: str, ordered: Optional[bool] = None
               ) -> VerifierResult:
        if ordered is None:
            ordered = "order by" in sql.lower()
        c_rows = t_rows = None
        c_err = t_err = None
        t0 = time.perf_counter()
        try:
            c_rows = self.control.execute(sql).rows
        except Exception as e:
            c_err = str(e)
        t1 = time.perf_counter()
        try:
            t_rows = self.test.execute(sql).rows
        except Exception as e:
            t_err = str(e)
        t2 = time.perf_counter()
        if c_err and t_err:
            return VerifierResult(sql, "BOTH_ERROR",
                                  f"{c_err} / {t_err}",
                                  t1 - t0, t2 - t1)
        if c_err:
            return VerifierResult(sql, "CONTROL_ERROR", c_err,
                                  t1 - t0, t2 - t1)
        if t_err:
            return VerifierResult(sql, "TEST_ERROR", t_err,
                                  t1 - t0, t2 - t1)
        diff = rows_match(c_rows, t_rows, ordered, self.rel_tol)
        if diff is None:
            return VerifierResult(sql, "MATCH", "", t1 - t0, t2 - t1)
        return VerifierResult(sql, "MISMATCH", diff, t1 - t0, t2 - t1)

    def run_suite(self, queries: Sequence[str]) -> List[VerifierResult]:
        return [self.verify(q) for q in queries]


def report(results: Sequence[VerifierResult]) -> str:
    lines = []
    counts: dict = {}
    for r in results:
        counts[r.status] = counts.get(r.status, 0) + 1
        mark = "OK " if r.status == "MATCH" else r.status
        lines.append(f"{mark:>14}  {r.control_wall_s*1000:7.1f}ms / "
                     f"{r.test_wall_s*1000:7.1f}ms  "
                     f"{r.sql[:80]}" +
                     (f"  [{r.detail[:60]}]" if r.detail else ""))
    lines.append("")
    lines.append("  ".join(f"{k}={v}" for k, v in sorted(counts.items())))
    return "\n".join(lines)
