"""Rows a query returned through the protocol, held against the reference.

Exact columns (keys, counts, text, dates) must be equal; a double column
gives its relative gap to the reference, and the largest gap of a run is
held to its limit. Rows named by a key are matched by it; in a ``LIMIT``
query a row may sit at another place than the reference's, or come from
past the cut, only where its tie column and the reference's row at that
place are equal within the same limit (a tie that rounding may break
either way).
"""

from __future__ import annotations

import math
from typing import List, Tuple


def rel_gap(got, want) -> float:
    if not isinstance(got, (int, float)) or isinstance(got, bool):
        return math.inf
    if want == 0:
        return 0.0 if got == 0 else math.inf
    return abs(got - want) / abs(want)


def compare(got: List[list], answer, gap_limit: float
            ) -> Tuple[List[str], float]:
    """(what differs exactly, the largest relative gap of a double)."""
    wrong: List[str] = []
    gap = 0.0
    want = answer.rows
    if len(got) != len(want):
        return [f"{len(got)} rows, not {len(want)}"], gap
    pool = want + list(answer.candidates)
    by_key = {tuple(r[k] for k in answer.key): j for j, r in enumerate(pool)}
    used = set()
    for i, row in enumerate(got):
        if len(row) != len(want[i]):
            wrong.append(f"row {i}: {len(row)} columns")
            continue
        if answer.key:
            j = by_key.get(tuple(row[k] for k in answer.key))
            if j is None or j in used:
                wrong.append(f"row {i}: key {[row[k] for k in answer.key]}"
                             " not in the reference")
                continue
            used.add(j)
            if j != i:
                t = answer.tie
                if t is None or rel_gap(pool[j][t], want[i][t]) > gap_limit:
                    wrong.append(f"row {i}: reference row {j} at place {i}")
                    continue
        else:
            j = i
        ref = pool[j]
        for c, (a, b) in enumerate(zip(row, ref)):
            if c in answer.doubles:
                gap = max(gap, rel_gap(a, b))
            elif a != b:
                wrong.append(f"row {i} column {c}: {a!r}, not {b!r}")
    return wrong, gap
