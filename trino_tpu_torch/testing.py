"""Plugin/test toolkit — lib/trino-plugin-toolkit + testing's
QueryAssertions, collapsed to the helpers plugin authors actually use.

Counterpart of ``trino_tpu/testing.py``; ``TestingConnector`` keeps its
tables on its device (cuda unless ``device="cpu"``).

``assert_query`` runs SQL and compares rows (order-insensitive by
default, like the reference's MaterializedResult comparisons);
``assert_query_fails`` checks the error message; ``TestingConnector``
is a minimal in-memory connector for SPI tests.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from .catalog import TableMetadata, ColumnMetadata
from .columnar import batch_from_pylist
from .config import DeviceLike
from .connectors.memory import MemoryConnector
from .types import Type


def _canon(rows):
    out = []
    for r in rows:
        out.append(tuple(
            float(v) if isinstance(v, float) else v for v in r))
    return out


def assert_query(runner, sql: str, expected: Sequence[Sequence],
                 ordered: bool = False) -> None:
    """testing/QueryAssertions.assertQuery: run, compare rows.
    Floats compare with a small tolerance."""
    got = _canon(runner.execute(sql).rows)
    exp = _canon(expected)
    if not ordered:
        got = sorted(got, key=repr)
        exp = sorted(exp, key=repr)
    assert len(got) == len(exp), \
        f"row count {len(got)} != {len(exp)}\n got: {got}\n exp: {exp}"
    for g, e in zip(got, exp):
        assert len(g) == len(e), f"width {g} vs {e}"
        for gv, ev in zip(g, e):
            if isinstance(gv, float) and isinstance(ev, (int, float)):
                assert abs(gv - float(ev)) <= 1e-9 * max(
                    1.0, abs(ev)), f"{gv} != {ev} in {g} vs {e}"
            else:
                assert gv == ev, f"{gv!r} != {ev!r} in {g} vs {e}"


def assert_query_fails(runner, sql: str, match: str) -> None:
    """assertQueryFails: the query must raise and the message must
    contain ``match``."""
    try:
        runner.execute(sql)
    except Exception as e:   # noqa: BLE001
        assert match.lower() in str(e).lower(), \
            f"error {e!r} does not contain {match!r}"
        return
    raise AssertionError(f"query did not fail: {sql}")


class TestingConnector(MemoryConnector):
    """The reference's TestingMetadata stand-in: a MemoryConnector
    with a one-call ``add_table(name, schema, rows)`` loader (the SPI
    surface itself — metadata/splits/read — is MemoryConnector's,
    so SPI changes have one implementation to track)."""

    __test__ = False      # not a pytest collection target

    name = "testing"

    def __init__(self, schema: str = "default", device: DeviceLike = None):
        super().__init__(device)
        self._schema = schema

    def add_table(self, name: str, schema: Dict[str, Type],
                  rows: List[dict]) -> None:
        self.create_table(TableMetadata(self._schema, name, tuple(
            ColumnMetadata(n, t) for n, t in schema.items())))
        self.insert(self._schema, name, batch_from_pylist(
            {c: [r.get(c) for r in rows] for c in schema},
            dict(schema), self.device))
