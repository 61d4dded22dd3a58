"""When would a join stream its probe side? The decision only.

Counterpart of the engagement rules of ``trino_tpu/exec/streamjoin.py``
(``chunk_rows_setting``, ``memory_budget``, ``scan_chain``,
``stream_gate``, ``scan_estimate`` and ``maybe_stream_join``). The JAX
engine streams the probe of a hash join through double-buffered chunks
when its scan does not fit the memory left after the build side. The
streaming itself is not ported: where the JAX engine would stream, this
engine raises ``not yet ported: streamed join``, and everywhere else it
takes the materialised path, as the JAX engine does.
"""

from __future__ import annotations

from typing import List, Optional

from ..columnar import Batch, Column
from ..plan.nodes import (FilterNode, JoinNode, PlanNode, ProjectNode,
                          TableScanNode)
from ..types import is_string


def chunk_rows_setting(session) -> int:
    """``stream_chunk_rows``: > 0 forces streaming at that chunk size,
    0 engages on a budget breach, < 0 disables streaming."""
    try:
        return int(session.get("stream_chunk_rows"))
    except KeyError:
        return 0


def memory_budget(ex) -> int:
    """The per-node limit, tightened by whatever cluster memory
    governance binds this query."""
    limit = int(ex.session.get("query_max_memory_per_node"))
    fn = getattr(getattr(ex.session, "memory", None), "budget_bytes", None)
    if callable(fn):
        b = fn()
        if b:
            limit = min(limit, int(b))
    return limit


def scan_chain(node: PlanNode):
    """(chain, scan) when ``node`` heads a Filter/Project-only chain over
    a TableScanNode, else None."""
    chain: List[PlanNode] = []
    cur = node
    while isinstance(cur, (FilterNode, ProjectNode)):
        chain.append(cur)
        cur = cur.source
    if not isinstance(cur, TableScanNode):
        return None
    return chain, cur


def _col_streamable(t) -> bool:
    name = str(t.name)
    return not name.startswith(("array(", "map(", "row("))


def stream_gate(ex, scan: TableScanNode):
    """None when streaming is impossible for this scan (no split-capable
    connector, unstreamable column types, streaming disabled); else
    (forced chunk rows, memory budget, scan estimate)."""
    conn = ex.catalogs.connector(scan.handle.catalog)
    if not hasattr(conn, "get_splits") or not hasattr(conn, "read_split"):
        return None
    if not all(_col_streamable(t) for t in scan.schema.values()):
        return None
    forced = chunk_rows_setting(ex.session)
    if forced < 0:
        return None
    return forced, memory_budget(ex), scan_estimate(ex, scan)


def scan_estimate(ex, scan: TableScanNode) -> Optional[int]:
    """Bytes of the whole scan materialised (rows x lanes x 8, the figure
    the scan would reserve); None when the connector cannot estimate it
    (a pushed-down constraint or limit)."""
    conn = ex.catalogs.connector(scan.handle.catalog)
    if scan.handle.constraint is not None or scan.handle.limit is not None:
        return None
    if not hasattr(conn, "table_row_count"):
        return None
    rows = conn.table_row_count(scan.handle)
    if not rows:
        return None
    return int(rows) * max(len(set(scan.assignments.values())), 1) * 8


def col_bytes(c: Column) -> int:
    return sum(t.nelement() * t.element_size()
               for t in (c.data, c.valid, c.data2) if t is not None)


def maybe_stream_join(ex, node: JoinNode) -> Optional[Batch]:
    """Raise ``not yet ported: streamed join`` where the JAX engine would
    stream this join's probe. Otherwise return the build batch when the
    decision had to materialise it (the caller reuses it), else None."""
    if node.join_type not in ("inner", "left") or not node.criteria:
        return None
    sc = scan_chain(node.left)
    if sc is None:
        return None
    chain, scan = sc
    gate = stream_gate(ex, scan)
    if gate is None:
        return None
    pschema = (chain[0] if chain else scan).output_schema()
    bschema = node.right.output_schema()
    if not all(_col_streamable(t) for t in pschema.values()):
        return None
    # a string column the chain creates would mint a dictionary per
    # chunk: such probes take the materialised path
    if any(is_string(t) and s not in scan.schema
           for s, t in pschema.items()):
        return None
    if any(c.left not in pschema for c in node.criteria) \
            or any(c.right not in bschema for c in node.criteria):
        return None
    forced, budget, est = gate
    if forced <= 0 and (est is None or 4 * est <= budget):
        return None
    build = ex.execute(node.right)
    build_bytes = sum(col_bytes(c) for c in build.columns.values()) \
        + 2 * build.capacity * 8
    if forced <= 0 and est <= max(budget - build_bytes, 0):
        return build
    from .executor import QueryError
    raise QueryError("not yet ported: streamed join (the probe scan does "
                     "not fit the memory left after the build side)")
