"""In-memory connector: the target of CREATE TABLE, INSERT, DELETE,
UPDATE and MERGE, and the blackhole sink.

Counterpart of ``trino_tpu/connectors/memory.py``, with the table's lanes
kept on the runner's device. A table is a list of chunks: each write
stores the executor's result cut into slices of at most
``CONFIG.max_batch_rows`` rows, each slice in lanes of its own of
``capacity_for(rows)`` (``columnar.slice_rows``), so a stored table holds
none of a result's padding and no storage of the query that made it.
Each chunk is one split: an aggregation over a large table runs split by
split, as over a generated one. Reads return the chunks as they are,
with no host round trip; a lane that a join left spilled in host memory
is moved to the device when it is stored.

Filter and limit pushdown are accepted, as in the reference, and
``read_split`` enforces them on each chunk on the device
(``tpch_device.device_filter``): a split's limit caps that chunk only,
and the planner keeps its LimitNode above the scan, which caps the
table. ``data_version`` is bumped by every mutation,
and ``snapshot_state`` keeps references to the stored chunks (chunks are
never written in place), which is what ROLLBACK restores.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..catalog import Connector, Split, TableHandle, TableMetadata
from ..columnar import Batch, empty_batch, slice_rows
from ..config import CONFIG, DeviceLike, resolve_device


def chunk_batch(batch: Batch, device) -> List[Batch]:
    """The live rows of ``batch`` on ``device``, as slices of at most
    ``CONFIG.max_batch_rows`` rows, each in lanes of its own. No rows, no
    chunks."""
    n = batch.num_rows_host()
    per = max(int(CONFIG.max_batch_rows), 1)
    if batch.device != device:
        batch = batch.to(device)
    return [slice_rows(batch, lo, min(lo + per, n))
            for lo in range(0, n, per)]


class MemoryConnector(Connector):
    name = "memory"

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        # (schema, table) -> (metadata, [chunk Batch])
        self._tables: Dict[Tuple[str, str],
                           Tuple[TableMetadata, List[Batch]]] = {}
        self._schemas = {"default"}
        # bumped on every mutation, so that anything keyed on it sees the
        # data change
        self._version = 1

    def data_version(self) -> Optional[int]:
        return self._version

    def list_schemas(self) -> List[str]:
        return sorted(self._schemas)

    def list_tables(self, schema: str) -> List[str]:
        return sorted(t for (s, t) in self._tables if s == schema)

    def get_table_metadata(self, schema, table) -> Optional[TableMetadata]:
        entry = self._tables.get((schema, table))
        return entry[0] if entry else None

    def create_schema(self, schema: str) -> None:
        self._schemas.add(schema)
        self._version += 1

    def create_table(self, metadata: TableMetadata) -> None:
        key = (metadata.schema, metadata.name)
        if key in self._tables:
            raise ValueError(
                f"Table '{metadata.schema}.{metadata.name}' already exists")
        self._schemas.add(metadata.schema)
        self._tables[key] = (metadata, [])
        self._version += 1

    def drop_table(self, schema: str, table: str) -> None:
        self._tables.pop((schema, table), None)
        self._version += 1

    def _chunks(self, meta: TableMetadata, batch: Batch) -> List[Batch]:
        batch = batch.rename(dict(zip(batch.names, meta.column_names)))
        return chunk_batch(batch, self.device)

    def insert(self, schema: str, table: str, batch: Batch) -> int:
        meta, chunks = self._tables[(schema, table)]
        new = self._chunks(meta, batch)
        # a new list: a snapshot's list stays as it was
        self._tables[(schema, table)] = (meta, chunks + new)
        self._version += 1
        return sum(c.num_rows_host() for c in new)

    def replace(self, schema: str, table: str, batch: Batch) -> None:
        """Swap the table's contents (DELETE, UPDATE and MERGE write the
        whole table)."""
        meta, _ = self._tables[(schema, table)]
        self._tables[(schema, table)] = (meta, self._chunks(meta, batch))
        self._version += 1

    def stored_chunks(self, schema: str, table: str) -> List[Batch]:
        """The table's chunks as stored (to measure them)."""
        return list(self._tables[(schema, table)][1])

    def get_splits(self, handle: TableHandle,
                   desired_parallelism: int = 1) -> List[Split]:
        n = max(len(self._tables[(handle.schema, handle.table)][1]), 1)
        return [Split(handle, i, n) for i in range(n)]

    def read_split(self, split: Split, columns: Sequence[str]) -> Batch:
        meta, chunks = self._tables[(split.handle.schema,
                                     split.handle.table)]
        if split.part >= len(chunks):
            want = set(columns)
            return empty_batch({c.name: c.type for c in meta.columns
                                if c.name in want}, self.device)
        chunk = chunks[split.part]
        h = split.handle
        if h.constraint is not None or h.limit is not None:
            from .tpch_device import device_filter
            chunk = device_filter(chunk, h.constraint, h.limit)
        return chunk.select_columns(list(columns))

    # --- pushdown (ConnectorMetadata.applyFilter/applyLimit) -------------
    def apply_filter(self, handle: TableHandle, constraint):
        from ..catalog import accept_filter_pushdown
        return accept_filter_pushdown(handle, constraint)

    def apply_limit(self, handle: TableHandle, limit: int):
        from ..catalog import accept_limit_pushdown
        return accept_limit_pushdown(handle, limit)

    def table_row_count(self, handle: TableHandle) -> Optional[float]:
        entry = self._tables.get((handle.schema, handle.table))
        if entry is None:
            return None
        return float(sum(b.num_rows_host() for b in entry[1]))

    # --- transactions: snapshot-on-begin, restore-on-rollback ------------
    def snapshot_state(self):
        return ({k: (meta, list(chunks))
                 for k, (meta, chunks) in self._tables.items()},
                set(self._schemas))

    def restore_state(self, state) -> None:
        tables, schemas = state
        self._tables = {k: (meta, list(chunks))
                        for k, (meta, chunks) in tables.items()}
        self._schemas = set(schemas)
        self._version += 1


class BlackholeConnector(Connector):
    """A sink that discards what it is given; reads return no rows."""

    name = "blackhole"

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._tables: Dict[Tuple[str, str], TableMetadata] = {}

    def list_schemas(self) -> List[str]:
        return ["default"]

    def list_tables(self, schema: str) -> List[str]:
        return sorted(t for (s, t) in self._tables if s == schema)

    def get_table_metadata(self, schema, table) -> Optional[TableMetadata]:
        return self._tables.get((schema, table))

    def create_table(self, metadata: TableMetadata) -> None:
        self._tables[(metadata.schema, metadata.name)] = metadata

    def drop_table(self, schema: str, table: str) -> None:
        self._tables.pop((schema, table), None)

    def insert(self, schema: str, table: str, batch: Batch) -> int:
        return batch.num_rows_host()

    def read_split(self, split: Split, columns: Sequence[str]) -> Batch:
        meta = self._tables[(split.handle.schema, split.handle.table)]
        want = set(columns)
        return empty_batch({c.name: c.type for c in meta.columns
                            if c.name in want}, self.device)
