"""Connector SPI + catalog management.

Reference parity: core/trino-spi/src/main/java/io/trino/spi/connector/
(Connector, ConnectorMetadata, ConnectorSplitManager, ConnectorPageSource —
spi/connector/ConnectorPageSource.java:47) and the engine-side
metadata/CatalogManager.java + MetadataManager.java routing. TPU-first
redesign: a connector's read path produces columnar ``Batch``es per split
(host numpy, uploaded to HBM lazily), not row cursors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .columnar import Batch
from .types import Type


@dataclass(frozen=True)
class ColumnMetadata:
    """spi/connector/ColumnMetadata.java"""
    name: str
    type: Type
    # connector-provided columns (ColumnMetadata.isHidden analog —
    # e.g. the stream connector's _partition/_offset ledger): still
    # selectable by name, but never an INSERT target
    hidden: bool = False


@dataclass(frozen=True)
class TableMetadata:
    """spi/connector/ConnectorTableMetadata.java"""
    schema: str
    name: str
    columns: Tuple[ColumnMetadata, ...]

    def column_type(self, name: str) -> Type:
        for c in self.columns:
            if c.name == name:
                return c.type
        raise KeyError(name)

    @property
    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]


@dataclass(frozen=True)
class ColumnStatistics:
    """spi/statistics/ColumnStatistics.java: distinct-value count,
    value range (numeric/date columns; None for strings), null
    fraction."""
    ndv: float
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    null_fraction: float = 0.0


@dataclass(frozen=True)
class ViewDefinition:
    """Engine view object (reference: metadata/ViewDefinition.java):
    the parsed query plus the original SQL text for SHOW CREATE VIEW."""
    query: object            # sql.ast.Query
    sql: str = ""


@dataclass(frozen=True)
class TableHandle:
    """Engine-side handle: catalog + connector's table identity
    (reference: metadata/TableHandle.java wrapping
    ConnectorTableHandle). ``constraint``/``limit`` carry accepted
    pushdowns (applyFilter/applyLimit results baked into the handle,
    like the reference's connector-specific handle evolution)."""
    catalog: str
    schema: str
    table: str
    constraint: Optional[object] = None    # predicate.TupleDomain
    limit: Optional[int] = None


@dataclass(frozen=True)
class Split:
    """One unit of scan parallelism (spi/connector/ConnectorSplit.java).
    ``part``/``part_count`` mirror the tpch connector's split addressing
    (plugin/trino-tpch/.../TpchSplitManager.java:32-46)."""
    handle: TableHandle
    part: int
    part_count: int


class Connector:
    """Connector SPI (spi/connector/Connector.java + ConnectorMetadata +
    ConnectorSplitManager + page source in one surface — the engine is in
    one process per node, so the factory indirection is unnecessary)."""

    name: str = "connector"

    # Splits are deterministic + immutable (pure generators): the
    # engine may cache read results device-resident across queries.
    scan_cache_ok: bool = False

    # --- metadata --------------------------------------------------------
    def list_schemas(self) -> List[str]:
        raise NotImplementedError

    def list_tables(self, schema: str) -> List[str]:
        raise NotImplementedError

    def get_table_metadata(self, schema: str,
                           table: str) -> Optional[TableMetadata]:
        raise NotImplementedError

    # --- splits ----------------------------------------------------------
    def get_splits(self, handle: TableHandle,
                   desired_parallelism: int = 1) -> List[Split]:
        return [Split(handle, 0, 1)]

    # --- data in ---------------------------------------------------------
    def read_split(self, split: Split,
                   columns: Sequence[str]) -> Batch:
        """Produce the split's rows for the requested columns
        (spi/connector/ConnectorPageSource.java:47 getNextPage, batched)."""
        raise NotImplementedError

    # --- data versioning (spi/connector/ConnectorMetadata
    # getTableHandleForExecute's table-version analog) --------------------
    def data_version(self) -> Optional[int]:
        """Monotonic data version for result-cache invalidation
        (exec/resultcache.py): a cached result is valid only while
        every scanned connector reports the version it was captured
        under. None = unversioned (mutations invisible to the engine,
        e.g. external JDBC sources) — results over it are uncacheable.
        Immutable pure generators (scan_cache_ok) are constant-1."""
        return 1 if self.scan_cache_ok else None

    # --- statistics (spi/statistics/TableStatistics.java) ----------------
    def table_row_count(self, handle: TableHandle) -> Optional[float]:
        return None

    def column_statistics(self, handle: TableHandle,
                          column: str) -> Optional["ColumnStatistics"]:
        """Per-column stats for the CBO (spi/statistics/
        ColumnStatistics.java); None = unknown."""
        return None

    # --- pushdown hooks (ConnectorMetadata.applyFilter/applyLimit) -------
    def apply_filter(self, handle: TableHandle, constraint):
        """Offer a TupleDomain over connector column names. Return
        (new_handle, fully_enforced) to accept, or None to decline.
        fully_enforced=True lets the engine drop the translated
        conjuncts entirely — only safe when read_split enforces the
        handle's constraint (predicate.filter_batch_host)."""
        return None

    def apply_limit(self, handle: TableHandle, limit: int):
        """Return a new handle that will produce at most ``limit`` rows
        per split (engine keeps its Limit node), or None."""
        return None

    # --- data out (spi/connector/ConnectorPageSink.java) -----------------
    def create_table(self, metadata: TableMetadata) -> None:
        raise NotImplementedError(f"{self.name}: CREATE TABLE not supported")

    def drop_table(self, schema: str, table: str) -> None:
        raise NotImplementedError(f"{self.name}: DROP TABLE not supported")

    def insert(self, schema: str, table: str, batch: Batch) -> int:
        raise NotImplementedError(f"{self.name}: INSERT not supported")

    # --- procedures (spi/procedure/Procedure.java) -----------------------
    def call_procedure(self, schema: str, name: str, args: list):
        raise KeyError(
            f"Procedure '{self.name}.{schema}.{name}' not registered")

    # --- transactions (spi/transaction/ConnectorTransactionHandle) -------
    def snapshot_state(self):
        """Opaque copy-on-begin state for the engine transaction manager
        (None = connector is read-only / not transactional)."""
        return None

    def restore_state(self, state) -> None:
        raise NotImplementedError(f"{self.name}: not transactional")


def accept_filter_pushdown(handle: TableHandle, constraint):
    """Shared applyFilter acceptance: intersect into the handle; the
    connector's read_split MUST then enforce handle.constraint."""
    merged = constraint if handle.constraint is None else \
        handle.constraint.intersect(constraint)
    return dataclasses.replace(handle, constraint=merged), True


def accept_limit_pushdown(handle: TableHandle, limit: int):
    """Shared applyLimit acceptance: keep the smaller limit; None when
    the handle already guarantees no more rows."""
    if handle.limit is not None and handle.limit <= limit:
        return None
    return dataclasses.replace(handle, limit=limit)


class CatalogManager:
    """metadata/CatalogManager.java — name → Connector registry, plus
    the engine-side view store (reference: MetadataManager view
    routing; views here are engine objects rather than per-connector
    since every connector would store the same SQL text)."""

    def __init__(self, access_control=None):
        self._catalogs: Dict[str, Connector] = {}
        self._views: Dict[Tuple[str, str, str], "ViewDefinition"] = {}
        # AccessControl SPI consulted by the planner/runner (None =
        # allow all; security/AccessControlManager.java)
        self.access_control = access_control
        # engine-level grant store (reference routes GRANT to connector
        # metadata — MetadataManager.grantTablePrivileges; ours is
        # engine-scoped so every connector gets GRANT support):
        # (grantee, privilege, catalog, schema, table) -> grantable
        self.grants: Dict[Tuple[str, str, str, str, str], bool] = {}
        # DENY entries (same key; deny wins over grant)
        self.denies: set = set()

    # --- views -----------------------------------------------------------
    def create_view(self, catalog: str, schema: str, name: str,
                    view: "ViewDefinition",
                    replace: bool = False) -> None:
        key = (catalog, schema, name)
        if key in self._views and not replace:
            raise KeyError(
                f"View '{catalog}.{schema}.{name}' already exists")
        self._views[key] = view

    def drop_view(self, catalog: str, schema: str, name: str) -> bool:
        return self._views.pop((catalog, schema, name), None) is not None

    def get_view(self, catalog: str, schema: str,
                 name: str) -> Optional["ViewDefinition"]:
        return self._views.get((catalog, schema, name))

    def list_views(self, catalog: str, schema: str) -> List[str]:
        return sorted(n for (c, s, n) in self._views
                      if c == catalog and s == schema)

    def register(self, name: str, connector: Connector) -> None:
        self._catalogs[name] = connector

    def connector(self, name: str) -> Connector:
        try:
            return self._catalogs[name]
        except KeyError:
            raise KeyError(f"Catalog '{name}' does not exist") from None

    def list_catalogs(self) -> List[str]:
        return sorted(self._catalogs)

    def resolve_table(self, catalog: str, schema: str,
                      table: str) -> Tuple[TableHandle, TableMetadata]:
        conn = self.connector(catalog)
        meta = conn.get_table_metadata(schema, table)
        if meta is None:
            raise KeyError(
                f"Table '{catalog}.{schema}.{table}' does not exist")
        return TableHandle(catalog, schema, table), meta
