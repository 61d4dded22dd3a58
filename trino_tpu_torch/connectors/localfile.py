"""Local-file connector: a directory of Parquet/ORC/CSV/JSON files as
tables, on the connector's device.

Counterpart of ``trino_tpu/connectors/localfile.py``. Each file (by its
basename) is a table; a Parquet file has one split per row group and an
ORC file one per stripe, read by this package's readers straight into
lanes on the connector's device (cuda unless ``device="cpu"``). CREATE
TABLE writes an empty file in ``write_format`` ("parquet" or "orc");
INSERT rewrites the file under the write lock (missing columns filled
with NULL, the parts joined on the device by ``device_concat``); DROP
TABLE removes it. Filter and limit pushdown are accepted and enforced in
``read_split`` (``predicate.filter_batch_host``, vectorised).

Like the reference it sets no ``scan_cache_ok``: a file can change
between queries, so its lanes stay out of exec/scancache.py.

Reference parity: plugin/trino-local-file generalized with the record
decoders of lib/trino-record-decoder and the parquet binding the hive
plugin provides in the reference.
"""

from __future__ import annotations

import csv
import json
import os
import threading
from typing import Dict, List, Optional, Sequence

import torch

from ..catalog import (ColumnMetadata, Connector, Split, TableHandle,
                       TableMetadata, accept_filter_pushdown,
                       accept_limit_pushdown)
from ..columnar import (Batch, Column, StringDictionary, batch_from_pylist,
                        empty_batch, torch_dtype)
from ..config import DeviceLike, resolve_device
from ..types import BIGINT, BOOLEAN, DOUBLE, Type, VARCHAR, is_string

_EXTS = (".parquet", ".orc", ".csv", ".tsv", ".json", ".ndjson")


class LocalFileConnector(Connector):
    name = "localfile"

    def __init__(self, root: str, device: DeviceLike = None):
        self.root = root
        self.device = resolve_device(device)
        self._write_lock = threading.Lock()

    # --- metadata --------------------------------------------------------
    def list_schemas(self) -> List[str]:
        return ["default"]

    def _path_of(self, table: str) -> Optional[str]:
        for fn in sorted(os.listdir(self.root)):
            base, ext = os.path.splitext(fn)
            if ext.lower() in _EXTS and base.lower() == table:
                return os.path.join(self.root, fn)
        return None

    def list_tables(self, schema: str) -> List[str]:
        out = []
        if schema != "default" or not os.path.isdir(self.root):
            return out
        for fn in sorted(os.listdir(self.root)):
            base, ext = os.path.splitext(fn)
            if ext.lower() in _EXTS:
                out.append(base.lower())
        return out

    def get_table_metadata(self, schema, table) -> Optional[TableMetadata]:
        path = self._path_of(table)
        if path is None:
            return None
        schema_map = self._schema_for(path)
        return TableMetadata(schema, table, tuple(
            ColumnMetadata(n, t) for n, t in schema_map.items()))

    def _schema_for(self, path: str) -> Dict[str, Type]:
        ext = os.path.splitext(path)[1].lower()
        if ext == ".parquet":
            from ..formats.parquet import schema_of
            return schema_of(path)
        if ext == ".orc":
            from ..formats.orc import schema_of
            return schema_of(path)
        if ext in (".csv", ".tsv"):
            rows = self._csv_rows(path, limit=100)
            return _infer_schema(rows)
        rows = self._json_rows(path, limit=100)
        return _infer_schema(rows)

    # --- rows ------------------------------------------------------------
    def _csv_rows(self, path: str,
                  limit: Optional[int] = None) -> List[dict]:
        delim = "\t" if path.lower().endswith(".tsv") else ","
        out = []
        with open(path, newline="") as f:
            for i, row in enumerate(csv.DictReader(f, delimiter=delim)):
                if limit is not None and i >= limit:
                    break
                out.append({k.lower(): v for k, v in row.items()})
        return out

    def _json_rows(self, path: str,
                   limit: Optional[int] = None) -> List[dict]:
        out = []
        with open(path) as f:
            for i, line in enumerate(f):
                if limit is not None and i >= limit:
                    break
                line = line.strip()
                if line:
                    out.append({k.lower(): v
                                for k, v in json.loads(line).items()})
        return out

    # --- data out (page-sink SPI: formats/{orc,parquet}_writer.py) -------
    write_format = "parquet"          # or "orc"
    # types both writers round-trip exactly (smallint would silently
    # widen to integer on rewrite — reject it up front)
    _WRITABLE = ("bigint", "integer", "double", "boolean", "date")

    def _check_writable(self, name: str, t: Type) -> None:
        if t.name not in self._WRITABLE and not is_string(t):
            raise ValueError(
                f"localfile writer: column '{name}' has type {t}, "
                f"which the {self.write_format} writer cannot "
                "round-trip exactly")

    def _write(self, path: str, batch: Batch,
               fmt: Optional[str] = None) -> None:
        fmt = fmt or ("orc" if path.lower().endswith(".orc")
                      else "parquet")
        if fmt == "orc":
            from ..formats.orc_writer import write_orc
            write_orc(path, batch)
        else:
            from ..formats.parquet_writer import write_parquet
            write_parquet(path, batch)

    def _read_table(self, path: str) -> Batch:
        """Whole-table read, for insert's rewrite."""
        ext = os.path.splitext(path)[1].lower()
        if ext == ".parquet":
            from ..formats.parquet import read_parquet
            return read_parquet(path, device=self.device)
        if ext == ".orc":
            from ..formats.orc import read_orc
            return read_orc(path, device=self.device)
        raise ValueError(f"writes to {ext} tables are not supported")

    def _check_schema(self, schema: str) -> None:
        if schema != "default":
            raise KeyError(f"Schema '{schema}' does not exist")

    def create_table(self, metadata: TableMetadata) -> None:
        self._check_schema(metadata.schema)
        if self._path_of(metadata.name) is not None:
            raise ValueError(
                f"Table '{metadata.name}' already exists")
        for c in metadata.columns:
            self._check_writable(c.name, c.type)
        path = os.path.join(self.root,
                            f"{metadata.name}.{self.write_format}")
        self._write(path, empty_batch(
            {c.name: c.type for c in metadata.columns}, self.device))

    def drop_table(self, schema: str, table: str) -> None:
        self._check_schema(schema)
        path = self._path_of(table)
        if path is None:
            raise KeyError(f"table {table} does not exist")
        os.remove(path)

    def insert(self, schema: str, table: str, batch: Batch) -> int:
        """Append by rewrite under the connector's write lock (single
        -file tables; the reference's page sink streams new files into
        a directory instead). The incoming batch is aligned to the
        table schema: missing columns fill with NULL, unknown columns
        are rejected."""
        self._check_schema(schema)
        with self._write_lock:
            path = self._path_of(table)
            if path is None:
                raise KeyError(f"table {table} does not exist")
            tschema = self._schema_for(path)
            extra = [c for c in batch.columns if c not in tschema]
            if extra:
                raise ValueError(
                    f"INSERT columns {extra} do not exist in "
                    f"'{table}'")
            n = batch.num_rows_host()
            if batch.device != self.device:
                batch = batch.to(self.device)
            cols = {name: batch.column(name) if name in batch.columns
                    else _null_column(t, batch.capacity, self.device)
                    for name, t in tschema.items()}
            aligned = Batch(cols, n)
            existing = self._read_table(path)
            from ..exec.executor import device_concat
            merged = (aligned if existing.num_rows_host() == 0
                      else device_concat([existing, aligned]))
            ext = os.path.splitext(path)[1].lower()
            # the tmp suffix hides the real extension: pass the format
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                self._write(tmp, merged, fmt=ext.lstrip("."))
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            return n

    # --- splits ----------------------------------------------------------
    def get_splits(self, handle: TableHandle,
                   desired_parallelism: int = 1) -> List[Split]:
        path = self._path_of(handle.table)
        if path and path.lower().endswith(".parquet"):
            from ..formats.parquet import num_row_groups
            n = max(1, num_row_groups(path))
            return [Split(handle, i, n) for i in range(n)]
        if path and path.lower().endswith(".orc"):
            from ..formats.orc import num_stripes
            n = max(1, num_stripes(path))
            return [Split(handle, i, n) for i in range(n)]
        return [Split(handle, 0, 1)]

    # --- data in ---------------------------------------------------------
    def read_split(self, split: Split, columns: Sequence[str]) -> Batch:
        path = self._path_of(split.handle.table)
        if path is None:
            raise KeyError(f"table {split.handle.table} vanished")
        ext = os.path.splitext(path)[1].lower()
        need = list(columns)
        if split.handle.constraint is not None:
            # constraint columns must be materialized to enforce the
            # accepted pushdown even when projection-pruned
            for c, _ in split.handle.constraint.domains:
                if c not in need:
                    need.append(c)
        part = split.part if split.part_count > 1 else None
        if ext == ".parquet":
            from ..formats.parquet import read_parquet
            batch = read_parquet(path, columns=need, row_group=part,
                                 device=self.device)
        elif ext == ".orc":
            from ..formats.orc import read_orc
            batch = read_orc(path, columns=need, stripe_index=part,
                             device=self.device)
        else:
            rows = (self._csv_rows(path) if ext in (".csv", ".tsv")
                    else self._json_rows(path))
            schema = self._schema_for(path)
            data = {name: [_coerce(r.get(name), t) for r in rows]
                    for name, t in schema.items()}
            batch = batch_from_pylist(data, schema, self.device)
        if split.handle.constraint is not None \
                or split.handle.limit is not None:
            from ..predicate import filter_batch_host
            batch = filter_batch_host(batch, split.handle.constraint,
                                      split.handle.limit)
        return batch.select_columns(list(columns))

    def apply_filter(self, handle: TableHandle, constraint):
        return accept_filter_pushdown(handle, constraint)

    def apply_limit(self, handle: TableHandle, limit: int):
        return accept_limit_pushdown(handle, limit)

    def table_row_count(self, handle: TableHandle) -> Optional[float]:
        path = self._path_of(handle.table)
        if path and path.lower().endswith(".parquet"):
            from ..formats.parquet import read_metadata
            return float(read_metadata(path).num_rows)
        if path and path.lower().endswith(".orc"):
            from ..formats.orc import read_meta
            return float(read_meta(path).num_rows)
        return None


def _null_column(t: Type, cap: int, device) -> Column:
    """An all-NULL column of ``t`` over ``cap`` rows on ``device``."""
    invalid = torch.zeros(cap, dtype=torch.bool, device=device)
    if is_string(t):
        d, _ = StringDictionary.from_strings([])
        return Column(t, torch.zeros(cap, dtype=torch.int32, device=device),
                      invalid, d)
    return Column(t, torch.zeros(cap, dtype=torch_dtype(t), device=device),
                  invalid)


def _infer_schema(rows: List[dict]) -> Dict[str, Type]:
    """Type inference over sampled rows (record-decoder style: every
    CSV value is text; JSON carries bool/number natively)."""
    if not rows:
        return {}
    schema: Dict[str, Type] = {}
    for key in rows[0]:
        vals = [r.get(key) for r in rows if r.get(key) not in (None, "")]
        schema[key] = _infer_type(vals)
    return schema


def _infer_type(vals: list) -> Type:
    if not vals:
        return VARCHAR
    if all(isinstance(v, bool) for v in vals):
        return BOOLEAN
    if all(isinstance(v, int) and not isinstance(v, bool)
           for v in vals):
        return BIGINT
    if all(isinstance(v, (int, float)) and not isinstance(v, bool)
           for v in vals):
        return DOUBLE
    if all(isinstance(v, str) for v in vals):
        if all(_is_int(v) for v in vals):
            return BIGINT
        if all(_is_float(v) for v in vals):
            return DOUBLE
        low = {v.lower() for v in vals}
        if low <= {"true", "false"}:
            return BOOLEAN
    return VARCHAR


def _is_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _coerce(v, t: Type):
    if v is None or v == "":
        return None
    if t is BIGINT:
        return int(v)
    if t is DOUBLE:
        return float(v)
    if t is BOOLEAN:
        if isinstance(v, bool):
            return v
        return str(v).lower() == "true"
    return str(v)
