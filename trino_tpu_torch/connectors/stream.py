"""Stream connector: topics of the append-only message log as tables.

Counterpart of ``trino_tpu/connectors/stream.py``: the same table
references, splits, ledger columns and writes; a split's messages
decode on the host (``formats/record_decoder.py``) into lanes on the
connector's device (cuda unless ``device="cpu"``), only the fields the
scan asks for, and the ledger lanes are made there with ``torch``.

Reference parity: plugin/trino-kafka (KafkaMetadata, KafkaSplitManager,
KafkaRecordSetProvider) collapsed onto the in-process broker
(streaming/log.py). A topic is a table in schema ``default``; its rows
are the messages decoded through ``formats/record_decoder.py`` (json /
csv / raw per the topic config), plus two connector columns every
stream table carries:

- ``_partition`` BIGINT — the message's log partition
- ``_offset``    BIGINT — its offset within that partition

(the reference's $-prefixed internal kafka columns; renamed because $
is reserved here for the window suffix). They make the ingest ledger
SQL-visible: ``SELECT _partition, max(_offset) ... GROUP BY 1`` is the
zero-dup/zero-loss proof the streaming e2e asserts.

Offset windows ride the TABLE NAME: a scan of
``"events$win.0:10:20,1:0:15#job1"`` reads exactly offsets [10,20) of
partition 0 and [0,15) of partition 1. The suffix survives plan serde
to any worker process (quoted identifiers pass the tokenizer
verbatim), which is what makes a continuous query's incremental cycle
EXACT: every retry of every task re-reads the identical window, so
first-commit-wins dedup upstream sees bit-identical frames. Scans
without a window read [committed ...0, live end) — a plain
``SELECT count(*) FROM stream.default.events`` watches the log grow.

Splits are per-partition (one split per log partition), so a
multi-partition topic fans out across workers like any other scan.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..catalog import (ColumnMetadata, Connector, Split, TableHandle,
                       TableMetadata)
from ..columnar import Batch, Column
from ..config import DeviceLike, capacity_for, resolve_device
from ..formats.record_decoder import DecoderField, create_decoder
from ..streaming.log import MessageLog, get_log
from ..types import BIGINT, VARCHAR, parse_type

# {partition: (start, end)} — the exact half-open ranges of one scan
Window = Dict[int, Tuple[int, int]]

_PARTITION_COL = "_partition"
_OFFSET_COL = "_offset"


def window_ref(topic: str, window: Window, consumer: str = "") -> str:
    """Encode an exact scan window into a table reference (quote it
    in SQL: ``"events$win.0:0:10#job1"``)."""
    spans = ",".join(f"{p}:{s}:{e}"
                     for p, (s, e) in sorted(window.items()))
    tag = f"#{consumer}" if consumer else ""
    return f"{topic}$win.{spans}{tag}"


def parse_table_ref(name: str) -> Tuple[str, Optional[Window]]:
    """Invert ``window_ref``; a plain topic name parses to (name,
    None) = scan-to-live-end."""
    if "$win." not in name:
        return name, None
    topic, _, rest = name.partition("$win.")
    rest = rest.partition("#")[0]
    window: Window = {}
    for span in rest.split(","):
        if not span:
            continue
        p, s, e = span.split(":")
        window[int(p)] = (int(s), int(e))
    return topic, window


class StreamConnector(Connector):
    name = "stream"
    # appends mutate live-end scans between queries; data_version()
    # below gives the result cache a real invalidation signal instead
    scan_cache_ok = False

    def __init__(self, base_dir: Optional[str] = None,
                 log: Optional[MessageLog] = None,
                 device: DeviceLike = None):
        self.log = log or get_log(base_dir)
        self.device = resolve_device(device)

    # --- metadata --------------------------------------------------------
    def list_schemas(self) -> List[str]:
        return ["default"]

    def list_tables(self, schema: str) -> List[str]:
        return self.log.topics() if schema == "default" else []

    def _decoder_fields(self, cfg: dict) -> List[DecoderField]:
        fields = cfg.get("fields") or []
        if not fields:
            # schemaless topic (implicitly created by a first ingest):
            # the whole message is one varchar column
            return [DecoderField("_message", VARCHAR)]
        return [DecoderField(n, parse_type(t), m)
                for n, t, m in fields]

    def get_table_metadata(self, schema: str,
                           table: str) -> Optional[TableMetadata]:
        if schema != "default":
            return None
        topic, _ = parse_table_ref(table)
        cfg = self.log.topic_config(topic)
        if cfg is None:
            return None
        cols = tuple(ColumnMetadata(f.name, f.type)
                     for f in self._decoder_fields(cfg))
        cols += (ColumnMetadata(_PARTITION_COL, BIGINT, hidden=True),
                 ColumnMetadata(_OFFSET_COL, BIGINT, hidden=True))
        # keep the windowed name in the metadata so the handle the
        # planner builds from it round-trips the window through serde
        return TableMetadata(schema, table, cols)

    # --- scan ------------------------------------------------------------
    def _window(self, table: str) -> Tuple[str, Window]:
        topic, window = parse_table_ref(table)
        if window is None:
            window = {p: (0, e)
                      for p, e in self.log.end_offsets(topic).items()}
        return topic, window

    def get_splits(self, handle: TableHandle,
                   desired_parallelism: int = 1) -> List[Split]:
        _, window = self._window(handle.table)
        nparts = max(len(window), 1)
        return [Split(handle, p, nparts) for p in sorted(window)] \
            or [Split(handle, 0, 1)]

    def read_split(self, split: Split,
                   columns: Sequence[str]) -> Batch:
        topic, window = self._window(split.handle.table)
        cfg = self.log.topic_config(topic)
        if cfg is None:
            raise KeyError(f"stream topic {topic!r} does not exist")
        part = sorted(window)[split.part] if window else 0
        start, end = window.get(part, (0, 0))
        messages = self.log.read(topic, part, start, end)
        want = set(columns)
        fields = self._decoder_fields(cfg)
        # schemaless topics (no declared fields) always decode raw:
        # the whole message IS the _message column, json or not
        kind = (cfg.get("decoder", "json") if cfg.get("fields")
                else "raw")
        # a field the scan does not read is not decoded: the rows are
        # the same, and a ledger-only scan parses no message at all
        fields = [f for f in fields if f.name in want]
        n = len(messages)
        if fields:
            batch = create_decoder(kind, fields,
                                   self.device).decode(messages)
        else:
            batch = Batch({}, n)
        cap = batch.capacity or capacity_for(n, minimum=8)
        cols = dict(batch.columns)
        # the ledger lanes, made on the device (rows past n are padding)
        if _PARTITION_COL in want:
            cols[_PARTITION_COL] = Column(BIGINT, torch.full(
                (cap,), part, dtype=torch.int64, device=self.device))
        if _OFFSET_COL in want:
            cols[_OFFSET_COL] = Column(BIGINT, torch.arange(
                start, start + cap, dtype=torch.int64,
                device=self.device))
        return Batch(cols, n).select_columns(list(columns))

    def table_row_count(self, handle: TableHandle) -> Optional[float]:
        _, window = self._window(handle.table)
        return float(sum(e - s for s, e in window.values()))

    def data_version(self) -> Optional[int]:
        return self.log.data_version()

    # --- DDL / writes ----------------------------------------------------
    def create_table(self, metadata: TableMetadata) -> None:
        """CREATE TABLE stream.default.t (...) creates the topic with
        the json decoder; each column maps its own name as the
        document path. Connector columns are implicit — declaring
        them is an error."""
        fields = []
        for c in metadata.columns:
            if c.name in (_PARTITION_COL, _OFFSET_COL):
                raise ValueError(
                    f"column {c.name!r} is reserved on stream tables")
            fields.append((c.name, getattr(c.type, "name",
                                           str(c.type)), None))
        self.log.create_topic(metadata.name, "json", fields)

    def drop_table(self, schema: str, table: str) -> None:
        topic, _ = parse_table_ref(table)
        self.log.drop_topic(topic)

    def insert(self, schema: str, table: str, batch: Batch) -> int:
        """INSERT INTO a topic appends one json document per row —
        the SQL-side producer (the HTTP side is /v1/ingest)."""
        import json as _json
        topic, _ = parse_table_ref(table)
        cfg = self.log.topic_config(topic)
        if cfg is None:
            raise KeyError(f"stream topic {topic!r} does not exist")
        names = [n for n in batch.names
                 if n not in (_PARTITION_COL, _OFFSET_COL)]
        rows = batch.select_columns(names).to_pylist()
        msgs = [_json.dumps(dict(zip(names, r)),
                            default=str).encode()
                for r in rows]
        if msgs:
            self.log.append(topic, msgs)
        return len(msgs)
