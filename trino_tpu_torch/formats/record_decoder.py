"""Row decoders for raw byte messages — lib/trino-record-decoder.

Counterpart of ``trino_tpu/formats/record_decoder.py``, with the same
decoders and the same lenient rules; the decoded batch lands on the
decoder's device (cuda unless it was built with ``device="cpu"``).
Column-at-a-time: each field extracts across ALL messages into a lane,
then the batch assembles once (the JSON decoder's cost is the host's,
one ``json.loads`` a message).

Decoders: ``json`` (mapping = dot path into the document), ``csv``
(mapping = field index), ``raw`` (whole message as varchar).
"""

from __future__ import annotations

import csv as _csv
import io
import json as _json
from dataclasses import dataclass
from itertools import repeat
from typing import Dict, Optional, Sequence

from ..columnar import LANE_PY_TYPE, Batch, batch_from_pylist
from ..config import DeviceLike, resolve_device
from ..types import Type, is_string


@dataclass(frozen=True)
class DecoderField:
    """One decoded column (DecoderColumnHandle): output name, SQL type,
    and the decoder-specific mapping (json path / csv index)."""
    name: str
    type: Type
    mapping: Optional[str] = None


def _coerce(v, t: Type):
    if v is None:
        return None
    try:
        if t.name in ("bigint", "integer", "smallint", "tinyint"):
            return int(v)
        if t.name in ("double", "real"):
            return float(v)
        if t.name == "boolean":
            if isinstance(v, str):
                return v.strip().lower() in ("true", "t", "1")
            return bool(v)
        if is_string(t):
            return v if isinstance(v, str) else _json.dumps(v)
    except (TypeError, ValueError):
        return None
    return v


def _json_path(doc, path: str):
    cur = doc
    for part in path.split("/" if "/" in path else "."):
        if isinstance(cur, dict):
            cur = cur.get(part)
        elif isinstance(cur, list):
            try:
                cur = cur[int(part)]
            except (ValueError, IndexError):
                return None
        else:
            return None
    return cur


class RowDecoder:
    """decode(messages) -> Batch (RowDecoder.decodeRow, batched)."""

    def __init__(self, fields: Sequence[DecoderField],
                 device: DeviceLike = None):
        self.fields = list(fields)
        self.device = resolve_device(device)

    def decode(self, messages: Sequence[bytes]) -> Batch:
        raise NotImplementedError


class JsonRowDecoder(RowDecoder):
    """decoder/json/JsonRowDecoder.java: one JSON document per
    message; mappings are dot/slash paths. Undecodable messages decode
    to all-NULL rows (the reference's lenient mode)."""

    def decode(self, messages: Sequence[bytes]) -> Batch:
        docs = []
        for m in messages:
            try:
                docs.append(_json.loads(m))
            except ValueError:  # a JSONDecodeError or UnicodeDecodeError
                docs.append(None)
        all_dicts = all(type(d) is dict for d in docs)
        data: Dict[str, list] = {}
        for f in self.fields:
            data[f.name] = _coerce_all(
                _extract(docs, f.mapping or f.name, all_dicts), f.type)
        return batch_from_pylist(data,
                                 {f.name: f.type for f in self.fields},
                                 self.device)


def _extract(docs: list, path: str, all_dicts: bool = False) -> list:
    """``_json_path`` of every document; a one-segment path reads a dict
    document's key directly (the same value, without the walk)."""
    if "/" in path or "." in path:
        return [None if d is None else _json_path(d, path) for d in docs]
    if all_dicts:
        return list(map(dict.get, docs, repeat(path)))
    return [d.get(path) if type(d) is dict
            else None if d is None else _json_path(d, path)
            for d in docs]


def _coerce_all(values: list, t: Type) -> list:
    """``_coerce`` of every value; values of the lane's own python type
    pass as they are (which is what ``_coerce`` returns for them)."""
    native = str if is_string(t) else LANE_PY_TYPE.get(t.name)
    if native is None:
        return [_coerce(v, t) for v in values]
    return [v if type(v) is native else _coerce(v, t) for v in values]


class CsvRowDecoder(RowDecoder):
    """decoder/csv/CsvRowDecoder.java: one CSV record per message;
    mapping is the zero-based field index (required — a silent
    default would decode column 0 into a misconfigured field)."""

    def __init__(self, fields, device: DeviceLike = None):
        super().__init__(fields, device)
        for f in self.fields:
            if f.mapping is None or not str(f.mapping).isdigit():
                raise ValueError(
                    f"csv decoder field '{f.name}' needs a numeric "
                    f"mapping (got {f.mapping!r})")

    def decode(self, messages: Sequence[bytes]) -> Batch:
        rows = []
        for m in messages:
            try:
                parsed = next(_csv.reader(
                    io.StringIO(m.decode("utf-8", "replace"))), [])
            except Exception:       # noqa: BLE001
                parsed = []
            rows.append(parsed)
        data: Dict[str, list] = {}
        for f in self.fields:
            idx = int(f.mapping) if f.mapping is not None else 0
            data[f.name] = [
                _coerce(r[idx], f.type) if idx < len(r) else None
                for r in rows]
        return batch_from_pylist(data,
                                 {f.name: f.type for f in self.fields},
                                 self.device)


class RawRowDecoder(RowDecoder):
    """decoder/raw/RawRowDecoder.java collapsed to the varchar case:
    the whole message is the single field's value."""

    def decode(self, messages: Sequence[bytes]) -> Batch:
        f = self.fields[0]
        data = {f.name: [m.decode("utf-8", "replace")
                         for m in messages]}
        return batch_from_pylist(data, {f.name: f.type}, self.device)


_DECODERS = {"json": JsonRowDecoder, "csv": CsvRowDecoder,
             "raw": RawRowDecoder}


def create_decoder(kind: str, fields: Sequence[DecoderField],
                   device: DeviceLike = None) -> RowDecoder:
    """DispatchingRowDecoderFactory.create analog."""
    cls = _DECODERS.get(kind)
    if cls is None:
        raise ValueError(f"unknown decoder '{kind}' "
                         f"(have: {sorted(_DECODERS)})")
    return cls(fields, device)
