"""Append-only partitioned message log — the in-process broker.

Counterpart of ``trino_tpu/streaming/log.py`` (host only), with the
same segment format: either package reads a topic directory the other
wrote.

Reference parity: the kafka connector's broker surface collapsed to
what the engine consumes (plugin/trino-kafka KafkaConsumerManager +
topic metadata): topics hold N partitions, a partition is a strictly
ordered sequence of byte messages addressed by offset, producers
append, consumers read half-open offset ranges.

Durability/layout: ``<base>/<topic>/topic.json`` (decoder kind +
fields + partition count, written once at topic creation) and one
segment file per partition, ``<base>/<topic>/p<k>.log``, holding
``[4-byte BE length][payload]`` frames. Appends go through one
``os.write`` on an ``O_APPEND`` fd — the frame lands atomically at the
tail, so concurrent producers (ingest HTTP threads here, a worker
process next door) interleave whole messages, never bytes. Readers
keep an in-memory offset index per partition and extend it by
scanning only the bytes appended since their last scan, which is what
makes a coordinator see a worker-side ingest (and vice versa) without
any broker-to-broker protocol: the filesystem IS the replication.

``get_log()`` returns the process-wide broker for a base dir — the
ingest HTTP route, the stream connector's scans and the continuous
scheduler must observe one index, not three.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ..config import CONFIG
from ..fte.faultpoints import fault_point
from ..obs.metrics import INGEST_BYTES, INGEST_ROWS

_LEN = struct.Struct(">I")

# topic.json field spec: [name, type string, mapping or None]
TopicFields = List[Tuple[str, str, Optional[str]]]


class _Partition:
    """One partition's segment file + its offset index."""

    def __init__(self, path: str):
        self.path = path
        self.lock = threading.Lock()
        # byte position of each record's frame start; positions[i] is
        # the frame of offset i. Extended by _refresh scans only.
        self._positions: List[int] = []
        self._scanned = 0            # bytes of self.path fully indexed

    def _refresh_locked(self) -> None:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size <= self._scanned:
            return
        with open(self.path, "rb") as f:
            f.seek(self._scanned)
            pos = self._scanned
            buf = f.read(size - self._scanned)
        i = 0
        while i + _LEN.size <= len(buf):
            (n,) = _LEN.unpack_from(buf, i)
            if i + _LEN.size + n > len(buf):
                break                # torn tail: re-scan next time
            self._positions.append(pos + i)
            i += _LEN.size + n
        self._scanned = pos + i

    def end_offset(self) -> int:
        with self.lock:
            self._refresh_locked()
            return len(self._positions)

    def append(self, messages: Sequence[bytes],
               fsync: bool) -> Tuple[int, int]:
        """Append messages; returns the [start, end) offsets covered.
        The whole batch is ONE O_APPEND write: a killed producer
        leaves at most one torn frame at the tail, which the index
        scan refuses to step past."""
        frame = b"".join(_LEN.pack(len(m)) + m for m in messages)
        with self.lock:
            self._refresh_locked()
            fd = os.open(self.path,
                         os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o600)
            try:
                os.write(fd, frame)
                if fsync:
                    os.fsync(fd)
            finally:
                os.close(fd)
            self._refresh_locked()
            end = len(self._positions)
            return end - len(messages), end

    def read(self, start: int, end: int) -> List[bytes]:
        with self.lock:
            self._refresh_locked()
            end = min(end, len(self._positions))
            if start >= end:
                return []
            first = self._positions[start]
        out: List[bytes] = []
        with open(self.path, "rb") as f:
            f.seek(first)
            for _ in range(end - start):
                (n,) = _LEN.unpack(f.read(_LEN.size))
                out.append(f.read(n))
        return out


class MessageLog:
    """All topics under one base dir; safe for concurrent producers
    and consumers across threads AND processes (see module doc)."""

    def __init__(self, base_dir: Optional[str] = None):
        self.base_dir = base_dir or CONFIG.stream_dir
        self._lock = threading.Lock()
        self._topics: Dict[str, dict] = {}       # topic -> config
        self._parts: Dict[Tuple[str, int], _Partition] = {}
        self._rr: Dict[str, int] = {}            # round-robin cursor

    # --- topic management ------------------------------------------------
    def _topic_dir(self, topic: str) -> str:
        # topics become path components and table names: reject
        # separators and the window-suffix marker outright
        if (not topic or "/" in topic or "\\" in topic or "$" in topic
                or topic.startswith(".")):
            raise ValueError(f"invalid topic name {topic!r}")
        return os.path.join(self.base_dir, topic)

    def create_topic(self, topic: str, decoder: str = "json",
                     fields: Optional[TopicFields] = None,
                     partitions: Optional[int] = None) -> dict:
        """Idempotent: an existing topic's config wins (first writer
        seals it via O_EXCL, racers adopt the winner)."""
        d = self._topic_dir(topic)
        cfg = {"topic": topic, "decoder": decoder,
               "fields": [list(f) for f in (fields or [])],
               "partitions": int(partitions
                                 or CONFIG.stream_partitions)}
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "topic.json")
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL,
                         0o600)
            with os.fdopen(fd, "w") as f:
                json.dump(cfg, f)
        except FileExistsError:
            pass
        return self.topic_config(topic)

    def topic_config(self, topic: str) -> Optional[dict]:
        with self._lock:
            cfg = self._topics.get(topic)
        if cfg is not None:
            return cfg
        try:
            with open(os.path.join(self._topic_dir(topic),
                                   "topic.json")) as f:
                cfg = json.load(f)
        except (OSError, ValueError):
            return None
        with self._lock:
            self._topics.setdefault(topic, cfg)
            return self._topics[topic]

    def topics(self) -> List[str]:
        try:
            names = os.listdir(self.base_dir)
        except OSError:
            return []
        return sorted(t for t in names
                      if self.topic_config(t) is not None)

    def drop_topic(self, topic: str) -> None:
        d = self._topic_dir(topic)
        import shutil
        shutil.rmtree(d, ignore_errors=True)
        with self._lock:
            self._topics.pop(topic, None)
            for k in [k for k in self._parts if k[0] == topic]:
                self._parts.pop(k)

    # --- data plane ------------------------------------------------------
    def _partition(self, topic: str, part: int) -> _Partition:
        key = (topic, part)
        with self._lock:
            p = self._parts.get(key)
            if p is None:
                p = _Partition(os.path.join(self._topic_dir(topic),
                                            f"p{part}.log"))
                self._parts[key] = p
            return p

    def append(self, topic: str, messages: Sequence[bytes],
               partition: Optional[int] = None,
               key: Optional[str] = None) -> Dict[int, Tuple[int, int]]:
        """Append messages to one partition (explicit ``partition``,
        hash of ``key``, else round-robin). Returns
        {partition: (start, end)}. Implicitly creates an unknown topic
        with the default json decoder (schemaless until CREATE TABLE /
        create_topic declares fields)."""
        cfg = self.topic_config(topic) or self.create_topic(topic)
        nparts = int(cfg.get("partitions") or 1)
        if partition is None:
            if key is not None:
                # stable across processes (hash() is seed-randomized)
                import zlib
                partition = zlib.crc32(key.encode()) % nparts
            else:
                with self._lock:
                    partition = self._rr.get(topic, 0) % nparts
                    self._rr[topic] = partition + 1
        elif not 0 <= partition < nparts:
            raise ValueError(
                f"partition {partition} out of range for topic "
                f"{topic!r} ({nparts} partitions)")
        # chaos site: a crash here is a producer dying BEFORE the
        # frame lands — the at-least-once retry case; a crash between
        # append and the producer's HTTP response is the duplicate
        # case the offset-windowed reader dedupes by position
        fault_point("stream.pre_append")
        messages = [m if isinstance(m, bytes) else bytes(m)
                    for m in messages]
        rng = self._partition(topic, partition).append(
            messages, CONFIG.stream_fsync)
        INGEST_ROWS.inc(len(messages), topic=topic)
        INGEST_BYTES.inc(sum(len(m) for m in messages), topic=topic)
        return {partition: rng}

    def end_offsets(self, topic: str) -> Dict[int, int]:
        cfg = self.topic_config(topic)
        if cfg is None:
            return {}
        return {p: self._partition(topic, p).end_offset()
                for p in range(int(cfg.get("partitions") or 1))}

    def read(self, topic: str, partition: int, start: int,
             end: int) -> List[bytes]:
        return self._partition(topic, partition).read(start, end)

    def data_version(self) -> int:
        """Monotonic over appends (result-cache invalidation): total
        indexed bytes across every partition segment on disk."""
        total = 0
        for t in self.topics():
            d = self._topic_dir(t)
            try:
                for n in os.listdir(d):
                    if n.startswith("p") and n.endswith(".log"):
                        total += os.path.getsize(os.path.join(d, n))
            except OSError:
                pass
        return total


def ingest_http(log: "MessageLog", topic: str, body: bytes,
                params: Dict[str, list]) -> dict:
    """The one POST /v1/ingest/{topic} implementation shared by the
    coordinator and the task worker: newline-delimited messages in the
    body (empty lines skipped), optional ``partition`` / ``key`` query
    params routing the whole batch."""
    messages = [ln for ln in body.split(b"\n") if ln]
    partition = (int(params["partition"][0])
                 if params.get("partition") else None)
    key = params["key"][0] if params.get("key") else None
    ranges: Dict[int, Tuple[int, int]] = {}
    if messages:
        ranges = log.append(topic, messages, partition=partition,
                            key=key)
    return {"topic": topic, "count": len(messages),
            "ranges": {str(p): [s, e]
                       for p, (s, e) in ranges.items()},
            "endOffsets": {str(p): e
                           for p, e in log.end_offsets(topic).items()}}


_LOGS: Dict[str, MessageLog] = {}
_LOGS_LOCK = threading.Lock()


def get_log(base_dir: Optional[str] = None) -> MessageLog:
    """The process-wide broker for a base dir (see module doc)."""
    base = os.path.abspath(base_dir or CONFIG.stream_dir)
    with _LOGS_LOCK:
        log = _LOGS.get(base)
        if log is None:
            log = MessageLog(base)
            _LOGS[base] = log
        return log
