"""Streaming ingestion + continuous queries.

Counterpart of ``trino_tpu/streaming/`` (host code); the stream
catalog's scans decode onto the runner's device and the continuous
jobs' cycles run through the port's coordinator.

Three layers over the batch engine:

- ``log.py``: an append-only partitioned message log — the in-process
  broker of a kafka/redis-class connector, durable as length-prefixed
  segment files under ``CONFIG.stream_dir`` so coordinator and worker
  PROCESSES share one log through the filesystem.
- ``offsets.py``: per-consumer committed offsets spooled under the
  reserved fragment -3 (first-commit-wins per epoch), so incremental
  scans resume from the committed watermark instead of offset 0 and
  re-ingestion after a crash is idempotent up to the last sealed epoch.
- ``continuous.py``: long-lived INSERT INTO ... SELECT jobs and
  periodic-refresh (optionally watermarked, windowed) materialized
  views that re-dispatch the incremental plan on a cadence through the
  coordinator's normal query tracker — every cycle is a real tracked
  query riding the stage DAG, FTE retries, and observability.

The SQL-visible half is ``connectors/stream.py`` (catalog ``stream``):
topics are tables decoded through ``formats/record_decoder.py``, splits
are per-partition offset ranges, and an exact offset window can be
pinned into the table NAME (``"t$win.<p>:<s>:<e>,...#<consumer>"``) so
it rides the serialized plan to any worker process.
"""

from .log import MessageLog, get_log  # noqa: F401
from .offsets import OffsetStore  # noqa: F401
