"""Process-wide metrics registry with Prometheus text exposition.

Counterpart of ``trino_tpu/obs/metrics.py``: a small lock-safe process
singleton (``METRICS``) of counters, gauges and histograms, rendered in
the Prometheus text format (version 0.0.4) at GET /metrics on the
coordinator (server/coordinator.py).

- One ``threading.Lock`` per registry covers every mutation and the
  render pass; the engine increments these per query or per split,
  never per row.
- Label support is positional-by-name: a metric declares its label
  names once; every sample supplies them as keyword arguments, and a
  mismatched label set raises.
- Gauges may also be fed by collector callbacks run at render time
  (query states, queue depth).

The families are those the ported modules produce; the streaming-ingest
families come with that module.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Sequence, Tuple


def _escape(v: object) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Base: a named family of (label-tuple -> value) samples."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._values: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} expects labels "
                f"{self.labelnames}, got {tuple(labels)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def samples(self) -> List[Tuple[Tuple[str, ...], float]]:
        with self._lock:
            return sorted(self._values.items())

    def _render_labels(self, key: Tuple[str, ...],
                       extra: Sequence[Tuple[str, str]] = ()) -> str:
        pairs = [f'{n}="{_escape(v)}"'
                 for n, v in list(zip(self.labelnames, key)) + list(extra)]
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        samples = self.samples()
        if not samples and not self.labelnames:
            # Prometheus convention: an unlabeled family is initialized
            # to 0 at registration — scrapers can alert on rate() the
            # moment the process boots, not after the first event
            samples = [((), 0.0)]
        for key, v in samples:
            lines.append(
                f"{self.name}{self._render_labels(key)} {_fmt(v)}")
        return lines


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


# wall-time-oriented default buckets: 1ms .. ~2min
DEFAULT_BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0, 30.0, 120.0)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        self.buckets = tuple(sorted(buckets))
        # per label-key: [bucket counts..., +Inf count, sum]
        self._hist: Dict[Tuple[str, ...], List[float]] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            h = self._hist.get(key)
            if h is None:
                h = [0.0] * (len(self.buckets) + 2)
                self._hist[key] = h
            for i, b in enumerate(self.buckets):
                if value <= b:
                    h[i] += 1
            h[-2] += 1           # +Inf / count
            h[-1] += value       # sum

    def count(self, **labels) -> float:
        with self._lock:
            h = self._hist.get(self._key(labels))
            return h[-2] if h else 0.0

    def snapshot(self, **labels) -> Tuple[Tuple[float, ...], float,
                                          float]:
        """(cumulative bucket counts, total count, sum) — the readback
        half of the histogram for in-process consumers (the bench load
        leg computes percentile deltas between two snapshots rather
        than re-parsing its own exposition text)."""
        with self._lock:
            h = self._hist.get(self._key(labels))
            if h is None:
                return (0.0,) * len(self.buckets), 0.0, 0.0
            return tuple(h[:len(self.buckets)]), h[-2], h[-1]

    @staticmethod
    def quantile_from_deltas(buckets: Sequence[float],
                             deltas: Sequence[float], count: float,
                             q: float) -> float:
        """Estimate the q-quantile from cumulative-bucket-count deltas
        (Prometheus histogram_quantile semantics: linear interpolation
        within the containing bucket, clamped to the largest finite
        bucket bound for the +Inf tail)."""
        if count <= 0:
            return 0.0
        rank = q * count
        prev_bound, prev_cum = 0.0, 0.0
        for bound, cum in zip(buckets, deltas):
            if cum >= rank:
                span = cum - prev_cum
                frac = ((rank - prev_cum) / span) if span > 0 else 1.0
                return prev_bound + (bound - prev_bound) * frac
            prev_bound, prev_cum = bound, cum
        return buckets[-1] if buckets else 0.0

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = sorted(self._hist.items())
        for key, h in items:
            for i, b in enumerate(self.buckets):
                lines.append(
                    f"{self.name}_bucket"
                    f"{self._render_labels(key, [('le', _fmt(b))])}"
                    f" {_fmt(h[i])}")
            lines.append(
                f"{self.name}_bucket"
                f"{self._render_labels(key, [('le', '+Inf')])}"
                f" {_fmt(h[-2])}")
            lines.append(
                f"{self.name}_sum{self._render_labels(key)} "
                f"{_fmt(h[-1])}")
            lines.append(
                f"{self.name}_count{self._render_labels(key)} "
                f"{_fmt(h[-2])}")
        return lines


class MetricsRegistry:
    """Named-metric registry; ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent across modules instrumenting the same
    family). ``render()`` produces the full text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[[], None]] = []

    def _get(self, cls, name: str, help: str,
             labelnames: Sequence[str], **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls:
                    raise ValueError(
                        f"metric {name} already registered as {m.kind}")
                return m
            m = cls(name, help, tuple(labelnames), self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, labelnames,
                         buckets=buckets)

    def register_collector(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` before every render; it refreshes gauges whose
        values are polled, not pushed (queue depth, cache bytes).
        Pair with ``unregister_collector`` when the owning component
        shuts down — the registry is process-global and would pin the
        callback (and keep rendering its stale gauges) forever."""
        with self._lock:
            self._collectors.append(fn)

    def unregister_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    def render(self) -> str:
        with self._lock:
            collectors = list(self._collectors)
            metrics = list(self._metrics.values())
        for fn in collectors:
            try:
                fn()
            except Exception:   # noqa: BLE001 — scrape must not fail
                pass
        lines: List[str] = []
        for m in sorted(metrics, key=lambda m: m.name):
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


# the process-wide registry
METRICS = MetricsRegistry()

# end-to-end query wall time through the runner, and the most recently
# completed query's peak reservation (a scrape-friendly spot value;
# QueryCompletedEvent carries the per-query figure)
QUERY_WALL_SECONDS = METRICS.histogram(
    "trino_tpu_query_wall_seconds",
    "End-to-end query wall time through the runner")
QUERY_PEAK_MEMORY_BYTES = METRICS.gauge(
    "trino_tpu_query_peak_memory_bytes",
    "Peak reserved memory (bytes) of the most recently completed query")

# plan sanity checking (analysis/sanity.py): runs are counted so that
# validation switched off by accident shows (the rate drops to 0 while
# queries keep flowing); failures carry the validator name — the
# responsible optimizer pass is in the error message
PLAN_VALIDATIONS = METRICS.counter(
    "trino_tpu_plan_validations_total",
    "Plan sanity-checker batteries executed")
PLAN_VALIDATION_FAILURES = METRICS.counter(
    "trino_tpu_plan_validation_failures_total",
    "Plans rejected by the sanity checker, by validator", ("validator",))

# overload governance (server/resourcegroups.py, server/memory.py and
# the coordinator's deadline timer): admission queueing, the cluster
# memory pool, deadline enforcement
QUERY_QUEUED_SECONDS = METRICS.histogram(
    "trino_tpu_query_queued_seconds",
    "Time queries spent queued in resource-group admission before "
    "starting")
QUEUE_REJECTIONS = METRICS.counter(
    "trino_tpu_queue_rejections_total",
    "Queries rejected at admission because the group queue was full "
    "(QUERY_QUEUE_FULL)")
MEMORY_POOL_BYTES = METRICS.gauge(
    "trino_tpu_memory_pool_bytes",
    "Cluster memory pool state in bytes", ("kind",))   # total|reserved
MEMORY_POOL_QUERIES = METRICS.gauge(
    "trino_tpu_memory_pool_queries",
    "Queries currently holding a cluster memory pool reservation")
MEMORY_KILLS = METRICS.counter(
    "trino_tpu_memory_kills_total",
    "Queries killed by the low-memory killer (CLUSTER_OUT_OF_MEMORY)")
DEADLINE_CANCELS = METRICS.counter(
    "trino_tpu_deadline_cancels_total",
    "Queries canceled for exceeding query_max_run_time "
    "(EXCEEDED_TIME_LIMIT)")
LIVE_MEMORY_BEATS = METRICS.counter(
    "trino_tpu_worker_live_memory_beats_total",
    "Worker-reported live task reservations folded into the cluster "
    "memory pool DURING execution (status-poll beats)")
CACHE_PRESSURE_EVICTS = METRICS.counter(
    "trino_tpu_cache_pressure_evictions_total",
    "Cache entries evicted by memory-pressure governance, by cache "
    "(scan = scan cache, result = coordinator result cache)", ("cache",))

# query history and learned operator statistics (obs/history.py,
# exec/learnedstats.py)
HISTORY_RECORDS = METRICS.counter(
    "trino_tpu_query_history_records_total",
    "Terminal-query records appended to the coordinator's durable "
    "query-history store, by terminal state", ("state",))
SLOW_QUERY_LOGS = METRICS.counter(
    "trino_tpu_slow_query_log_total",
    "Queries whose wall time crossed the slow_query_log_ms threshold "
    "and were written to the trace-linked slow-query log")
LEARNED_STATS_OBSERVATIONS = METRICS.counter(
    "trino_tpu_learned_stats_observations_total",
    "Per-operator executions folded into the learned-stats registry "
    "(observed = this process's executors, merged = worker "
    "task-status deltas)", ("outcome",))
LEARNED_STATS_SIZE = METRICS.gauge(
    "trino_tpu_learned_stats_entries",
    "(program key, operator, occurrence) entries currently tracked "
    "by the learned-stats registry")


# the worker slice: the exchange between stages (stage/), the stage
# scheduler, coordinator failover, the workers' shared split scheduler
# (exec/taskexec.py) and their load shedding (server/task_worker.py)
EXCHANGE_PARTITIONS = METRICS.counter(
    "trino_tpu_exchange_partitions_total",
    "Partitioned-exchange frames by direction", ("direction",))

EXCHANGE_PARTITION_BYTES = METRICS.counter(
    "trino_tpu_exchange_partition_bytes_total",
    "Serialized partitioned-exchange bytes by direction", ("direction",))

# the stage DAG on the device mesh (stage/ici.py): bytes and edges of the
# stage boundaries lowered to copies between the mesh's shard devices,
# beside the spool/HTTP leg's trino_tpu_exchange_partition_bytes_total
EXCHANGE_ICI_BYTES = METRICS.counter(
    "trino_tpu_exchange_ici_bytes_total",
    "Bytes exchanged at in-slice (device collective) stage boundaries",
    ("kind",))
EXCHANGE_ICI_EDGES = METRICS.counter(
    "trino_tpu_exchange_ici_edges_total",
    "Stage-boundary exchanges lowered to in-slice device collectives",
    ("kind",))

# streamed operators (exec/streamjoin.py run_streamed): registered here,
# not in the streaming module, so that every consumer sees the same
# labeled families whatever it imported first
STREAM_CHUNKS = METRICS.counter(
    "trino_tpu_stream_chunks_total",
    "Chunks processed by morsel-streamed operators", ("op",))
STREAM_H2D_BYTES = METRICS.counter(
    "trino_tpu_stream_bytes_h2d_total",
    "Bytes moved host->device by streamed-operator chunk transfers")
STREAM_OVERLAPPED = METRICS.counter(
    "trino_tpu_stream_transfers_overlapped_total",
    "Chunk transfers issued while the previous chunk's compute was "
    "still in flight (the double-buffer overlap)")

STAGES_SCHEDULED = METRICS.counter(
    "trino_tpu_stages_scheduled_total",
    "Worker stages dispatched by the stage-DAG scheduler")

FAILOVER_PARTITIONS = METRICS.counter(
    "trino_tpu_failover_partitions_total",
    "Stage partitions handled during coordinator-failover resume by "
    "outcome", ("outcome",))

MPP_OVERLAP_RATIO = METRICS.gauge(
    "trino_tpu_mpp_pipeline_overlap_ratio",
    "Pipelined stage overlap of the most recent stage-DAG query")

REPLICATE_CACHE = METRICS.counter(
    "trino_tpu_exchange_replicate_cache_total",
    "Per-worker fetch-once cache lookups on replicate exchange "
    "edges, by outcome", ("result",))

TASK_SCHED_QUANTA = METRICS.counter(
    "trino_tpu_task_scheduler_quanta_total",
    "Split/chunk quanta the shared task scheduler accounted, by "
    "resource group (the fairness observable)", ("group",))

TASK_SCHED_YIELDS = METRICS.counter(
    "trino_tpu_task_scheduler_yields_total",
    "Times a task handed its runner slot to a higher-priority task "
    "at a split/chunk boundary")

TASK_SCHED_RUNNABLE = METRICS.gauge(
    "trino_tpu_task_scheduler_open_tasks",
    "Tasks currently registered with the shared task scheduler "
    "(running + waiting + blocked)")

WORKER_BUSY_REJECTS = METRICS.counter(
    "trino_tpu_worker_busy_rejections_total",
    "Task dispatches this worker declined with the retryable BUSY "
    "signal under sustained load (the stage scheduler's retry/"
    "rotation machinery re-places them)")

TASK_SCHED_QUEUE_DEPTH = METRICS.gauge(
    "trino_tpu_task_scheduler_queue_depth",
    "Tasks waiting for a runner slot in the shared split scheduler "
    "(the backlog the EMA busy-shed smooths)")

TASK_QUANTUM_SECONDS = METRICS.histogram(
    "trino_tpu_task_quantum_seconds",
    "Wall seconds per scheduler quantum (the work between two "
    "split/chunk checkpoints)")

EXCHANGE_WAIT_SECONDS = METRICS.histogram(
    "trino_tpu_exchange_wait_seconds",
    "Wall seconds a consumer task spent blocked on upstream exchange "
    "commits with its runner slot released")

TASK_SCHED_LEVEL_SECONDS = METRICS.counter(
    "trino_tpu_task_scheduled_seconds_total",
    "Scheduled wall seconds accounted by the shared split scheduler, "
    "by multilevel-feedback level at grant time", ("level",))


OTLP_EXPORTS = METRICS.counter(
    "trino_tpu_otlp_exports_total",
    "OTLP trace-export attempts by sink and outcome (obs/otlp.py "
    "file/HTTP sinks)", ("sink", "result"))

# streaming ingestion + continuous queries (streaming/ +
# connectors/stream.py): producers POST /v1/ingest/{topic} on the
# coordinator or any worker, offset commits seal each continuous
# cycle, and the job scheduler re-dispatches incremental plans on a
# cadence. Registered here — the producers span the message log, both
# HTTP server modules and the continuous-query manager — so scrapes
# read one family identity regardless of import order.
INGEST_ROWS = METRICS.counter(
    "trino_tpu_ingest_rows_total",
    "Messages appended to the streaming message log, by topic",
    ("topic",))
INGEST_BYTES = METRICS.counter(
    "trino_tpu_ingest_bytes_total",
    "Message payload bytes appended to the streaming message log, "
    "by topic", ("topic",))
OFFSET_COMMITS = METRICS.counter(
    "trino_tpu_stream_offset_commits_total",
    "Consumer offset epochs committed to the spool-backed offset "
    "store, by outcome (committed = this process sealed the epoch, "
    "superseded = an earlier commit already won)", ("outcome",))
CONTINUOUS_CYCLES = METRICS.counter(
    "trino_tpu_continuous_cycles_total",
    "Continuous-query scheduler cycles, by outcome (advanced = new "
    "offsets committed, idle = no new messages, failed)", ("outcome",))
CONTINUOUS_JOBS = METRICS.gauge(
    "trino_tpu_continuous_queries",
    "Continuous-query jobs currently RUNNING on this coordinator")


def write_exposition(handler) -> None:
    """Serve METRICS as a Prometheus text response on a
    BaseHTTPRequestHandler — the one /metrics implementation shared by
    the coordinator and the task worker."""
    raw = METRICS.render().encode()
    handler.send_response(200)
    handler.send_header("Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
    handler.send_header("Content-Length", str(len(raw)))
    handler.end_headers()
    handler.wfile.write(raw)


def parse_exposition(text: str) -> Dict[str, Dict[Tuple[str, ...], float]]:
    """Parse Prometheus text exposition back into
    {metric_name: {(label=value, ...): value}} — the test-side decoder
    (asserting on re-parsed samples, not on string formatting)."""
    out: Dict[str, Dict[Tuple[str, ...], float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_labels, _, raw = line.rpartition(" ")
        if "{" in name_labels:
            name, _, rest = name_labels.partition("{")
            body = rest.rstrip("}")
            labels = []
            for part in _split_labels(body):
                k, _, v = part.partition("=")
                labels.append(f"{k}={v.strip(chr(34))}")
            key = tuple(labels)
        else:
            name, key = name_labels, ()
        out.setdefault(name, {})[key] = float(raw)
    return out


def _split_labels(body: str) -> List[str]:
    parts, cur, inq = [], "", False
    for ch in body:
        if ch == '"':
            inq = not inq
            cur += ch
        elif ch == "," and not inq:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur:
        parts.append(cur)
    return parts
