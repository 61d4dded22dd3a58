"""Observability: the metrics registry (``obs.metrics``), the per-query
span tree (``obs.trace``) and the query history (``obs.history``).
Counterpart of ``trino_tpu/obs/``; the OTLP exporter is not ported yet.
"""

