"""Observability: the metrics registry (``obs.metrics``), the per-query
span tree (``obs.trace``), its OTLP export (``obs.otlp``) and the query
history (``obs.history``). Counterpart of ``trino_tpu/obs/``.
"""

