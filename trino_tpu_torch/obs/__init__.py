"""Observability: the metrics registry."""
