"""Benchmark query texts (copied from trino_tpu/benchmarks)."""
