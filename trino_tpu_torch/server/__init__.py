"""The coordinator and its services (counterpart of ``trino_tpu/server/``)."""

from .coordinator import Coordinator  # noqa: F401
