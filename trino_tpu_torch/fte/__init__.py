"""Fault tolerance on the coordinator: the spool (``fte.spool``), result
recovery (``fte.recovery``) and fault points (``fte.faultpoints``).

Counterpart of ``trino_tpu/fte/``; task retries, speculation and the
object-store spool come with the worker slice.
"""

from .spool import LocalDirSpool, SpoolManager, default_spool, make_spool

__all__ = ["LocalDirSpool", "SpoolManager", "make_spool", "default_spool"]
