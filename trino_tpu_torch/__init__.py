"""trino_tpu_torch — the SQL engine of ``trino_tpu`` ported to PyTorch
and CUDA (NVIDIA H100).

It keeps ``trino_tpu``'s layout and module names, so each module's
counterpart is found at the same path. Host-only modules (types, the SQL
front end, rex, plan nodes, catalog, session, functions, predicate, the
planner and optimizer, the tpch host generators) are copies with their
imports trimmed to what the port reaches. Device modules are rewritten
over ``torch.Tensor``, and the one TPU kernel, ``grouped_sums``, is a
hand-written CUDA kernel (csrc/grouped_sums.cu).

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``.
This package imports neither jax nor trino_tpu.
"""

from .types import (BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, REAL,  # noqa
                    VARCHAR, DecimalType, Type, VarcharType, parse_type)
from .columnar import (Batch, Column, StringDictionary,  # noqa: F401
                       batch_from_numpy, batch_from_pylist)

__version__ = "0.1.0"
