"""Multi-stage execution over the host exchange (the stage DAG).

Counterpart of ``trino_tpu/stage/`` without ``ici.py`` (the device mesh,
ROADMAP item 10). A plan is cut at exchange points into a DAG of stages
(fragmenter.py); each stage runs as N worker tasks whose output is
hash-partitioned on the card across the downstream stage's tasks
(repartition.py) and committed to the spool (fte/spool.py); downstream
tasks pull their partition of every upstream task through the spool or
the producing worker's partition endpoint (exchange.py); the stage
scheduler (scheduler.py) drives the DAG with per-stage task retries and
straggler speculation. The coordinator executes only the root stage.
"""

from .fragmenter import Stage, StageDAG, StageFragmenter  # noqa: F401
from .repartition import partition_batch, partition_frames  # noqa: F401
from .exchange import ExchangePuller, exchange_task_key  # noqa: F401
