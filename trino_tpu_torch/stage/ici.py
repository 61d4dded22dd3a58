"""The stage DAG on the device mesh: stage boundaries as collectives.

Counterpart of ``trino_tpu/stage/ici.py``. When every task of a stage
edge lands on one process's mesh there is no reason to round-trip the
exchange through spool and HTTP frames: a stage's N tasks are the N
shards of the mesh (parallel/mesh.py), and the PartitionedOutputNode at
each stage boundary becomes a collective of parallel/spmd.py:

- ``hash`` -> ``repartition_by_hash`` (the all_to_all copies), sized by
  the real per-destination counts;
- ``gather`` / ``replicate`` -> the sharded value gathered to the home
  device (the consumers' replicated operand; in-process, no serde).

The fragmenter cuts the same StageDAG the HTTP scheduler runs, and this
module executes it with ``DistributedExecutor``'s node kernels between
the boundaries. Exchange volume is counted in
``trino_tpu_exchange_ici_bytes_total`` (here) apart from
``trino_tpu_exchange_partition_bytes_total`` (spool/HTTP frames).

Every stage records a ``stage_<sid>_ici_execute`` span with its rows and
bytes; a straggler detector tracks each stage's wall against the DAG's
running median, and a straggling stage (a lockstep stage has no sibling
attempt to speculate onto) is surfaced as a ``stage_<sid>_ici_straggler``
span with the per-shard row-count skew behind it.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from ..columnar import Batch
from ..config import capacity_for
from ..fte.speculate import StragglerDetector
from ..obs.metrics import EXCHANGE_ICI_BYTES, EXCHANGE_ICI_EDGES
from ..parallel.mesh import ShardedBatch, unshard_batch
from ..parallel.spmd import (exchangeable, repartition_by_hash,
                             repartition_dest_counts)
from .fragmenter import Stage, StageDAG


def _value_nbytes(val) -> int:
    """Lane bytes of a batch or a sharded batch (shapes only, no
    synchronisation)."""
    if isinstance(val, ShardedBatch):
        return val.nbytes()
    total = 0
    for c in val.columns.values():
        for lane in (c.data, c.valid, c.data2):
            if lane is not None:
                total += lane.numel() * lane.element_size()
    return total


class IciStageExecution:
    """Executes a StageDAG on the mesh of a ``DistributedExecutor``:
    stage bodies run through the executor's sharded node kernels, and
    stage boundaries lower to collectives. The executor's
    ``_ici_values`` map is the in-slice exchange: RemoteSourceNode leaves
    resolve to the producer stage's value."""

    def __init__(self, dexec, dag: StageDAG):
        self.dexec = dexec
        self.dag = dag
        self.values: Dict[int, object] = {}
        session = dexec.session
        self.straggler = StragglerDetector(
            multiplier=float(session.get("speculation_multiplier")),
            min_runtime_s=int(
                session.get("speculation_min_runtime_ms")) / 1000.0)

    # -- boundary lowering --------------------------------------------
    def _lower_boundary(self, stage: Stage, val):
        """The stage's PartitionedOutputNode as a collective. Placement
        is best-effort: the sharded kernels downstream re-exchange as
        their operator needs, so an edge the exchange cannot move stays
        put; correctness never depends on the boundary."""
        po = stage.output_node
        kind = po.kind
        if kind == "hash" and isinstance(val, ShardedBatch):
            keys = list(po.partition_keys)
            # nested columns and two-lane keys stay on the consumer-side
            # operator's exchange
            if val.n_shards > 1 and exchangeable(val, keys):
                counts = repartition_dest_counts(val, keys)
                cap = capacity_for(max(int(counts.max()), 1))
                out = repartition_by_hash(val, keys, out_cap=cap)
                EXCHANGE_ICI_EDGES.inc(kind="hash")
                EXCHANGE_ICI_BYTES.inc(_value_nbytes(out), kind="hash")
                return out
            return val
        if kind in ("gather", "replicate") and isinstance(val,
                                                          ShardedBatch):
            out = unshard_batch(val)
            EXCHANGE_ICI_EDGES.inc(kind=kind)
            EXCHANGE_ICI_BYTES.inc(_value_nbytes(out), kind=kind)
            return out
        return val

    def _skew(self, val) -> Optional[str]:
        """Per-shard row-count imbalance of a sharded stage output."""
        if not isinstance(val, ShardedBatch):
            return None
        counts = np.asarray(val.num_rows)
        if counts.size < 2 or counts.max() == 0:
            return None
        med = float(np.median(counts))
        if med > 0 and counts.max() > 2.0 * med:
            return (f"max shard {int(counts.max())} rows vs median "
                    f"{int(med)}")
        return None

    # -- the run -------------------------------------------------------
    def run(self) -> Batch:
        dexec = self.dexec
        trace = getattr(dexec.session, "trace", None)
        prev = dexec._ici_values
        dexec._ici_values = self.values
        try:
            for st in self.dag.stages:
                t0 = time.perf_counter()
                val = dexec.execute(st.plan.source)
                val = self._lower_boundary(st, val)
                self.values[st.sid] = val  # tt-lint: ignore[race-attr-write] a stage run is driven by the query's one thread
                t1 = time.perf_counter()
                wall = t1 - t0
                straggling = self.straggler.is_straggler("ici", wall)
                self.straggler.record("ici", wall)
                if trace is not None:
                    rows = (val.total_rows_host()
                            if isinstance(val, ShardedBatch)
                            else val.num_rows_host())
                    trace.record(f"stage_{st.sid}_ici_execute", t0, t1,
                                 kind=st.output_node.kind, rows=int(rows),
                                 bytes=_value_nbytes(val))
                    if straggling:
                        trace.record(f"stage_{st.sid}_ici_straggler",
                                     t0, t1,
                                     skew=self._skew(val) or "none")
            return dexec._host(dexec.execute(self.dag.root_plan))
        finally:
            dexec._ici_values = prev
