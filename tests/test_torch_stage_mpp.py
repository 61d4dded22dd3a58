"""The port's multi-stage execution against the JAX package's: the
stage-DAG fragmenter, the hash repartition on the device (buckets equal
to the JAX package's), the worker-to-worker partitioned exchange and
per-stage fault tolerance, through port workers on the CPU, each result
held against the JAX engine's rows on the same query, and the stage DAG
on the device mesh (stage/ici.py, 8 CPU shards). Counterparts of
tests/test_stage_mpp.py.

The reference's own description:

Reference parity: SqlQueryScheduler -> SqlStageExecution -> RemoteTask
with PartitionedOutputOperator hash repartition (SURVEY L5/L6) — the
acceptance shape is a distributed hash-join + final-aggregation query
whose join and FINAL aggregation execute ON WORKERS (per-stage rollup
proves it), the coordinator executing only the root-stage stream, and
a worker killed mid-DAG recovering via per-stage retry off the spool.
"""

import threading

import numpy as np
import pytest

from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.session import Session as TpuSession
from trino_tpu.stage.fragmenter import StageFragmenter as TpuFragmenter
from trino_tpu.stage.repartition import \
    partition_buckets as tpu_partition_buckets

from trino_tpu_torch.columnar import batch_from_pylist
from trino_tpu_torch.exec.remote import DistributedHostQueryRunner
from trino_tpu_torch.obs.metrics import METRICS
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.serde import deserialize_batch
from trino_tpu_torch.server.task_worker import TaskWorkerServer
from trino_tpu_torch.session import Session
from trino_tpu_torch.stage.fragmenter import StageFragmenter
from trino_tpu_torch.stage.repartition import (partition_batch,
                                         partition_buckets,
                                         partition_frames)
from trino_tpu_torch.types import BIGINT, DOUBLE, VARCHAR

JOIN_AGG_SQL = ("SELECT n_name, count(*) FROM nation "
                "JOIN region ON n_regionkey = r_regionkey "
                "WHERE r_name = 'ASIA' GROUP BY n_name "
                "ORDER BY n_name")


def _counter(name: str) -> float:
    return sum(v for _, v in METRICS.counter(name).samples())


def _tpu_rows(sql, catalog="tpch", schema="tiny"):
    """The JAX engine's rows: what every distributed port result is held
    against."""
    return TpuRunner(session=TpuSession(catalog=catalog,
                                        schema=schema)).execute(sql).rows


def _mpp_session(**props) -> Session:
    s = Session(catalog="tpch", schema="tiny")
    s.set("multistage_execution", True)
    for k, v in props.items():
        s.set(k, v)
    return s


# --------------------------------------------------------------------------
# repartition kernel: determinism, completeness, disjointness
# --------------------------------------------------------------------------

def test_bucket_determinism_golden():
    """Buckets are a pure function of key VALUES — pinned against
    golden constants so any process-local or algorithmic drift (a
    seed, a different mix) fails loudly: two workers disagreeing on a
    bucket silently drops join matches."""
    b = batch_from_pylist({"k": list(range(8))}, {"k": BIGINT},
                          device="cpu")
    got = [int(x) for x in partition_buckets(b, ["k"], 4)]
    assert got == [int(x) for x in partition_buckets(b, ["k"], 4)]
    # golden: mix64(v) % 4 for v in 0..7 (pinned — see GOLDEN below)
    assert got == _GOLDEN_BUCKETS, got
    from trino_tpu.columnar import batch_from_pylist as tpu_batch
    from trino_tpu.types import BIGINT as TPU_BIGINT
    tb = tpu_batch({"k": list(range(8))}, {"k": TPU_BIGINT})
    assert got == [int(x) for x in tpu_partition_buckets(tb, ["k"], 4)]


# computed once from an independent pure-python splitmix64 (x ^= x>>30;
# x *= BF58476D1CE4E5B9; x ^= x>>27; x *= 94D049BB133111EB; x ^= x>>31;
# mod 4) — a change here is a WIRE-FORMAT change (workers of different
# versions would disagree on buckets mid-query) and must be deliberate
_GOLDEN_BUCKETS = [0, 1, 2, 0, 0, 0, 0, 0]


def test_bucket_ignores_dictionary_code_assignment():
    """The same string VALUES under different dictionary code layouts
    (two workers build dictionaries in different scan orders) must
    bucket identically — codes are process-local, values are not."""
    rows = ["pear", "apple", "plum", "apple", "fig", "pear"]
    a = batch_from_pylist({"s": rows}, {"s": VARCHAR}, device="cpu")
    b = batch_from_pylist({"s": list(reversed(rows))}, {"s": VARCHAR},
                          device="cpu")
    ba = [int(x) for x in partition_buckets(a, ["s"], 5)]
    bb = [int(x) for x in partition_buckets(b, ["s"], 5)]
    assert ba == list(reversed(bb))
    # and same-value rows always share a bucket
    assert ba[0] == ba[5] and ba[1] == ba[3]


def test_null_keys_colocate_on_partition_zero():
    b = batch_from_pylist({"k": [None, 7, None, 123]}, {"k": BIGINT},
                          device="cpu")
    bk = partition_buckets(b, ["k"], 4)
    assert bk[0] == bk[2] == 0      # NULL hashes to 0 (Trino convention)


def test_partitions_complete_and_disjoint():
    """Property test: partitioning a mixed-type batch (ints, strings,
    floats, NULLs) is a permutation — every row lands in exactly one
    partition, and its frame index equals its key bucket."""
    rng = np.random.default_rng(7)
    n = 500
    ks = [int(rng.integers(0, 40)) for _ in range(n)]
    ss = [f"s{int(rng.integers(0, 17))}" for _ in range(n)]
    xs = [float(rng.standard_normal()) if i % 11 else None
          for i in range(n)]
    b = batch_from_pylist({"k": ks, "s": ss, "x": xs},
                          {"k": BIGINT, "s": VARCHAR, "x": DOUBLE},
                          device="cpu")
    nparts = 7
    parts = partition_batch(b, ["k", "s"], nparts)
    assert len(parts) == nparts
    got = [r for p in parts for r in p.to_pylist()]
    assert len(got) == n
    key = lambda r: (r[0], r[1])                         # noqa: E731
    assert sorted(map(repr, got)) == sorted(
        map(repr, b.to_pylist()))                        # multiset-equal
    # same key -> same partition, and bucket == frame index
    bk = partition_buckets(b, ["k", "s"], nparts)
    by_key = {}
    for r, p in zip(b.to_pylist(), bk):
        assert by_key.setdefault(key(r), int(p)) == int(p)
    for i, p in enumerate(parts):
        for r in p.to_pylist():
            assert by_key[key(r)] == i


def test_partition_frames_layout():
    """frame i IS partition i; empty partitions are real zero-row
    frames; gather emits exactly one frame with every row."""
    b = batch_from_pylist({"k": [1, 1, 1]}, {"k": BIGINT}, device="cpu")
    frames = partition_frames(b, ["k"], "hash", 5)
    assert len(frames) == 5
    decoded = [deserialize_batch(f, "cpu") for f in frames]
    counts = [d.num_rows_host() for d in decoded]
    assert sum(counts) == 3 and counts.count(0) == 4    # one hot bucket
    gather = partition_frames(b, (), "gather", 5)
    assert len(gather) == 1
    assert deserialize_batch(gather[0], "cpu").num_rows_host() == 3
    # replicate spools ONE frame (not one per consumer task): the
    # broadcast fan-out lives on the consumer side (every task reads
    # frame 0 — stage/exchange.py), so the bytes are written once
    rep = partition_frames(b, (), "replicate", 5)
    assert len(rep) == 1
    assert deserialize_batch(rep[0], "cpu").num_rows_host() == 3


# --------------------------------------------------------------------------
# fragmenter: the DAG shape
# --------------------------------------------------------------------------

def _optimized(sql, cat="tpch", schema="tiny"):
    from trino_tpu_torch.planner.logical import LogicalPlanner
    from trino_tpu_torch.planner.optimizer import optimize
    from trino_tpu_torch.sql.parser import parse_statement
    r = LocalQueryRunner(session=Session(catalog=cat, schema=schema),
                         device="cpu")
    return r, optimize(LogicalPlanner(r.catalogs, r.session).plan(
        parse_statement(sql)), r.catalogs, r.session)


def test_fragmenter_cuts_join_agg_dag():
    """The acceptance DAG: two leaf scan stages, a join stage with the
    PARTIAL aggregation fused above it, a FINAL aggregation stage —
    the coordinator root carries only gather-side nodes."""
    from trino_tpu_torch.plan.nodes import (AggregationNode, JoinNode,
                                      RemoteSourceNode, TableScanNode)
    from trino_tpu_torch.analysis.sanity import (validate_stage_dag,
                                           walk_plan)
    r, plan = _optimized(JOIN_AGG_SQL)
    dag = StageFragmenter(r.catalogs, r.session).fragment(plan)
    assert dag is not None and len(dag.stages) >= 3
    kinds = [{type(n).__name__ for n in walk_plan(st.plan)}
             for st in dag.stages]
    assert any("JoinNode" in k for k in kinds)           # join on workers
    assert sum("AggregationNode" in k for k in kinds) >= 2  # partial+final
    # leaves scan, intermediates exchange
    leaf = dag.stages[0]
    assert not leaf.inputs and any(
        isinstance(n, TableScanNode) for n in walk_plan(leaf.plan))
    # the root is exchange-fed only: no scan, join, or aggregation
    root_kinds = {type(n).__name__ for n in walk_plan(dag.root_plan)}
    assert "RemoteSourceNode" in root_kinds
    assert not root_kinds & {"TableScanNode", "JoinNode",
                             "AggregationNode"}
    # the boundary battery accepts what the fragmenter produced and
    # returns one wire payload per stage
    payloads = validate_stage_dag(dag)
    assert sorted(payloads) == [st.sid for st in dag.stages]


def test_fragmenter_semi_join_replicates_filtering_source():
    """Semi joins fragment now: the filtering source becomes a
    REPLICATE stage (every task sees the whole relation, so NULL-IN
    semantics hold per task) and the probe scan stays INLINE in the
    consuming stage — no probe-side exchange hop."""
    from trino_tpu_torch.analysis.sanity import walk_plan
    from trino_tpu_torch.plan.nodes import SemiJoinNode, TableScanNode
    r, plan = _optimized(
        "SELECT count(*) FROM orders WHERE o_custkey IN "
        "(SELECT c_custkey FROM customer)")
    dag = StageFragmenter(r.catalogs, r.session).fragment(plan)
    assert dag is not None
    kinds = {st.sid: st.output_node.kind for st in dag.stages}
    assert "replicate" in kinds.values()
    # the semi-join stage carries BOTH the probe scan and the semi join
    # (colocated — the probe never crossed an exchange)
    for st in dag.stages:
        names = {type(n).__name__ for n in walk_plan(st.plan)}
        if "SemiJoinNode" in names:
            assert "TableScanNode" in names
            break
    else:
        raise AssertionError("no stage carries the semi join")


def test_fragmenter_declines_unsupported_shapes():
    """Non-remotable (coordinator-state-backed) scans stay on the flat
    path."""
    r2, plan2 = _optimized(
        "SELECT node_id, count(*) FROM system.runtime.nodes "
        "GROUP BY node_id")
    assert StageFragmenter(r2.catalogs,
                           r2.session).fragment(plan2) is None


def test_stage_boundary_checker_rejects_broken_edges():
    from dataclasses import replace as dc_replace
    from trino_tpu_torch.analysis.sanity import (PlanValidationError,
                                           validate_stage_dag)
    from trino_tpu_torch.plan.nodes import RemoteSourceNode
    from trino_tpu_torch.stage.fragmenter import StageDAG
    r, plan = _optimized(JOIN_AGG_SQL)
    dag = StageFragmenter(r.catalogs, r.session).fragment(plan)
    final_sid = dag.stages[-1].sid
    final_schema = dag.stages[-1].plan.output_schema()

    # partition key the body does not produce
    broken = [dc_replace(st) for st in dag.stages]
    broken[0].plan = dc_replace(broken[0].plan,
                                partition_keys=("nonexistent$",))
    with pytest.raises(PlanValidationError) as e:
        validate_stage_dag(StageDAG(broken, dag.root_plan))
    assert "partition keys" in str(e.value)

    # RemoteSource naming a stage that does not exist
    with pytest.raises(PlanValidationError,
                       match="StageBoundaryChecker"):
        validate_stage_dag(StageDAG(
            list(dag.stages),
            RemoteSourceNode((99,), final_schema, "gather")))

    # consumer schema type drift across the edge
    drifted = {s: (VARCHAR if str(t) != "varchar" else BIGINT)
               for s, t in final_schema.items()}
    with pytest.raises(PlanValidationError,
                       match="StageBoundaryChecker"):
        validate_stage_dag(StageDAG(
            list(dag.stages),
            RemoteSourceNode((final_sid,), drifted, "gather")))


def test_partitioned_output_key_closure_in_plan_battery():
    """The per-plan half of the satellite: ValidateDependenciesChecker
    rejects a PartitionedOutputNode whose keys the body lacks."""
    from trino_tpu_torch.analysis.sanity import (PlanValidationError,
                                           validate_plan)
    from trino_tpu_torch.plan.nodes import PartitionedOutputNode
    r, plan = _optimized("SELECT n_regionkey FROM nation")
    body = plan.source if hasattr(plan, "source") else plan
    good_key = next(iter(body.output_schema()))
    validate_plan(PartitionedOutputNode(body, (good_key,), "hash"))
    with pytest.raises(PlanValidationError,
                       match="ValidateDependenciesChecker"):
        validate_plan(PartitionedOutputNode(body, ("missing$",),
                                            "hash"))


# --------------------------------------------------------------------------
# e2e: distributed == local through REAL worker servers
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workers():
    ws = [TaskWorkerServer(device="cpu").start() for _ in range(2)]
    yield [w.base_uri for w in ws]
    for w in ws:
        w.stop()


def _check(workers, sql, approx=(), **props):
    dist = DistributedHostQueryRunner(
        workers, session=_mpp_session(**props), device="cpu")
    local = TpuRunner(session=TpuSession(catalog="tpch", schema="tiny"))
    got = dist.execute(sql)
    exp = local.execute(sql)
    assert got.columns == exp.columns
    assert len(got.rows) == len(exp.rows)
    for g, e in zip(got.rows, exp.rows):
        for i, (gv, ev) in enumerate(zip(g, e)):
            if i in approx:
                assert gv == pytest.approx(ev, rel=1e-9)
            else:
                assert gv == ev
    return dist


def test_mpp_join_aggregation_matches_local(workers):
    before = _counter("trino_tpu_exchange_partitions_total")
    _check(workers, JOIN_AGG_SQL)
    # the partitioned exchange actually moved frames
    assert _counter("trino_tpu_exchange_partitions_total") > before


def test_mpp_three_table_join_matches_local(workers):
    from trino_tpu_torch.benchmarks.tpch_queries import TPCH_QUERIES
    _check(workers, TPCH_QUERIES[3], approx=(1,))


def test_mpp_distinct_aggregation_repartitions_rows(workers):
    """Holistic kinds (count DISTINCT) cannot split PARTIAL/FINAL —
    the rows themselves repartition by group key."""
    _check(workers,
           "SELECT n_name, count(DISTINCT s_suppkey) FROM supplier "
           "JOIN nation ON s_nationkey = n_nationkey "
           "GROUP BY n_name ORDER BY n_name")


def test_mpp_global_aggregation_finalizes_on_worker(workers):
    _check(workers,
           "SELECT count(*), sum(l_quantity), avg(l_discount) "
           "FROM lineitem", approx=(2,))


def test_mpp_window_partitions_by_keys(workers):
    _check(workers,
           "SELECT c_custkey, o_orderkey, row_number() OVER "
           "(PARTITION BY c_custkey ORDER BY o_orderdate) rn "
           "FROM customer JOIN orders ON c_custkey = o_custkey "
           "WHERE c_custkey < 20 ORDER BY c_custkey, rn")


def test_mpp_decimal_avg_exact(workers):
    """Decimal avg through the exchange stays bit-exact (Int128 sums,
    decimal division in the FINAL stage's reconstruction)."""
    dist = DistributedHostQueryRunner(
        workers, session=Session(catalog="tpcds", schema="tiny",
                                 properties={
                                     "multistage_execution": True}),
        device="cpu")
    sql = ("SELECT ss_store_sk, sum(ss_ext_sales_price), "
           "avg(ss_sales_price) FROM store_sales "
           "GROUP BY ss_store_sk ORDER BY ss_store_sk")
    assert dist.execute(sql).rows == _tpu_rows(sql, "tpcds")


def test_explain_analyze_proves_worker_side_execution(workers):
    """THE acceptance criterion: >= 3 stages, the join and the final
    aggregation tagged with worker stages in the per-stage rollup, the
    coordinator executing only the root-stage stream."""
    dist = DistributedHostQueryRunner(
        workers, session=_mpp_session(), device="cpu")
    res = dist.execute("EXPLAIN ANALYZE " + JOIN_AGG_SQL)
    text = "\n".join(r[0] for r in res.rows)
    stage_heads = [l for l in text.splitlines()
                   if l.startswith("Stage ")]
    assert len(stage_heads) >= 4        # >=3 worker stages + root
    stats = {}
    for line in text.splitlines():
        if "stage " not in line or ":" not in line:
            continue
        name = line.split(":")[0].strip()
        where = line[line.index("stage "):]
        stats.setdefault(name, []).append(where)
    # the join and SOME aggregation ran on a worker stage...
    assert any(w.startswith("stage ") and "coordinator" not in w
               for w in stats.get("Join", [])), stats
    assert any(w.startswith("stage ") and "coordinator" not in w
               for w in stats.get("Aggregation", [])), stats
    # ...every aggregation did (none fell to the coordinator)...
    assert all("coordinator" not in w
               for w in stats.get("Aggregation", [])), stats
    # ...and the coordinator ran ONLY root-stage gather-side nodes
    coord = [n for n, ws in stats.items()
             if any("coordinator" in w for w in ws)]
    assert set(coord) <= {"RemoteSource", "Sort", "Output",
                          "Project", "Limit"}, coord


def test_exchange_partition_count_caps_intermediate_fanout(workers):
    """Session-property plumbing, end to end: the intermediate stages
    run exactly exchange_partition_count tasks while leaves keep the
    per-worker fan-out. PARTITIONED distribution pinned — under the
    default AUTOMATIC the tiny build side makes the join REPLICATED,
    which colocates it with the probe scan (leaf fan-out by design)."""
    dist = DistributedHostQueryRunner(
        workers, session=_mpp_session(
            exchange_partition_count=1,
            join_distribution_type="PARTITIONED"), device="cpu")
    res = dist.execute("EXPLAIN ANALYZE " + JOIN_AGG_SQL)
    text = "\n".join(r[0] for r in res.rows)
    joins = [l for l in text.splitlines() if l.startswith("Join:")]
    assert joins and all("x1 tasks" in l for l in joins), joins
    scans = [l for l in text.splitlines()
             if l.startswith("TableScan:")]
    assert scans and all("x2 tasks" in l for l in scans), scans


# --------------------------------------------------------------------------
# per-stage fault tolerance: mid-DAG kill + straggler speculation
# --------------------------------------------------------------------------

def _kill_server(worker) -> None:
    """shutdown + close: connections REFUSE immediately (a dead
    process), instead of a zombie listening socket absorbing
    30s-timeout polls — the half-open-socket shape is covered by the
    eager-pull candidate sweep's short probe timeout."""
    def stop():
        worker._httpd.shutdown()
        worker._httpd.server_close()
    threading.Thread(target=stop, daemon=True).start()


class _SabotagedWorker(TaskWorkerServer):
    """Executes leaf-stage tasks normally (committing their output to
    the spool), then DIES the first time it receives a mid-DAG
    (exchange-fed) task — the acceptance kill: the upstream partitions
    it already committed must survive it."""

    def create_task(self, tid, payload):
        stage = payload.get("stage") or {}
        if stage.get("sources") and not getattr(self, "_killed",
                                                False):
            self._killed = True
            _kill_server(self)
            raise ConnectionResetError("killed mid-DAG")
        return super().create_task(tid, payload)


def test_mid_dag_worker_kill_recovers_off_spool():
    bad = _SabotagedWorker(device="cpu").start()
    good = TaskWorkerServer(device="cpu").start()
    retries_before = _counter("trino_tpu_task_retries_total")
    try:
        runner = DistributedHostQueryRunner(
            [bad.base_uri, good.base_uri],
            session=_mpp_session(retry_policy="TASK",
                                 retry_initial_delay_ms=10,
                                 remote_task_timeout=30),
            collect_node_stats=True, device="cpu")
        res = runner.execute(JOIN_AGG_SQL)
    finally:
        good.stop()
    assert res.rows == _tpu_rows(JOIN_AGG_SQL)
    assert _counter("trino_tpu_task_retries_total") > retries_before
    # the retry is visible in the trace as a stage-tagged span
    names = []

    def walk(spans):
        for sp in spans:
            names.append(sp["name"])
            walk(sp.get("children", []))

    walk(res.trace.to_dicts())
    assert any(n.startswith("stage_") and n.endswith("_retry")
               for n in names), names


class _RecordingWorker(TaskWorkerServer):
    """Records every task id it is asked to execute (attempt
    bookkeeping for the replay-scope assertion below)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.seen = []

    def create_task(self, tid, payload):
        self.seen.append(tid)
        return super().create_task(tid, payload)


class _RecordingSabotagedWorker(_RecordingWorker):
    """Executes leaf tasks normally, records everything, then DIES on
    its first mid-DAG (exchange-fed) task — the mid-pipeline kill."""

    def create_task(self, tid, payload):
        stage = payload.get("stage") or {}
        if stage.get("sources") and not getattr(self, "_killed",
                                                False):
            self._killed = True
            self.seen.append(tid)
            _kill_server(self)
            raise ConnectionResetError("killed mid-pipeline")
        return super().create_task(tid, payload)


def test_mid_pipeline_kill_replays_only_uncommitted():
    """THE pipelining chaos contract: a worker killed while the DAG is
    eagerly pipelined costs only the partitions it had NOT yet
    committed. Every (stage, part) task that ran more than once must
    have lost its FIRST attempt to the killed worker — a task whose
    first attempt committed on a surviving worker is never
    re-executed (consumers re-pull its committed frames off the spool
    instead)."""
    bad = _RecordingSabotagedWorker(device="cpu").start()
    good = [_RecordingWorker(device="cpu").start() for _ in range(2)]
    retries_before = _counter("trino_tpu_task_retries_total")
    try:
        runner = DistributedHostQueryRunner(
            [bad.base_uri] + [g.base_uri for g in good],
            session=_mpp_session(retry_policy="TASK",
                                 retry_initial_delay_ms=10,
                                 remote_task_timeout=60),
            device="cpu")
        res = runner.execute(JOIN_AGG_SQL)
    finally:
        for g in good:
            g.stop()
    assert res.rows == _tpu_rows(JOIN_AGG_SQL)
    assert _counter("trino_tpu_task_retries_total") > retries_before
    # attempt ledger: tid == <qid>.s<sid>.<part>.a<attempt>
    execs = {}
    for who, w in [("bad", bad)] + [("good", g) for g in good]:
        for tid in w.seen:
            _, s, p, a = tid.rsplit(".", 3)
            execs.setdefault((s, p), []).append((int(a[1:]), who))
    replayed = {k: sorted(v) for k, v in execs.items() if len(v) > 1}
    assert replayed, "the kill must have forced at least one replay"
    for key, attempts in replayed.items():
        assert attempts[0][1] == "bad", (
            f"task {key} was re-executed although its first attempt "
            f"ran on a surviving worker: {attempts} — a committed "
            "partition was replayed")


class _StuckWorker:
    """Accepts every task and reports RUNNING forever — the straggler
    shape (a wedged, not dead, worker)."""

    def __init__(self):
        import json
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, payload):
                body = json.dumps(payload).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                self.rfile.read(n)
                self._json({"taskId": "x", "state": "RUNNING"})

            def do_GET(self):
                self._json({"state": "RUNNING"})

            def do_DELETE(self):
                self.send_response(204)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.base_uri = \
            f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_stage_speculation_rescues_straggler(workers):
    """First-completion-wins per stage: tasks stuck on the wedged
    worker are speculatively duplicated once siblings establish the
    stage's runtime median; the spool's first-commit-wins arbitrates."""
    stuck = _StuckWorker()
    wins_before = _counter("trino_tpu_speculative_wins_total")
    try:
        # stuck worker LAST: single-task stages home on worker 0
        runner = DistributedHostQueryRunner(
            workers + [stuck.base_uri],
            session=_mpp_session(speculation_enabled=True,
                                 speculation_multiplier=1.5,
                                 speculation_min_runtime_ms=100,
                                 remote_task_timeout=60),
            device="cpu")
        res = runner.execute(JOIN_AGG_SQL)
    finally:
        stuck.stop()
    assert res.rows == _tpu_rows(JOIN_AGG_SQL)
    assert _counter("trino_tpu_speculative_wins_total") > wins_before


def test_mpp_semi_join_matches_local(workers):
    """NULL-IN semantics through the replicate exchange: the filtering
    side (with NULL-capable keys) replicates whole, so the per-task
    verdicts equal the local engine's."""
    _check(workers,
           "SELECT count(*) FROM orders WHERE o_custkey IN "
           "(SELECT c_custkey FROM customer WHERE c_acctbal > 0)")
    _check(workers,
           "SELECT count(*) FROM customer WHERE c_custkey NOT IN "
           "(SELECT o_custkey FROM orders WHERE o_totalprice > 100000)")


def test_mpp_cross_join_matches_local(workers):
    _check(workers,
           "SELECT count(*) FROM nation CROSS JOIN region")
    # non-equi join filter (no equi-criteria): replicate-right shape
    _check(workers,
           "SELECT n1.n_name, n2.n_name FROM nation n1 "
           "JOIN nation n2 ON n1.n_nationkey < n2.n_nationkey "
           "WHERE n1.n_regionkey = 0 ORDER BY 1, 2")


def test_mpp_grouping_sets_matches_local(workers):
    """Grouping sets repartition rows on (keys..., grouping-set id):
    GroupIdNode expands split-locally in the producer stage, subtotal
    copies' NULLed key lanes hash identically everywhere."""
    _check(workers,
           "SELECT n_regionkey, n_name, count(*) FROM nation "
           "GROUP BY ROLLUP(n_regionkey, n_name) ORDER BY 1, 2")
    _check(workers,
           "SELECT o_orderstatus, o_orderpriority, count(*), "
           "sum(o_totalprice) FROM orders GROUP BY GROUPING SETS "
           "((o_orderstatus), (o_orderpriority), ()) ORDER BY 1, 2",
           approx=(3,))


def test_mpp_grouping_sets_fragment_shape():
    """The DAG proof behind the e2e: a ROLLUP aggregation fragments
    with the GroupIdNode INSIDE the producer stage and the hash
    exchange keyed on the full key tuple incl. the set id."""
    from trino_tpu_torch.analysis.sanity import walk_plan
    from trino_tpu_torch.plan.nodes import AggregationNode, GroupIdNode
    r, plan = _optimized(
        "SELECT n_regionkey, n_name, count(*) FROM nation "
        "GROUP BY ROLLUP(n_regionkey, n_name)")
    dag = StageFragmenter(r.catalogs, r.session).fragment(plan)
    assert dag is not None
    producer = next(st for st in dag.stages
                    if any(isinstance(n, GroupIdNode)
                           for n in walk_plan(st.plan)))
    agg = next(n for st in dag.stages
               for n in walk_plan(st.plan)
               if isinstance(n, AggregationNode))
    assert agg.group_id_symbol is not None
    assert agg.group_id_symbol in producer.output_node.partition_keys


# --------------------------------------------------------------------------
# eager pipelining: consumer pulls while producers run
# --------------------------------------------------------------------------

def test_pipelining_matches_barrier_and_overlaps(workers):
    """The tentpole A/B: identical results with stage_pipelining on
    and off; the pipelined run shows cross-stage overlap (tasks of
    >= 2 stages in flight concurrently), the barrier run none.
    PARTITIONED distribution keeps >= 4 stages in the DAG so there is
    something to overlap."""
    from trino_tpu_torch.benchmarks.tpch_queries import TPCH_QUERIES
    gauge = METRICS.gauge("trino_tpu_mpp_pipeline_overlap_ratio")
    _check(workers, TPCH_QUERIES[3], approx=(1,),
           join_distribution_type="PARTITIONED",
           stage_pipelining=False)
    assert gauge.value() == 0.0
    _check(workers, TPCH_QUERIES[3], approx=(1,),
           join_distribution_type="PARTITIONED",
           stage_pipelining=True)
    assert gauge.value() > 0.0


# --------------------------------------------------------------------------

def test_partition_endpoint_serves_committed_frames():
    """The serve half of the exchange: a committed attempt's frames
    are addressable over HTTP by (exchange key, partition index);
    unknown keys / indices 404."""
    import urllib.error
    import urllib.request
    srv = TaskWorkerServer(device="cpu").start()
    try:
        srv.spool.commit("qx.s0.p0", 0, 0, 0, [b"frame-a", b"frame-b"])
        for i, want in enumerate((b"frame-a", b"frame-b")):
            with urllib.request.urlopen(
                    f"{srv.base_uri}/v1/partition/qx.s0.p0/{i}",
                    timeout=5) as r:
                assert r.read() == want
        for bad in ("/v1/partition/qx.s0.p0/9",
                    "/v1/partition/no-such-key/0"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(srv.base_uri + bad, timeout=5)
            assert e.value.code == 404
    finally:
        srv.stop()


# --------------------------------------------------------------------------
# the port's buckets and DAGs equal the JAX package's
# --------------------------------------------------------------------------

def _mixed_batches(n=400, seed=5):
    from trino_tpu.columnar import batch_from_pylist as tpu_batch
    from trino_tpu.types import parse_type as tpu_type
    from trino_tpu_torch.types import parse_type
    rng = np.random.default_rng(seed)
    data = {
        "i": [int(x) if x % 9 else None
              for x in rng.integers(-1000, 1000, n)],
        "s": [f"Customer#{int(x):09d}" if x % 13 else None
              for x in rng.integers(0, 300, n)],
        "d": [float(x) if i % 7 else None
              for i, x in enumerate(rng.standard_normal(n))],
        "dt": [None if i % 11 == 0 else
               __import__("datetime").date(1992, 1, 1)
               + __import__("datetime").timedelta(days=int(x))
               for i, x in enumerate(rng.integers(0, 2500, n))],
        "b": [bool(x) for x in rng.integers(0, 2, n)],
    }
    types = {"i": "bigint", "s": "varchar", "d": "double", "dt": "date",
             "b": "boolean"}
    return (tpu_batch(data, {k: tpu_type(v) for k, v in types.items()}),
            batch_from_pylist(data, {k: parse_type(v)
                                     for k, v in types.items()},
                              device="cpu"))


@pytest.mark.parametrize("keys", [["i"], ["s"], ["d"], ["dt"], ["b"],
                                  ["i", "s"], ["s", "d", "dt", "b"]])
@pytest.mark.parametrize("nparts", [2, 3, 7])
def test_buckets_equal_the_jax_packages(keys, nparts):
    tb, pb = _mixed_batches()
    want = [int(x) for x in tpu_partition_buckets(tb, keys, nparts)]
    assert [int(x) for x in partition_buckets(pb, keys, nparts)] == want


DAG_SQL = {
    "join_agg": JOIN_AGG_SQL,
    "semi": "SELECT count(*) FROM orders WHERE o_custkey IN "
            "(SELECT c_custkey FROM customer)",
    "rollup": "SELECT n_regionkey, n_name, count(*) FROM nation "
              "GROUP BY ROLLUP(n_regionkey, n_name)",
    "distinct": "SELECT n_name, count(DISTINCT s_suppkey) FROM supplier "
                "JOIN nation ON s_nationkey = n_nationkey GROUP BY n_name",
    "window": "SELECT c_custkey, row_number() OVER (PARTITION BY "
              "c_custkey ORDER BY o_orderdate) FROM customer JOIN orders "
              "ON c_custkey = o_custkey",
}


@pytest.mark.parametrize("name", sorted(DAG_SQL))
def test_fragmenter_dag_equals_the_jax_packages(name):
    from trino_tpu.planner.logical import LogicalPlanner as TpuPlanner
    from trino_tpu.planner.optimizer import optimize as tpu_optimize
    from trino_tpu.sql.parser import parse_statement as tpu_parse
    sql = DAG_SQL[name]
    r, plan = _optimized(sql)
    dag = StageFragmenter(r.catalogs, r.session).fragment(plan)
    tr = TpuRunner(session=TpuSession(catalog="tpch", schema="tiny"))
    tplan = tpu_optimize(TpuPlanner(tr.catalogs, tr.session).plan(
        tpu_parse(sql)), tr.catalogs, tr.session)
    tdag = TpuFragmenter(tr.catalogs, tr.session).fragment(tplan)
    assert dag.lines() == tdag.lines()


# --------------------------------------------------------------------------
# the stage DAG on the device mesh (stage/ici.py)
# --------------------------------------------------------------------------

def test_ici_stage_execution_matches_local():
    """LocalQueryRunner(distributed=True) runs a fragmentable plan as the
    same stage DAG with the hash repartition lowered to copies between
    the mesh's shards: the rows equal the JAX engine's, the ICI byte
    counter moves and the spool counter does not."""
    sql = ("SELECT o_orderpriority, count(*), sum(l_extendedprice) "
           "FROM lineitem JOIN orders ON l_orderkey = o_orderkey "
           "GROUP BY o_orderpriority ORDER BY o_orderpriority")
    want = _tpu_rows(sql)
    ici_b = _counter("trino_tpu_exchange_ici_bytes_total")
    edges = _counter("trino_tpu_exchange_ici_edges_total")
    spool_b = _counter("trino_tpu_exchange_partition_bytes_total")
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny"),
                         device="cpu", distributed=True, n_devices=8,
                         collect_node_stats=True)
    res = r.execute(sql)
    assert len(res.rows) == len(want)
    for d, l in zip(res.rows, want):
        assert d[0] == l[0] and d[1] == l[1]
        assert d[2] == pytest.approx(l[2], rel=1e-9)
    assert _counter("trino_tpu_exchange_ici_bytes_total") > ici_b
    assert _counter("trino_tpu_exchange_ici_edges_total") > edges
    assert _counter(
        "trino_tpu_exchange_partition_bytes_total") == spool_b
    assert "_ici_execute" in "\n".join(res.trace.lines())


def test_ici_exchange_off_keeps_node_path():
    """ici_exchange=false keeps the node-at-a-time mesh executor: same
    answers, no ICI edge counted."""
    sql = ("SELECT n_name, count(*) FROM nation "
           "JOIN customer ON c_nationkey = n_nationkey "
           "GROUP BY n_name ORDER BY 1")
    want = _tpu_rows(sql)
    edges = _counter("trino_tpu_exchange_ici_edges_total")
    s = Session(catalog="tpch", schema="tiny")
    s.set("ici_exchange", False)
    got = LocalQueryRunner(s, device="cpu", distributed=True,
                           n_devices=8).execute(sql).rows
    assert got == want
    assert _counter("trino_tpu_exchange_ici_edges_total") == edges
