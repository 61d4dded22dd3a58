"""The port's coordinator failover against the JAX package's: a port
coordinator with port workers on the CPU dies at each dispatch fault
site, a second port coordinator resumes the RUNNING query from its
spooled execution manifest, and the rows equal the JAX engine's.
Counterparts of tests/test_failover.py.

The reference's own description:
Mid-flight coordinator failover: RUNNING queries survive the death
of the coordinator that dispatched them.

The contract: at dispatch time the coordinator spools
an EXECUTION manifest (identity, session, serde-proven stage payloads,
fan-out, original submit time) under the reserved fragment -2; a
replacement coordinator that receives the client's next poll for a
query it never heard of rebuilds the stage DAG from the manifest,
re-admits the query through resource groups, reads every partition the
exchange spool already holds a COMMITTED marker for, re-dispatches
only the rest, re-runs the combine and serves pages from the client's
token — bit-equal rows through the SAME nextUri chain.

Coordinator death is injected at the named fault sites
(fte/faultpoints.py) with a ``call`` action that severs the HTTP
server and raises SystemExit — a BaseException q.run cannot catch, so
the query thread freezes exactly like the process it stands in for
(no release, no persist, no error served).

The attempt ledger (the ``a<N>`` dirs under each exchange key's task
dir in the worker spool) is snapshotted AT the moment of death: keys
committed by the dead coordinator's dispatch must gain no new attempt
after failover — partitions resume at partition granularity, they are
not re-executed.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.session import Session as TpuSession

from trino_tpu_torch.client import ClientError, StatementClient
from trino_tpu_torch.config import CONFIG
from trino_tpu_torch.fte import faultpoints
from trino_tpu_torch.fte.recovery import ExecutionManifestStore
from trino_tpu_torch.fte.spool import worker_spool_base
from trino_tpu_torch.obs.metrics import FAILOVER_PARTITIONS, METRICS
from trino_tpu_torch.server.coordinator import Coordinator
from trino_tpu_torch.server.task_worker import TaskWorkerServer
from trino_tpu_torch.session import Session

# 3-stage plan (two partitioned sources feeding a partitioned join/agg
# stage) so a death after the FIRST stage commit leaves real committed
# AND real missing partitions
SQL = ("SELECT n_name, count(*) FROM nation "
       "JOIN region ON n_regionkey = r_regionkey "
       "GROUP BY n_name ORDER BY n_name")

TASK_PROPS = {"retry_policy": "TASK", "retry_initial_delay_ms": "10",
              "remote_task_timeout": "30"}


@pytest.fixture(scope="module")
def workers():
    w1 = TaskWorkerServer(device="cpu").start()
    w2 = TaskWorkerServer(device="cpu").start()
    yield [w1.base_uri, w2.base_uri]
    w1.stop()
    w2.stop()


@pytest.fixture(scope="module")
def expected():
    res = TpuRunner(session=TpuSession(catalog="tpch",
                                       schema="tiny")).execute(SQL)
    return [list(r) for r in res.rows]


@pytest.fixture(autouse=True)
def _clean_faults():
    faultpoints.reset()
    yield
    faultpoints.reset()


def _exchange_ledger(exec_prefix: str):
    """{exchange key: (committed?, frozenset of attempt dirs)} for one
    execution's keys in the shared worker spool — the durable record
    of which attempts ever produced each partition."""
    base = worker_spool_base()
    out = {}
    try:
        names = os.listdir(base)
    except OSError:
        return out
    for name in names:
        if not name.startswith(exec_prefix):
            continue
        tdir = os.path.join(base, name, "f0.p0")
        try:
            entries = os.listdir(tdir)
        except OSError:
            continue
        out[name] = ("COMMITTED" in entries,
                     frozenset(e for e in entries
                               if e.startswith("a")
                               and not e.startswith("a.")))
    return out


class _Failover:
    """One staged coordinator death: co1 dispatches, dies at ``site``;
    co2 binds the SAME port and spool. The kill callback snapshots the
    manifest + attempt ledger at the instant of death."""

    def __init__(self, worker_uris, site, boot_delay_s=0.0,
                 boot_second=True):
        self.uris = list(worker_uris)
        self.site = site
        self.boot_delay_s = boot_delay_s
        self.boot_second = boot_second
        self.co1 = Coordinator(device="cpu", worker_uris=self.uris).start()
        self.co2 = None
        self.died_at = None
        self.manifest = None
        self.ledger_at_death = {}
        self._closed = threading.Event()
        faultpoints.install(site, callback=self._kill)
        if boot_second:
            threading.Thread(target=self._boot_replacement,
                             daemon=True).start()

    def _kill(self, site):
        self.died_at = time.time()
        # observe the durable state the next coordinator will see:
        # the spooled manifest and the committed-attempt ledger
        qids = list(self.co1.tracker._queries)
        if qids:
            self.manifest = ExecutionManifestStore(
                self.co1.spool).load(qids[0])
        if self.manifest is not None:
            self.ledger_at_death = _exchange_ledger(
                str(self.manifest["execId"]) + ".")
        # the "process" dies: HTTP gone, no cleanup may run after —
        # SystemExit is a BaseException q.run cannot catch, so the
        # query thread freezes mid-flight like its process did; the
        # cancel event stops the corpse's scheduler threads from
        # dispatching anything further (in a real death they die too —
        # worker-side tasks already dispatched keep running and
        # committing, exactly like real orphaned tasks)
        for q in self.co1.tracker._queries.values():
            q._cancel.set()
        self.co1.tracker.manifests = None
        self.co1.tracker.results = None
        self.co1._httpd.shutdown()
        self.co1._httpd.server_close()
        self._closed.set()
        raise SystemExit

    def _boot_replacement(self):
        self._closed.wait(60)
        if self.boot_delay_s:
            time.sleep(self.boot_delay_s)
        for _ in range(200):       # the dying server's port may linger
            try:
                self.co2 = Coordinator(device="cpu", port=self.co1.port,
                                       worker_uris=self.uris).start()
                return
            except OSError:
                time.sleep(0.02)

    def stop(self):
        try:
            self.co1.stop()
        except Exception:          # noqa: BLE001 — already half-dead
            pass
        if self.co2 is not None:
            self.co2.stop()


# --------------------------------------------------------------------------
# the chaos matrix: death at each coordinator fault site
# --------------------------------------------------------------------------

@pytest.mark.parametrize("site", ["coordinator.pre_dispatch",
                                  "coordinator.post_stage_commit",
                                  "coordinator.mid_combine"])
def test_failover_matrix_resumes_with_bit_equal_rows(
        workers, expected, site):
    """Kill co1 at each fault site; co2 must finish the query with
    bit-equal rows, replaying ONLY partitions without a COMMITTED
    marker (attempt ledger: committed keys gain no new attempts)."""
    r0 = FAILOVER_PARTITIONS.value(outcome="resumed")
    p0 = FAILOVER_PARTITIONS.value(outcome="replayed")
    fo = _Failover(workers, site)
    try:
        client = StatementClient(fo.co1.base_uri,
                                 session_properties=TASK_PROPS)
        res = client.execute(SQL)
        assert res.state == "FINISHED"
        assert [list(r) for r in res.rows] == expected
        assert fo.died_at is not None, "fault never fired"
        assert fo.manifest is not None, "manifest missing at death"
        # the resumed run was real: co2 touched the failover path
        resumed = FAILOVER_PARTITIONS.value(outcome="resumed") - r0
        replayed = FAILOVER_PARTITIONS.value(outcome="replayed") - p0
        assert resumed + replayed > 0
        committed_at_death = {k for k, (c, _) in
                              fo.ledger_at_death.items() if c}
        if site == "coordinator.pre_dispatch":
            # death BEFORE any dispatch: everything replays
            assert not committed_at_death and resumed == 0
            assert replayed > 0
        elif site == "coordinator.mid_combine":
            # death with every stage committed: nothing replays
            assert committed_at_death and replayed == 0
            assert resumed >= len(committed_at_death)
        else:
            # post_stage_commit: the first stage had committed. How
            # much of the REST was missing at resume time depends on
            # how far the orphaned worker tasks got before dying
            # coordinator's dispatch stopped — "replays only
            # uncommitted" is the ledger invariant below, not a count
            assert committed_at_death
            assert resumed >= len(committed_at_death)
        # attempt ledger: a partition committed by the DEAD
        # coordinator's dispatch was never re-executed — its key kept
        # the marker and gained no new attempt dir
        after = _exchange_ledger(str(fo.manifest["execId"]) + ".")
        for key in committed_at_death:
            assert after[key][0], f"{key} lost its COMMITTED marker"
            assert after[key][1] == fo.ledger_at_death[key][1], \
                f"{key} gained attempts after failover"
    finally:
        fo.stop()


def test_acceptance_post_stage_commit_failover(workers, expected):
    """Acceptance: a 3-stage query killed at
    coordinator.post_stage_commit after the first stage commits; the
    second coordinator on the same spool resumes, stage-1 partitions
    are read off the spool WITHOUT re-dispatching stage 1 (attempt
    ledger + failover metrics prove zero stage-1 re-executions), and
    the client receives complete bit-exact results through the same
    nextUri chain."""
    resumed0 = METRICS.counter(
        "trino_tpu_exec_manifests_resumed_total").value()
    r0 = FAILOVER_PARTITIONS.value(outcome="resumed")
    fo = _Failover(workers, "coordinator.post_stage_commit")
    try:
        client = StatementClient(fo.co1.base_uri,
                                 session_properties=TASK_PROPS)
        res = client.execute(SQL)        # one POST, one nextUri chain
        assert res.state == "FINISHED"
        assert [list(r) for r in res.rows] == expected
        mf = fo.manifest
        assert mf is not None and len(mf["stages"]) >= 3
        # stage 1 (the first stage the scheduler awaited) had
        # committed when the coordinator died...
        first_sid = min(int(s["sid"]) for s in mf["stages"])
        stage1_keys = {k for k in fo.ledger_at_death
                       if f".s{first_sid}.p" in k}
        committed1 = {k for k in stage1_keys
                      if fo.ledger_at_death[k][0]}
        assert committed1, "no stage-1 partition committed at death"
        # ...and NONE of its partitions were re-executed: same marker,
        # same attempt set, and the resume counter covers them
        after = _exchange_ledger(str(mf["execId"]) + ".")
        for key in committed1:
            assert after[key][0]
            assert after[key][1] == fo.ledger_at_death[key][1]
        assert FAILOVER_PARTITIONS.value(outcome="resumed") - r0 \
            >= len(committed1)
        assert METRICS.counter(
            "trino_tpu_exec_manifests_resumed_total").value() \
            == resumed0 + 1
        # the resumed query is served under its ORIGINAL id + slug
        q2 = fo.co2.tracker.get(res.query_id)
        assert q2 is not None and q2.state == "FINISHED"
    finally:
        fo.stop()


# --------------------------------------------------------------------------
# gating + hygiene + accounting
# --------------------------------------------------------------------------

def test_none_policy_queries_are_not_resumable(workers):
    """retry_policy=NONE writes no execution manifest, so after the
    coordinator dies mid-flight the replacement must 404 the poll —
    resumption is gated exactly like task retries are."""
    fo = _Failover(workers, "coordinator.post_stage_commit")
    try:
        client = StatementClient(
            fo.co1.base_uri,
            session_properties={"remote_task_timeout": "30"})
        with pytest.raises(urllib.error.HTTPError) as err:
            client.execute(SQL)
        assert err.value.code == 404
        assert fo.died_at is not None and fo.manifest is None
    finally:
        fo.stop()


def test_manifest_released_on_normal_completion(workers):
    """Spool hygiene: a query that finishes normally must not leave
    its execution manifest behind (the result fragment -1 stays for
    restart recovery, the manifest fragment -2 goes)."""
    co = Coordinator(device="cpu", worker_uris=workers).start()
    try:
        client = StatementClient(co.base_uri,
                                 session_properties=TASK_PROPS)
        res = client.execute(SQL)
        assert res.state == "FINISHED"
        qdir = os.path.join(CONFIG.spool_dir, res.query_id)
        deadline = time.time() + 5
        while os.path.isdir(os.path.join(qdir, "f-2.p0")) \
                and time.time() < deadline:
            time.sleep(0.02)
        assert not os.path.isdir(os.path.join(qdir, "f-2.p0")), \
            "execution manifest outlived its query"
        assert os.path.isdir(os.path.join(qdir, "f-1.p0")), \
            "result fragment must survive the manifest release"
        assert ExecutionManifestStore(co.spool).load(res.query_id) \
            is None
    finally:
        co.stop()


def test_delete_releases_manifest_and_blocks_resume(workers):
    """A slug-bearing DELETE against the replacement coordinator kills
    the orphaned query's resumability: the manifest is released and a
    later poll 404s instead of resuming."""
    fo = _Failover(workers, "coordinator.post_stage_commit")
    try:
        # drive the protocol by hand: we must NOT let a poll reach co2
        # before the DELETE, or it would legitimately resume
        req = urllib.request.Request(
            fo.co1.base_uri + "/v1/statement", data=SQL.encode(),
            headers={"X-Trino-Catalog": "tpch",
                     "X-Trino-Schema": "tiny",
                     "X-Trino-Session": ",".join(
                         f"{k}={v}" for k, v in TASK_PROPS.items())})
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.loads(r.read())
        qid = out["id"]
        slug = out["nextUri"].split("/")[-2]
        assert fo._closed.wait(30), "fault never fired"
        deadline = time.time() + 10
        while fo.co2 is None and time.time() < deadline:
            time.sleep(0.02)
        assert fo.co2 is not None
        # wrong slug: the capability token guards destruction too
        bad = urllib.request.Request(
            f"{fo.co2.base_uri}/v1/statement/executing/"
            f"{qid}/forged",
            method="DELETE")
        with urllib.request.urlopen(bad, timeout=10):
            pass
        assert ExecutionManifestStore(fo.co2.spool).load(qid) \
            is not None
        good = urllib.request.Request(
            f"{fo.co2.base_uri}/v1/statement/executing/"
            f"{qid}/{slug}",
            method="DELETE")
        with urllib.request.urlopen(good, timeout=10):
            pass
        assert ExecutionManifestStore(fo.co2.spool).load(qid) is None
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(
                f"{fo.co2.base_uri}/v1/statement/executing/"
                f"{qid}/{slug}/0", timeout=10)
        assert err.value.code == 404
    finally:
        fo.stop()


def test_resume_honors_original_time_budget(workers):
    """EXCEEDED_TIME_LIMIT must span the restart: the resumed query's
    deadline anchors at the ORIGINAL submit epoch from the manifest,
    so a query whose query_max_run_time budget was spent while its
    coordinator lay dead fails on arrival at the replacement — it
    does not get a fresh budget."""
    limit = 4
    fo = _Failover(workers, "coordinator.pre_dispatch",
                   boot_second=False)
    try:
        props = dict(TASK_PROPS, query_max_run_time=str(limit))
        req = urllib.request.Request(
            fo.co1.base_uri + "/v1/statement", data=SQL.encode(),
            headers={"X-Trino-Catalog": "tpch",
                     "X-Trino-Schema": "tiny",
                     "X-Trino-Session": ",".join(
                         f"{k}={v}" for k, v in props.items())})
        submit_t = time.time()
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.loads(r.read())
        qid, next_uri = out["id"], out["nextUri"]
        assert fo._closed.wait(30), "fault never fired"
        # let the ORIGINAL budget run out while no coordinator lives
        time.sleep(max(0.0, submit_t + limit + 0.5 - time.time()))
        fo.co2 = Coordinator(device="cpu", port=fo.co1.port,
                             worker_uris=workers).start()
        deadline = time.time() + 20
        payload = None
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(next_uri, timeout=10) as r:
                    payload = json.loads(r.read())
            except urllib.error.URLError:
                time.sleep(0.05)
                continue
            if payload["stats"]["state"] in ("FAILED", "FINISHED",
                                             "CANCELED"):
                break
            next_uri = payload.get("nextUri") or next_uri
            time.sleep(0.05)
        assert payload is not None
        assert payload["stats"]["state"] == "FAILED", payload
        assert payload["error"]["errorName"] == "EXCEEDED_TIME_LIMIT"
        # accounting spans coordinators: elapsed includes the dead time
        assert payload["stats"]["elapsedTimeMillis"] >= limit * 1000
        q2 = fo.co2.tracker.get(qid)
        assert q2 is not None and q2.created <= submit_t + 1.0
    finally:
        fo.stop()
