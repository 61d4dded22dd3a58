"""The port's task worker and host data plane against the JAX package's:
page frames through the token-acknowledged exchange of port workers
(``TaskWorkerServer(device="cpu")``, in process and as spawned
processes), held against the JAX engine's rows on the same queries.
Counterparts of tests/test_host_exchange.py.
"""

import pytest

from _torch_server import same_rows
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.server.task_worker import RemoteTaskClient as TpuClient
from trino_tpu.server.task_worker import TaskWorkerServer as TpuWorker
from trino_tpu_torch import serde
from trino_tpu_torch.columnar import batch_from_pylist
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.serde import deserialize_batch, serialize_batch
from trino_tpu_torch.server.task_worker import (RemoteTaskClient,
                                                TaskWorkerServer, paginate,
                                                spawn_worker)
from trino_tpu_torch.types import BIGINT, DOUBLE, VARCHAR


def _sample_batch():
    return batch_from_pylist(
        {"k": [1, 2, None, 4] * 64,
         "s": ["alpha", None, "beta", "gamma"] * 64,
         "v": [1.5, -2.25, 3.75, None] * 64},
        {"k": BIGINT, "s": VARCHAR, "v": DOUBLE}, device="cpu")


@pytest.mark.parametrize("codec", [serde.CODEC_STORE, serde.CODEC_LZ4])
def test_serde_roundtrip(codec):
    b = _sample_batch()
    back = deserialize_batch(serialize_batch(b, codec=codec), "cpu")
    assert back.to_pylist() == b.to_pylist()
    assert back.schema()["s"].name.startswith("varchar")


def test_serde_native_lz4_builds():
    assert serde.codec_library() is not None


def test_serde_detects_corruption():
    frame = bytearray(serialize_batch(_sample_batch()))
    frame[len(frame) // 2] ^= 0x40
    with pytest.raises(Exception, match="checksum|corrupt"):
        deserialize_batch(bytes(frame), "cpu")


def test_paginate_splits_and_preserves_rows():
    b = _sample_batch()
    pages = paginate(b, page_rows=100)
    assert len(pages) == 3            # 256 rows / 100
    rows = []
    for p in pages:
        rows.extend(deserialize_batch(p, "cpu").to_pylist())
    assert rows == b.to_pylist()


@pytest.fixture
def worker():
    srv = TaskWorkerServer(device="cpu").start()
    yield srv
    srv.stop()


def test_task_worker_protocol(worker):
    c = RemoteTaskClient(worker.base_uri)
    sql = ("SELECT n_regionkey, count(*) AS c "
           "FROM tpch.tiny.nation GROUP BY n_regionkey")
    c.submit("t1", sql)
    rows = sorted(r for p in c.pages_raw("t1")
                  for r in deserialize_batch(p, "cpu").to_pylist())
    assert rows == sorted(TpuRunner().execute(sql).rows)
    # pulls are idempotent per token (ack/retry semantics)
    again = c.pages_raw("t1")
    assert sorted(r for p in again
                  for r in deserialize_batch(p, "cpu").to_pylist()) == rows
    c.abort("t1")


def test_task_worker_error_propagates(worker):
    c = RemoteTaskClient(worker.base_uri)
    c.submit("bad", "SELECT nosuch FROM tpch.tiny.nation")
    with pytest.raises(Exception, match="500|cannot be resolved"):
        c.pages_raw("bad")


def test_two_process_partial_final_aggregation():
    """Partial aggregation on two spawned port worker processes, frames
    over HTTP, the final aggregation in this process: equal to the JAX
    engine's direct query."""
    procs = []
    try:
        uris = []
        for _ in range(2):
            p, uri = spawn_worker("cpu")
            procs.append(p)
            uris.append(uri)
        partial_sql = ("SELECT o_orderpriority AS pri, "
                       "count(*) AS c, sum(o_totalprice) AS s "
                       "FROM tpch.tiny.orders WHERE o_orderkey % 2 = {k} "
                       "GROUP BY o_orderpriority")
        for k, uri in enumerate(uris):
            RemoteTaskClient(uri).submit(f"part{k}",
                                         partial_sql.format(k=k))
        batches = []
        for k, uri in enumerate(uris):
            batches += [deserialize_batch(f, "cpu") for f in
                        RemoteTaskClient(uri).pages_raw(f"part{k}")]
        from trino_tpu_torch.exec.executor import device_concat
        from trino_tpu_torch.ops.groupby import AggInput, group_aggregate
        fin = group_aggregate(device_concat(batches), ["pri"],
                              [AggInput("sum", "c", output="c"),
                               AggInput("sum", "s", output="s")])
        got = sorted(fin.to_pylist())
        direct = TpuRunner().execute(
            "SELECT o_orderpriority, count(*), sum(o_totalprice) "
            "FROM tpch.tiny.orders GROUP BY o_orderpriority "
            "ORDER BY 1").rows
        assert same_rows(got, direct)
    finally:
        for p in procs:
            p.terminate()
            p.join(10)


NESTED = {"map": "SELECT map(ARRAY[1, 2], ARRAY['a', 'b']) AS m",
          "row": "SELECT CAST(ROW(1, 'x') AS ROW(a BIGINT, b VARCHAR)) "
                 "AS r"}


@pytest.mark.parametrize("kind", sorted(NESTED))
def test_map_and_row_results_cross_the_port_exchange(worker, kind):
    """The port's frames carry a MAP's values and a ROW's fields (frame
    flags 16 and 32), so these results cross its workers whole. The JAX
    package's frames carry neither, and the same query through its
    worker fails on the pull (ROADMAP C): the port does not copy that."""
    sql = NESTED[kind]
    want = LocalQueryRunner(device="cpu").execute(sql).rows
    assert same_rows(want, TpuRunner().execute(sql).rows)
    c = RemoteTaskClient(worker.base_uri)
    c.submit("n1", sql)
    got = [r for f in c.pages_raw("n1")
           for r in deserialize_batch(f, "cpu").to_pylist()]
    assert same_rows(got, want)
    ref = TpuWorker().start()
    try:
        rc = TpuClient(ref.base_uri)
        rc.submit("n1", sql)
        with pytest.raises((AttributeError, TypeError)):
            [p.to_pylist() for p in rc.pages("n1")]
    finally:
        ref.stop()


def test_the_worker_entry_points_need_a_card_unless_cpu_is_asked(
        monkeypatch):
    import torch
    from trino_tpu_torch.exec.remote import DistributedHostQueryRunner
    from trino_tpu_torch.server.main import main
    frame = serialize_batch(_sample_batch())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TaskWorkerServer(),
                 lambda: DistributedHostQueryRunner(["http://127.0.0.1:1"]),
                 lambda: main(["--role", "worker", "--port", "0"]),
                 lambda: deserialize_batch(frame)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert deserialize_batch(frame, "cpu").to_pylist() == \
        _sample_batch().to_pylist()
