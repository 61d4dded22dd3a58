"""Shared by tests/test_torch_mpp_corpus*.py: two port workers on the CPU
(each stopped at teardown, each on port 0), the JAX engine's local rows
as the reference, and the comparison of tests/test_mpp_corpus.py (exact
for ordered results, sorted multiset otherwise, floats within rel 1e-6:
per-task partial aggregation reorders float reductions)."""

import datetime
import math
from decimal import Decimal

import pytest

from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.session import Session as TpuSession
from trino_tpu_torch.exec.remote import DistributedHostQueryRunner
from trino_tpu_torch.server.task_worker import TaskWorkerServer
from trino_tpu_torch.session import Session


@pytest.fixture(scope="module")
def workers():
    ws = [TaskWorkerServer(device="cpu").start() for _ in range(2)]
    yield [w.base_uri for w in ws]
    for w in ws:
        w.stop()


def tpu_local(catalog):
    return TpuRunner(session=TpuSession(catalog=catalog, schema="tiny"))


def norm_row(row):
    out = []
    for v in row:
        if isinstance(v, datetime.date):
            out.append(v.isoformat())
        elif isinstance(v, Decimal):
            out.append(float(v))
        else:
            out.append(v)
    return out


def assert_rows_equal(got, want, label, ordered):
    assert len(got) == len(want), \
        f"{label}: {len(got)} rows vs local {len(want)}"
    if not ordered:
        key = lambda r: tuple((x is None, str(type(x)), x)   # noqa: E731
                              for x in r)
        got = sorted(got, key=key)
        want = sorted(want, key=key)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), f"{label} row {i}: arity"
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                if a is None or b is None:
                    assert a is None and b is None, f"{label} row {i}"
                else:
                    assert math.isclose(float(a), float(b),
                                        rel_tol=1e-6, abs_tol=1e-6), \
                        f"{label} row {i}: {a} != {b}"
            else:
                assert a == b, f"{label} row {i}: {a!r} != {b!r}"


def dist_check(workers, local, sql, label, catalog):
    """The default session (the stage DAG on): the port's distributed
    rows against the JAX engine's local rows."""
    dist = DistributedHostQueryRunner(
        workers, session=Session(catalog=catalog, schema="tiny"),
        device="cpu")
    got = [norm_row(r) for r in dist.execute(sql).rows]
    want = [norm_row(r) for r in local.execute(sql).rows]
    assert_rows_equal(got, want, label,
                      ordered="order by" in sql.lower())
