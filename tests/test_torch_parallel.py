"""The port's device mesh against the JAX package's: counterparts of
tests/test_parallel.py (but ``test_graft_entry``, which drives the JAX
package's own entry point) on a mesh of 8 shards on the CPU, and the
shard-level check that each shard's live rows after ``shard_batch``,
``repartition_by_hash`` and ``repartition_by_range`` equal the shard's
of the JAX package's 8-device mesh (tests/conftest.py makes the 8
virtual CPU devices). Integers, strings and dates match exactly,
doubles within rel 1e-9.
"""

import collections

import numpy as np
import pytest

from trino_tpu.columnar import batch_from_pylist as tpu_batch
from trino_tpu.ops.sort import SortKey as TpuSortKey
from trino_tpu.parallel import get_mesh as tpu_get_mesh
from trino_tpu.parallel import repartition_by_hash as tpu_repartition
from trino_tpu.parallel import shard_batch as tpu_shard_batch
from trino_tpu.parallel.spmd import \
    repartition_by_range as tpu_repartition_by_range
from trino_tpu.parallel.spmd import \
    sample_range_splitters as tpu_sample_splitters
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu import types as tpu_types

from trino_tpu_torch.columnar import batch_from_pylist
from trino_tpu_torch.config import capacity_for
from trino_tpu_torch.ops.groupby import AggInput
from trino_tpu_torch.ops.sort import SortKey, sort_batch
from trino_tpu_torch.parallel import (distributed_group_aggregate, get_mesh,
                                      repartition_by_hash, shard_batch,
                                      unshard_batch)
from trino_tpu_torch.parallel.spmd import (broadcast_sharded,
                                           range_dest_counts,
                                           repartition_by_range,
                                           sample_range_splitters,
                                           shard_apply)
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.types import BIGINT, DATE, DOUBLE, VARCHAR

N_SHARDS = 8


@pytest.fixture(scope="module")
def mesh():
    m = get_mesh(N_SHARDS, device="cpu")
    assert m.size == N_SHARDS
    return m


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(42)
    n = 3000
    k = rng.integers(0, 23, n)
    v = rng.normal(size=n)
    b = batch_from_pylist(
        {"k": [int(x) for x in k], "v": [float(x) for x in v]},
        {"k": BIGINT, "v": DOUBLE}, device="cpu")
    return b, k, v


@pytest.fixture(scope="module")
def runners():
    """The JAX engine on one device (what every mesh result is held
    against: the JAX package's own slow tests hold its mesh runner to
    it) and the port's mesh runner on 8 CPU shards."""
    return (TpuRunner(),
            LocalQueryRunner(device="cpu", distributed=True,
                             n_devices=N_SHARDS))


def test_get_mesh_places_shards():
    m = get_mesh(3, device="cpu")
    assert m.size == 3 and all(d.type == "cpu" for d in m.devices)
    assert get_mesh(device="cpu").size == 1


def test_shard_roundtrip(mesh, batch):
    b, k, v = batch
    sb = shard_batch(b, mesh)
    assert sb.total_rows_host() == len(k)
    back = unshard_batch(sb)
    assert back.num_rows_host() == len(k)
    got = sorted(back.to_pylist())
    want = sorted([int(a), float(x)] for a, x in zip(k, v))
    assert [r[0] for r in got] == [r[0] for r in want]


def test_repartition_collocates_keys(mesh, batch):
    b, k, v = batch
    sb = shard_batch(b, mesh)
    rp = repartition_by_hash(sb, ["k"])
    assert rp.total_rows_host() == len(k)
    key_shards = collections.defaultdict(set)
    for d, s in enumerate(rp.shards):
        for x in s.column("k").data[:s.num_rows_host()].tolist():
            key_shards[int(x)].add(d)
    assert all(len(s) == 1 for s in key_shards.values())


def test_distributed_groupby_matches_local(mesh, batch):
    b, k, v = batch
    sb = shard_batch(b, mesh)
    out = distributed_group_aggregate(
        sb, ["k"], [AggInput("sum", "v", output="s"),
                    AggInput("count_star", None, output="c"),
                    AggInput("max", "v", output="mx")])
    res = unshard_batch(out)
    n = res.num_rows_host()
    ref_s = collections.defaultdict(float)
    ref_c = collections.Counter()
    ref_m = collections.defaultdict(lambda: -1e18)
    for a, x in zip(k, v):
        ref_s[int(a)] += x
        ref_c[int(a)] += 1
        ref_m[int(a)] = max(ref_m[int(a)], x)
    assert n == len(ref_s)
    for a, s, c, m in zip(*(res.column(x).data[:n].tolist()
                            for x in ("k", "s", "c", "mx"))):
        assert ref_c[int(a)] == int(c)
        assert abs(ref_s[int(a)] - s) < 1e-9
        assert abs(ref_m[int(a)] - m) < 1e-12


def test_distributed_groupby_strings(mesh):
    vals = ["apple", "pear", "apple", "fig", "pear", "apple"] * 50
    b = batch_from_pylist({"s": vals, "x": list(range(len(vals)))},
                          {"s": VARCHAR, "x": BIGINT}, device="cpu")
    out = distributed_group_aggregate(
        shard_batch(b, mesh), ["s"],
        [AggInput("count_star", None, output="c")])
    res = unshard_batch(out)
    got = {row[res.names.index("s")]: row[res.names.index("c")]
           for row in res.to_pylist()}
    assert got == dict(collections.Counter(vals))


def test_broadcast(mesh, batch):
    b, k, v = batch
    bc = broadcast_sharded(shard_batch(b, mesh))
    assert all(c == len(k) for c in bc.num_rows)
    assert sorted(bc.shards[3].to_pylist()) == sorted(b.to_pylist())


def test_range_repartition_distributed_sort(mesh):
    """Sampled range exchange + per-shard sort == global ORDER BY (the
    building blocks of exec/distributed.py's _dexec_SortNode)."""
    rng = np.random.default_rng(7)
    n = 20000
    a = rng.integers(0, 50, n)
    d = rng.normal(size=n)
    b = batch_from_pylist(
        {"a": [int(x) for x in a], "d": [float(x) for x in d]},
        {"a": BIGINT, "d": DOUBLE}, device="cpu")
    keys = [SortKey("a", True, None), SortKey("d", False, None)]
    want = sort_batch(b, keys).to_pylist()
    sb = shard_batch(b, mesh)
    splitters = sample_range_splitters(sb, keys)
    counts = range_dest_counts(sb, keys, splitters)
    assert int(counts.sum()) == n
    cap = capacity_for(max(int(counts.max()), 1))
    rp = repartition_by_range(sb, keys, splitters, out_cap=cap)
    assert rp.total_rows_host() == n
    out = shard_apply(rp, lambda x: sort_batch(x, keys), cap)
    assert unshard_batch(out).to_pylist() == want


# ---- each shard's rows equal the JAX package's shard --------------------

def _tpu_shards(sb):
    per = sb.per_shard_cap
    counts = np.asarray(sb.num_rows)
    names = sorted(sb.columns)
    lanes = {n: np.asarray(sb.columns[n].data) for n in names}
    return [[tuple(lanes[n][d * per + j] for n in names)
             for j in range(int(counts[d]))] for d in range(len(counts))]


def _port_shards(sb):
    names = sorted(sb.columns)
    out = []
    for s in sb.shards:
        k = s.num_rows_host()
        lanes = {n: s.column(n).data[:k].numpy() for n in names}
        out.append([tuple(lanes[n][j] for n in names) for j in range(k)])
    return out


def _assert_shards_equal(port, tpu):
    assert len(port) == len(tpu) == N_SHARDS
    for d, (ps, ts) in enumerate(zip(port, tpu)):
        assert len(ps) == len(ts), d
        for pr, tr in zip(ps, ts):
            for x, y in zip(pr, tr):
                if isinstance(x, float) or getattr(x, "dtype", None) in (
                        np.float64, np.float32):
                    assert float(x) == pytest.approx(float(y), rel=1e-9)
                else:
                    assert int(x) == int(y), d


@pytest.fixture(scope="module")
def pair():
    """One seeded input in both packages: a bigint key, a double, a
    string with NULLs and a date."""
    rng = np.random.default_rng(11)
    n = 5000
    data = {"k": [int(x) for x in rng.integers(0, 37, n)],
            "v": [float(x) for x in rng.normal(size=n)],
            "s": [[None, "AIR", "MAIL", "SHIP", "TRUCK"][int(x)]
                  for x in rng.integers(0, 5, n)],
            "dt": [int(x) for x in rng.integers(8000, 11000, n)]}
    port = batch_from_pylist(data, {"k": BIGINT, "v": DOUBLE,
                                    "s": VARCHAR, "dt": DATE},
                             device="cpu")
    tpu = tpu_batch(data, {"k": tpu_types.BIGINT, "v": tpu_types.DOUBLE,
                           "s": tpu_types.VARCHAR, "dt": tpu_types.DATE})
    return (shard_batch(port, get_mesh(N_SHARDS, device="cpu")),
            tpu_shard_batch(tpu, tpu_get_mesh(N_SHARDS)))


def test_shard_batch_shards_equal_the_jax_packages(pair):
    port, tpu = pair
    assert port.per_shard_cap == tpu.per_shard_cap
    _assert_shards_equal(_port_shards(port), _tpu_shards(tpu))


@pytest.mark.parametrize("keys", [["k"], ["s"], ["k", "s", "dt"], ["v"]])
def test_repartition_by_hash_shards_equal_the_jax_packages(pair, keys):
    port, tpu = pair
    p, t = repartition_by_hash(port, keys), tpu_repartition(tpu, keys)
    assert p.per_shard_cap == t.per_shard_cap
    _assert_shards_equal(_port_shards(p), _tpu_shards(t))


def test_repartition_by_range_shards_equal_the_jax_packages(pair):
    port, tpu = pair
    spec = [("k", True, None), ("v", False, None)]
    ps = sample_range_splitters(port, [SortKey(*x) for x in spec])
    ts = tpu_sample_splitters(tpu, [TpuSortKey(*x) for x in spec])
    for a, b in zip(ps, ts):
        assert np.array_equal(a, np.asarray(b))
    p = repartition_by_range(port, [SortKey(*x) for x in spec], ps)
    t = tpu_repartition_by_range(tpu, [TpuSortKey(*x) for x in spec], ts)
    _assert_shards_equal(_port_shards(p), _tpu_shards(t))


# ---- SQL over the mesh ---------------------------------------------------

def test_distributed_sort_sql_matches_local(runners):
    """ORDER BY large enough to take the range exchange."""
    q = ("SELECT l_orderkey, l_linenumber, l_extendedprice FROM lineitem "
         "WHERE l_quantity < 30 ORDER BY l_extendedprice DESC, l_orderkey, "
         "l_linenumber")
    tpu, dist = runners
    want = tpu.execute(q).rows
    assert len(want) > 4096  # must exercise the range exchange
    assert dist.execute(q).rows == want


def test_distributed_window_matches_local(runners):
    """Hash repartition on the partition keys + a window per shard."""
    q = ("SELECT o_custkey, o_orderkey, "
         "rank() OVER (PARTITION BY o_custkey ORDER BY o_totalprice DESC) "
         "AS r, sum(o_totalprice) OVER (PARTITION BY o_custkey) AS s "
         "FROM orders ORDER BY o_custkey, r, o_orderkey")
    tpu, dist = runners
    want = tpu.execute(q).rows
    got = dist.execute(q).rows
    assert len(got) == len(want) > 4096
    for d, l in zip(got, want):
        assert d[:3] == l[:3]
        assert d[3] == pytest.approx(l[3], rel=1e-9)


@pytest.mark.parametrize("setop", [
    "INTERSECT", "INTERSECT ALL", "EXCEPT", "EXCEPT ALL"])
def test_distributed_setops_match_local(runners, setop):
    q = (f"SELECT o_custkey FROM orders {setop} "
         "SELECT c_custkey FROM customer WHERE c_custkey % 5 != 0 "
         "ORDER BY 1 LIMIT 50")
    tpu, dist = runners
    want = tpu.execute(q).rows
    assert dist.execute(q).rows == want and len(want) > 0


def test_distributed_setop_strings_match_local(runners):
    """Both sides sharded scans of different dictionary columns: the
    dictionaries aligned, then the per-shard set operation."""
    tpu, dist = runners
    q = ("SELECT l_shipmode FROM lineitem EXCEPT "
         "SELECT o_orderpriority FROM orders ORDER BY 1")
    want = tpu.execute(q).rows
    assert dist.execute(q).rows == want and len(want) == 7
    q2 = ("SELECT l_shipmode FROM lineitem INTERSECT "
          "SELECT l_shipmode FROM lineitem WHERE l_orderkey % 2 = 0 "
          "ORDER BY 1")
    want2 = tpu.execute(q2).rows
    assert dist.execute(q2).rows == want2 and len(want2) == 7
