"""HyperLogLog sketches of the PyTorch engine (trino_tpu_torch/ops/hll.py,
approx_set / merge / cardinality / empty_approx_set / the casts) against
the JAX engine (trino_tpu/ops/hll.py) on the CPU.

The SQL cases are those of tests/test_hll.py that need no distributed
runner, each run through both engines: rows must be equal exactly (an
estimate is an integer, a sketch its base64 wire string). The ops are
then compared directly on the same 10^5 seeded values of BIGINT, DOUBLE
(NaN, +-0.0, +-inf among them) and VARCHAR dictionary codes, with the
leading-zero edges w = 0, 1, 2^63 and 2^53 +- 1: bucket and rank lanes,
grouped sketches, estimates and wire strings must be equal exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trino_tpu.ops import hll as tpu_hll
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.session import Session as TpuSession
from trino_tpu_torch.ops import hll
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.session import Session


@pytest.fixture(scope="module")
def engines():
    return (TpuRunner(session=TpuSession(catalog="tpch", schema="tiny")),
            LocalQueryRunner(Session(catalog="tpch", schema="tiny"),
                             device="cpu"))


def parity(engines, sql):
    want = engines[0].execute(sql).rows
    got = engines[1].execute(sql).rows
    assert got == want
    return got


SQL = {
    "small_exact":
        "SELECT cardinality(approx_set(x)) "
        "FROM (VALUES 1,2,3,4,5,2,3,NULL) t(x)",
    "grouped":
        "SELECT k, cardinality(approx_set(v)) FROM (VALUES "
        "('a',1),('a',2),('b',3),('b',3),('a',2)) t(k,v) "
        "GROUP BY k ORDER BY k",
    "null_only_group_is_null":
        "SELECT k, approx_set(v) IS NULL FROM (VALUES "
        "('a', 1), ('b', CAST(NULL AS integer))) t(k,v) "
        "GROUP BY k ORDER BY k",
    "accuracy_sf_column":
        "SELECT cardinality(approx_set(l_orderkey)), "
        "count(DISTINCT l_orderkey) FROM lineitem",
    "error_parameter":
        "SELECT cardinality(approx_set(l_orderkey, 0.01)), "
        "cardinality(approx_set(l_partkey, 0.2)) FROM lineitem",
    "merge_matches_global":
        "SELECT cardinality(merge(s)) FROM (SELECT l_returnflag k, "
        "approx_set(l_partkey) s FROM lineitem GROUP BY l_returnflag)",
    "global_of_merge":
        "SELECT cardinality(approx_set(l_partkey)) FROM lineitem",
    "merge_grouped":
        "SELECT g, cardinality(merge(s)) FROM (SELECT k, k = 'c' g, "
        "approx_set(v) s FROM (VALUES ('a',1),('a',2),('b',2),('b',3),"
        "('c',9)) t(k,v) GROUP BY k) GROUP BY g ORDER BY g",
    "empty_approx_set":
        "SELECT cardinality(empty_approx_set())",
    "cast_roundtrip":
        "SELECT cardinality(CAST(CAST(approx_set(x) AS varbinary) "
        "AS hyperloglog)) FROM (VALUES 1,2,3,4) t(x)",
    "try_cast_malformed_sketch_is_null":
        "SELECT TRY_CAST('garbage' AS hyperloglog) IS NULL",
    "approx_distinct_strings":
        "SELECT approx_distinct(l_shipmode) FROM lineitem",
    "sketch_rows_as_wire_strings":
        "SELECT l_returnflag, approx_set(l_suppkey), "
        "CAST(approx_set(l_partkey, 0.05) AS varbinary) FROM lineitem "
        "GROUP BY 1 ORDER BY 1",
    "cast_codes_as_a_row_by_row_dictionary":
        "SELECT checksum(v), count(DISTINCT v) FROM (SELECT k, "
        "CAST(approx_set(x) AS varbinary) v FROM (VALUES ('a', 1), "
        "('b', 2), ('c', 1), ('d', 3), ('e', 2)) t(k, x) GROUP BY k)",
    "general_path_sketches":
        "SELECT l_suppkey % 9, cardinality(approx_set(l_comment)), "
        "cardinality(approx_set(l_extendedprice)) FROM lineitem "
        "GROUP BY 1 ORDER BY 1",
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_sql_parity_with_the_jax_engine(engines, name):
    parity(engines, SQL[name])


def test_small_exact_and_grouped_values(engines):
    assert parity(engines, SQL["small_exact"]) == [[5]]
    assert parity(engines, SQL["grouped"]) == [["a", 2], ["b", 1]]
    assert parity(engines, SQL["merge_grouped"]) == [[False, 3], [True, 1]]
    assert parity(engines, SQL["empty_approx_set"]) == [[0]]
    assert parity(engines, SQL["approx_distinct_strings"]) == [[7]]


def test_accuracy_and_merge_against_global(engines):
    [[approx, exact]] = engines[1].execute(SQL["accuracy_sf_column"]).rows
    assert abs(approx - exact) / exact < 0.10
    [[merged]] = engines[1].execute(SQL["merge_matches_global"]).rows
    [[direct]] = engines[1].execute(SQL["global_of_merge"]).rows
    assert merged == direct


@pytest.mark.parametrize("sql", [
    "SELECT approx_set(l_orderkey, 0.5) FROM lineitem",
    "SELECT CAST('garbage' AS hyperloglog)",
    "SELECT merge(x) FROM (VALUES 1,2) t(x)",
])
def test_errors_in_both(engines, sql):
    with pytest.raises(Exception):
        engines[0].execute(sql)
    with pytest.raises(Exception):
        engines[1].execute(sql)


# ---- the ops, directly ------------------------------------------------------

N = 100_000
CLZ_EDGES = [0, 1, -(1 << 63), (1 << 53) + 1, (1 << 53) - 1, 1 << 53,
             -1, (1 << 62) + 12345]


def _lanes(kind):
    rng = np.random.default_rng(7)
    if kind == "bigint":
        v = rng.integers(-(1 << 62), 1 << 62, N)
        v[:len(CLZ_EDGES)] = CLZ_EDGES
        return v.astype(np.int64)
    if kind == "double":
        v = rng.normal(size=N) * 1e3
        v[:7] = [np.nan, 0.0, -0.0, np.inf, -np.inf, 2.0 ** 53, -1e300]
        return v
    # the dictionary codes of a VARCHAR column
    return rng.integers(0, 3000, N).astype(np.int32)


@pytest.mark.parametrize("kind", ["bigint", "double", "varchar_codes"])
@pytest.mark.parametrize("b", [4, 11, 12, 16])
def test_bucket_rank_lanes_equal(kind, b):
    v = _lanes(kind)
    jb, jr = tpu_hll.bucket_rank_lanes(jnp.asarray(v), b)
    pb, pr = hll.bucket_rank_lanes(torch.from_numpy(v), b)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))


def test_clz_edges_equal_xla():
    w = np.asarray(CLZ_EDGES + [(1 << 63) - 1, 7, 1 << 10], np.int64)
    got = hll.clz64(torch.from_numpy(w)).numpy()
    want = np.asarray(jax.lax.clz(jnp.asarray(w)))
    np.testing.assert_array_equal(got, want)
    assert list(got[:6]) == [64, 63, 0, 10, 11, 10]


@pytest.mark.parametrize("kind", ["bigint", "double", "varchar_codes"])
def test_grouped_sketches_estimates_and_wire_strings_equal(kind):
    v = _lanes(kind)
    rng = np.random.default_rng(11)
    gcap, b = 16, 12
    gid = np.sort(rng.integers(0, 13, N)).astype(np.int32)
    valid = rng.random(N) > 0.1
    valid[gid == 5] = False          # an empty group
    want = tpu_hll.grouped_sparse_hll(jnp.asarray(v), jnp.asarray(valid),
                                      jnp.asarray(gid), gcap, b)
    got = hll.grouped_sparse_hll(torch.from_numpy(v),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(gid).to(torch.int64),
                                 gcap, b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    est_j = np.asarray(tpu_hll.estimate_from_sparse(*want, b))
    est_p = hll.estimate_from_sparse(*got, b).numpy()
    np.testing.assert_array_equal(est_p, est_j)
    assert est_p[5] == 0
    ent = got[2].numpy()
    assert (hll.sketches_to_base64(got[0].numpy(), got[1].numpy(), ent, b)
            == tpu_hll.sketches_to_base64(np.asarray(want[0]),
                                          np.asarray(want[1]), ent, b))


def test_estimates_of_aliased_and_clipped_spans():
    """Rows that share a span (a gathered sketch column) and spans that
    run past the entries lane give the JAX engine's estimates."""
    rng = np.random.default_rng(3)
    b = 11
    v = rng.integers(0, 1 << 40, 20_000)
    gid = np.sort(rng.integers(0, 4, 20_000)).astype(np.int32)
    s, ln, e = hll.grouped_sparse_hll(
        torch.from_numpy(v), torch.ones(20_000, dtype=torch.bool),
        torch.from_numpy(gid).to(torch.int64), 4, b)
    starts = torch.cat([s, s[:2], torch.tensor([int(e.shape[0]) - 3])])
    lens = torch.cat([ln, ln[:2], torch.tensor([50])])
    want = tpu_hll.estimate_from_sparse(jnp.asarray(starts.numpy()),
                                        jnp.asarray(lens.numpy()),
                                        jnp.asarray(e.numpy()), b)
    got = hll.estimate_from_sparse(starts, lens, e, b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_merge_and_wire_helpers_equal():
    rng = np.random.default_rng(5)
    b = 10
    v = rng.integers(0, 1 << 30, 5000)
    gid = np.sort(rng.integers(0, 6, 5000)).astype(np.int32)
    s, ln, e = hll.grouped_sparse_hll(
        torch.from_numpy(v), torch.ones(5000, dtype=torch.bool),
        torch.from_numpy(gid).to(torch.int64), 6, b)
    args = (s.numpy(), ln.numpy(), e.numpy(), np.ones(6, bool),
            np.asarray([0, 1, 0, 1, 2, 2]), 3, b)
    for g, w in zip(hll.merge_sparse_host(*args),
                    tpu_hll.merge_sparse_host(*args)):
        np.testing.assert_array_equal(g, w)
    regs = hll.dense_registers(e.numpy()[:int(ln[0])], b)
    np.testing.assert_array_equal(
        regs, tpu_hll.dense_registers(e.numpy()[:int(ln[0])], b))
    raw = hll.serialize_registers(regs)
    assert raw == tpu_hll.serialize_registers(regs)
    np.testing.assert_array_equal(hll.deserialize_registers(raw), regs)
    np.testing.assert_array_equal(hll.entries_from_dense(regs),
                                  tpu_hll.entries_from_dense(regs))
    assert hll.bucket_bits_for_error(0.01) == \
        tpu_hll.bucket_bits_for_error(0.01)


SPILL_SQL = (
    "SELECT o_orderpriority, sum(cardinality(s)), count(*), "
    "cardinality(merge(s)) FROM (SELECT l_orderkey k, approx_set(l_partkey) s "
    "FROM lineitem GROUP BY 1) t JOIN orders ON k = o_orderkey "
    "GROUP BY 1 ORDER BY 1")


def test_sketch_column_through_the_join_spill(engines, monkeypatch):
    """A sketch column in a join output spilled to host memory chunk by
    chunk (its entries copied with each chunk, the chunks' offsets moved
    as they concatenate) and brought back gives the unspilled rows and
    the JAX engine's."""
    from trino_tpu_torch.config import CONFIG
    from trino_tpu_torch.exec import executor as ex_mod
    whole = engines[1].execute(SPILL_SQL)
    chunks = []
    to_host = ex_mod._to_host

    def spy(b, n):
        out = to_host(b, n)
        chunks.append(out)
        return out
    monkeypatch.setattr(ex_mod, "_to_host", spy)
    monkeypatch.setattr(CONFIG, "max_batch_rows", 4096)
    spilled = engines[1].execute(SPILL_SQL)
    assert spilled.spill_bytes > 0 and len(chunks) > 1
    assert any(c.elements is not None for b in chunks
               for c in b.columns.values())
    assert spilled.rows == whole.rows
    assert whole.rows == engines[0].execute(SPILL_SQL).rows
