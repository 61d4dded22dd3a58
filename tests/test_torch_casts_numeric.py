"""Casts to and from varchar, the numeric functions, short-decimal
arithmetic and the aggregates that lower onto ported kinds, in the
PyTorch engine against the JAX engine, on the CPU.

SQL over tpch.tiny and VALUES rows goes through both runners. The
short-decimal operators are also held against the JAX engine at the
expression level, on the same seeded lanes with negative operands, since
the planner types every SQL decimal division as DECIMAL(38, 6) (an Int128
decimal, held in tests/test_torch_int128.py). Integers,
decimals, strings and dates must be equal, doubles within rel 1e-9.
"""

import math
import zlib

import numpy as np
import pytest

from trino_tpu.columnar import Batch as TpuBatch, Column as TpuColumn
from trino_tpu.exec.expr import eval_expr as tpu_eval
from trino_tpu.rex import Call as TpuCall, InputRef as TpuRef
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.types import parse_type as tpu_type
from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.exec.executor import QueryError
from trino_tpu_torch.exec.expr import eval_expr
from trino_tpu_torch.rex import Call, InputRef
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.types import parse_type as port_type

REL = 1e-9

SQL = {
    "varchar_to_numbers":
        "SELECT CAST(x AS INTEGER), CAST(x AS BIGINT), CAST(x AS DOUBLE), "
        "CAST(x AS DECIMAL(10,2)), CAST(x AS DECIMAL(5,0)) "
        "FROM (VALUES '12', ' -7 ', '0', NULL) t(x)",
    "varchar_to_date_and_boolean":
        "SELECT CAST(x AS DATE), CAST(y AS BOOLEAN) FROM (VALUES "
        "('1995-03-15', 'true'), ('2000-02-29', 'f'), (NULL, 'TRUE')) "
        "t(x, y)",
    "numbers_dates_booleans_to_varchar":
        "SELECT CAST(n_nationkey AS VARCHAR), "
        "CAST(n_nationkey * 1.5e0 AS VARCHAR), "
        "CAST(n_nationkey > 3 AS VARCHAR), "
        "CAST(CAST(n_nationkey - 12 AS DECIMAL(12,3)) AS VARCHAR), "
        "CAST(o_orderdate AS VARCHAR) "
        "FROM nation JOIN orders ON n_nationkey = o_orderkey",
    "double_to_short_decimals_half_up":
        "SELECT CAST(x AS DECIMAL(4,1)), CAST(x AS INTEGER), "
        "CAST(x AS REAL), CAST(CAST(x AS DECIMAL(8,3)) AS DECIMAL(6,1)) "
        "FROM (VALUES 2.25e0, -2.25e0, 2.35e0, -0.05e0, 7.449e0) t(x)",
    "short_decimal_operators_and_functions":
        "SELECT a * b, a % b, a + b, a - b, -a, a < b, a = b, "
        "round(c, 1), abs(c), floor(c), sign(c), CAST(c AS DOUBLE), "
        "CAST(c AS BIGINT) FROM (SELECT CAST(x AS DECIMAL(4,2)) a, "
        "CAST(y AS DECIMAL(3,1)) b, CAST(x AS DECIMAL(9,3)) c FROM (VALUES "
        "('1.25', '-0.3'), ('-7.55', '2.0'), ('-0.05', '-0.7'), "
        "('9.99', '0.0'), ('2.00', '2.0'), ('-0.35', '0.1')) t(x, y))",
    "numeric_functions":
        "SELECT x, abs(x), round(x), round(x, 1), round(x, -1), floor(x), "
        "ceil(x), truncate(x), sign(x), power(x, 2), "
        "mod(CAST(x AS BIGINT), 3), sqrt(abs(x)), cbrt(x), exp(x / 10), "
        "ln(abs(x) + 1), log2(abs(x) + 1), log10(abs(x) + 1) "
        "FROM (VALUES -2.5e0, 2.5e0, 7.45e0, -13.0e0, 0.0e0) t(x)",
    "trigonometric_and_float_predicates":
        "SELECT x, sin(x), cos(x), tan(x), asin(x / 20), acos(x / 20), "
        "atan(x), sinh(x / 4), cosh(x / 4), tanh(x), degrees(x), "
        "radians(x), is_nan(x), is_finite(x), is_infinite(x), "
        "is_nan(x / 0.0e0), is_infinite(1 / (x - x)) "
        "FROM (VALUES -2.5e0, 2.5e0, 7.45e0, -13.0e0, 0.0e0) t(x)",
    "integer_division_and_remainder_of_negatives":
        "SELECT n_nationkey / 4, -n_nationkey / 4, n_nationkey % -4, "
        "(n_nationkey - 12) % 5, (n_nationkey - 12) / 5, "
        "mod(n_nationkey - 12, -5) FROM nation",
    "aggregates_lowered_global":
        "SELECT count(DISTINCT l_suppkey), approx_distinct(l_partkey), "
        "count_if(l_quantity > 25), bool_and(l_quantity > 0), "
        "bool_or(l_quantity > 49), every(l_discount < 0.2), "
        "stddev(l_quantity), stddev_pop(l_quantity), "
        "variance(l_extendedprice), var_pop(l_discount), var_samp(l_tax), "
        "stddev_samp(l_tax), geometric_mean(l_quantity) FROM lineitem",
    "aggregates_lowered_grouped":
        "SELECT l_returnflag, count(DISTINCT l_suppkey), "
        "count(DISTINCT l_shipmode), approx_distinct(l_partkey), "
        "count_if(l_quantity > 25), bool_and(l_quantity > 1), "
        "bool_or(l_quantity > 49), stddev(l_quantity), var_pop(l_discount), "
        "geometric_mean(l_quantity) FROM lineitem "
        "GROUP BY l_returnflag ORDER BY 1",
    "aggregates_lowered_general_path":
        "SELECT l_orderkey % 7, count(DISTINCT l_partkey), "
        "count(DISTINCT l_discount), "
        "variance(CAST(l_quantity AS DECIMAL(10,2))) FROM lineitem "
        "GROUP BY 1 ORDER BY 1",
    "approx_distinct_is_exact":
        "SELECT approx_distinct(l_orderkey) FROM lineitem",
    "count_distinct_over_a_semi_join":
        "SELECT o_orderpriority, count(DISTINCT o_custkey), count(*) "
        "FROM orders WHERE o_orderkey IN (SELECT l_orderkey FROM lineitem "
        "WHERE l_quantity > 49) GROUP BY o_orderpriority ORDER BY 1",
}


def _same(got, want):
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    assert len(got.rows) == len(want.rows) > 0
    for g, w in zip(got.rows, want.rows):
        for a, b in zip(g, w):
            if isinstance(b, float) and not math.isnan(b):
                assert a == pytest.approx(b, rel=REL)
            elif isinstance(b, float):
                assert math.isnan(a)
            else:
                assert a == b


@pytest.mark.parametrize("name", sorted(SQL))
def test_sql_matches_the_jax_engine(name):
    _same(LocalQueryRunner(device="cpu").execute(SQL[name]),
          TpuRunner().execute(SQL[name]))


def test_failing_varchar_cast_raises_in_both_engines():
    sql = "SELECT CAST(x AS INTEGER) FROM (VALUES '12', 'x1') t(x)"
    with pytest.raises(QueryError, match="Cannot cast 'x1'"):
        LocalQueryRunner(device="cpu").execute(sql)
    with pytest.raises(Exception, match="Cannot cast 'x1'"):
        TpuRunner().execute(sql)


# (operator, left type, right type, result type): * / % with rescaling
# up and down, and a / whose shift is negative
DECIMAL_OPS = [
    ("decimal_*", "decimal(6,2)", "decimal(5,3)", "decimal(11,5)"),
    ("decimal_*", "decimal(6,2)", "decimal(5,3)", "decimal(11,2)"),
    ("decimal_/", "decimal(6,2)", "decimal(5,3)", "decimal(12,4)"),
    ("decimal_/", "decimal(9,4)", "decimal(3,0)", "decimal(10,1)"),
    ("decimal_/", "decimal(5,1)", "decimal(5,3)", "decimal(15,6)"),
    ("decimal_%", "decimal(6,2)", "decimal(5,3)", "decimal(6,3)"),
    ("decimal_+", "decimal(6,2)", "decimal(5,3)", "decimal(8,3)"),
    ("decimal_-", "decimal(6,2)", "bigint", "decimal(18,2)"),
]


def _unscaled_lanes(typ: str, rng, n: int) -> np.ndarray:
    if typ == "bigint":
        return rng.integers(-50, 50, n).astype(np.int64)
    p = int(typ.split("(")[1].split(",")[0])
    hi = 10 ** min(p, 6)
    out = rng.integers(-hi, hi, n).astype(np.int64)
    # halves at the rounding boundary, zeros and small negatives
    out[:8] = [5, -5, 15, -15, 0, 1, -1, 25]
    return out


@pytest.mark.parametrize("op,lt,rt,out", DECIMAL_OPS)
def test_short_decimal_operator_matches_the_jax_engine(op, lt, rt, out):
    rng = np.random.default_rng(zlib.crc32(f"{op}{lt}{rt}{out}".encode()))
    n = 64
    a = _unscaled_lanes(lt, rng, n)
    b = _unscaled_lanes(rt, rng, n)
    b[8] = 0
    valid = np.ones(n, dtype=bool)
    valid[9] = False
    tpu = TpuBatch({"a": TpuColumn(tpu_type(lt), a, valid),
                    "b": TpuColumn(tpu_type(rt), b, None)}, n)
    port = Batch({"a": Column(port_type(lt), a, valid),
                  "b": Column(port_type(rt), b, None)}, n)
    want = tpu_eval(TpuCall(op, (TpuRef("a", tpu_type(lt)),
                                 TpuRef("b", tpu_type(rt))),
                            tpu_type(out)), tpu)
    got = eval_expr(Call(op, (InputRef("a", port_type(lt)),
                              InputRef("b", port_type(rt))),
                         port_type(out)), port)
    assert Batch({"r": got}, n).to_pylist() == \
        TpuBatch({"r": want}, n).to_pylist()


def test_decimal_over_18_digits_raises_not_yet_ported():
    """This division is typed DECIMAL(38, 6), an Int128 decimal. It raised
    ``not yet ported`` until ops/int128.py was ported; now it must equal
    the JAX engine, HALF_UP rounding and a zero divisor (NULL) included
    (tests/test_torch_int128.py holds the rest of Int128)."""
    sql = "SELECT CAST(x AS DECIMAL(4,2)) / CAST(y AS DECIMAL(3,1)) " \
          "FROM (VALUES ('1.25', '-0.3'), ('-7.55', '2.0'), " \
          "('9.99', '0.0')) t(x, y)"
    got = LocalQueryRunner(device="cpu").execute(sql)
    assert [str(t) for t in got.types] == ["decimal(38,6)"]
    _same(got, TpuRunner().execute(sql))
