"""CASE and the conditionals of the PyTorch engine
(trino_tpu_torch/exec/expr.py) against the JAX engine, on the CPU.

CASE with string branches from different dictionaries and numeric
branches of different dtypes, coalesce, nullif, if, try, greatest, least
and IS DISTINCT FROM, over tpch.tiny tables and VALUES rows with NULLs.
Rows must be equal; doubles within rel 1e-9.
"""

import math

import numpy as np
import pytest

from trino_tpu.columnar import Batch as TpuBatch, Column as TpuColumn, \
    StringDictionary as TpuDict
from trino_tpu.exec.expr import eval_expr as tpu_eval
from trino_tpu.rex import CaseExpr as TpuCase, Call as TpuCall, \
    Const as TpuConst, InputRef as TpuRef
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.types import BOOLEAN as TPU_BOOLEAN, VARCHAR as TPU_VARCHAR
from trino_tpu_torch.columnar import Batch, Column, StringDictionary
from trino_tpu_torch.exec.expr import eval_expr
from trino_tpu_torch.rex import CaseExpr, Call, Const, InputRef
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.types import BOOLEAN, VARCHAR

REL = 1e-9

SQL = {
    "case_string_branches_of_two_dictionaries":
        "SELECT CASE WHEN n_regionkey = 0 THEN n_name "
        "WHEN n_regionkey = 1 THEN r_name ELSE 'other' END "
        "FROM nation JOIN region ON n_regionkey = r_regionkey",
    "case_numeric_branches_of_mixed_dtypes":
        "SELECT CASE WHEN n_nationkey < 5 THEN n_nationkey "
        "WHEN n_nationkey < 10 THEN 2.5e0 ELSE NULL END, "
        "CASE n_regionkey WHEN 1 THEN 'one' WHEN 2 THEN n_name END, "
        "CASE WHEN n_nationkey > 20 THEN CAST(n_regionkey AS INTEGER) "
        "ELSE n_nationkey END FROM nation",
    "case_inside_an_aggregate":
        "SELECT l_returnflag, sum(CASE WHEN l_shipmode = 'MAIL' THEN 1 "
        "ELSE 0 END), sum(CASE WHEN l_discount > 0.05 "
        "THEN l_extendedprice ELSE 0 END) FROM lineitem "
        "GROUP BY l_returnflag ORDER BY 1",
    "case_on_dates_and_null_conditions":
        "SELECT CASE WHEN x THEN DATE '1995-01-01' "
        "WHEN y > 2 THEN DATE '2000-02-29' END "
        "FROM (VALUES (true, 1), (NULL, 3), (false, NULL), (NULL, NULL)) "
        "t(x, y)",
    "coalesce_nullif_if_distinct":
        "SELECT coalesce(x, y, 'none'), coalesce(a, b), nullif(x, 'p'), "
        "nullif(a, 2), if(a > 1, x, y), if(a > 1, a), "
        "x IS DISTINCT FROM y, a IS NOT DISTINCT FROM b "
        "FROM (VALUES ('p', 'q', 1, 2.5), (NULL, 'r', NULL, 3.5), "
        "(NULL, NULL, 3, NULL), ('s', 's', 2, 2.0)) t(x, y, a, b)",
    "greatest_least":
        "SELECT greatest(n_nationkey, n_regionkey * 5), "
        "least(n_nationkey, 3, n_regionkey), greatest(1.5e0, n_nationkey), "
        "least(n_nationkey * 0.5e0, n_regionkey) FROM nation",
    "try_of_a_failing_cast":
        "SELECT x, try(CAST(x AS INTEGER)), try_cast(x AS DOUBLE), "
        "try(CAST(x AS DOUBLE)) FROM (VALUES '12', 'x1', NULL) t(x)",
}


def _same(got, want):
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    assert len(got.rows) == len(want.rows) > 0
    for g, w in zip(got.rows, want.rows):
        for a, b in zip(g, w):
            if isinstance(b, float) and not math.isnan(b):
                assert a == pytest.approx(b, rel=REL)
            else:
                assert a == b


@pytest.mark.parametrize("name", sorted(SQL))
def test_conditional_sql_matches_the_jax_engine(name):
    _same(LocalQueryRunner(device="cpu").execute(SQL[name]),
          TpuRunner().execute(SQL[name]))


def test_case_over_an_absent_literal_code():
    """CASE over a string column holding the code -1 (a literal absent
    from its dictionary), with a string branch from another dictionary:
    -1 clamps to entry 0 in both engines."""
    values = np.asarray(["MAIL", "SHIP", "AIR"], dtype=object)
    other = np.asarray(["x", "MAIL"], dtype=object)
    codes = np.asarray([0, -1, 2, 1, -1, 0, 2, 1], dtype=np.int32)
    ocodes = np.asarray([1, 0, 0, 1, 1, 0, 1, 0], dtype=np.int32)
    flag = np.asarray([1, 1, 0, 0, 1, 0, 1, 1], dtype=bool)
    tpu = TpuBatch({
        "s": TpuColumn(TPU_VARCHAR, codes, None, TpuDict(values)),
        "o": TpuColumn(TPU_VARCHAR, ocodes, None, TpuDict(other)),
        "f": TpuColumn(TPU_BOOLEAN, flag, None)}, 8)
    port = Batch({
        "s": Column(VARCHAR, codes, None, StringDictionary(values)),
        "o": Column(VARCHAR, ocodes, None, StringDictionary(other)),
        "f": Column(BOOLEAN, flag, None)}, 8)
    want = tpu_eval(TpuCase(
        ((TpuRef("f", TPU_BOOLEAN), TpuRef("s", TPU_VARCHAR)),
         (TpuCall("=", (TpuRef("s", TPU_VARCHAR),
                        TpuConst("SHIP", TPU_VARCHAR)), TPU_BOOLEAN),
          TpuConst("ship", TPU_VARCHAR))),
        TpuRef("o", TPU_VARCHAR), TPU_VARCHAR), tpu)
    got = eval_expr(CaseExpr(
        ((InputRef("f", BOOLEAN), InputRef("s", VARCHAR)),
         (Call("=", (InputRef("s", VARCHAR), Const("SHIP", VARCHAR)),
               BOOLEAN), Const("ship", VARCHAR))),
        InputRef("o", VARCHAR), VARCHAR), port)
    g = Batch({"r": got}, 8).to_pylist()
    assert g == TpuBatch({"r": want}, 8).to_pylist()
    assert g[1] == ["MAIL"] and g[4] == ["MAIL"]
