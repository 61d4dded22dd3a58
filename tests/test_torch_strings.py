"""LIKE, the regexp family and the string functions of the PyTorch
engine (trino_tpu_torch/exec/expr.py) against the JAX engine, on the CPU.

SQL over tpch.tiny tables and VALUES rows with NULLs runs through both
runners; rows must be equal, strings exactly. Both engines evaluate a
string function once per dictionary value on the host and gather the
result by the code lane; the code -1 (a literal absent from a dictionary)
clamps to entry 0 in both.
"""

import numpy as np
import pytest

from trino_tpu.columnar import Batch as TpuBatch, Column as TpuColumn, \
    StringDictionary as TpuDict
from trino_tpu.exec.expr import eval_expr as tpu_eval
from trino_tpu.rex import Call as TpuCall, Const as TpuConst, \
    InputRef as TpuRef
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.types import BOOLEAN as TPU_BOOLEAN, VARCHAR as TPU_VARCHAR
from trino_tpu_torch.columnar import Batch, Column, StringDictionary
from trino_tpu_torch.exec.expr import eval_expr, like_to_regex
from trino_tpu_torch.rex import Call, Const, InputRef
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.types import BOOLEAN, VARCHAR

SQL = {
    "like_percent_underscore_escape":
        "SELECT x, x LIKE 'a!%%' ESCAPE '!', x LIKE 'a_b', "
        "x NOT LIKE '%b', x LIKE '%' "
        "FROM (VALUES 'a%b', 'ab', 'axb', NULL, 'a%') t(x)",
    "like_filter_on_a_table":
        "SELECT p_name FROM part WHERE p_name LIKE '%green%'",
    "like_prefix_group_by":
        "SELECT p_type, count(*) FROM part WHERE p_type LIKE 'PROMO%' "
        "GROUP BY p_type ORDER BY 1",
    "like_underscore_no_match":
        "SELECT n_name, n_name LIKE '_RAN%', n_name LIKE 'ZZZ%' FROM nation",
    "case_changes_trim_reverse_length":
        "SELECT x, lower(x), upper(x), trim(x), ltrim(x), rtrim(x), "
        "reverse(x), length(x) FROM (VALUES '  Ab c ', 'xYz', NULL) t(x)",
    "substring_constant_and_per_row":
        "SELECT n_name, substring(n_name, 2, 3), substr(n_name, -3), "
        "substring(n_name FROM 1 FOR 2), "
        "substring(n_name, n_regionkey + 1, 2), "
        "substring(n_name, n_regionkey + 1) FROM nation",
    "concat_one_and_two_columns":
        "SELECT n_name, concat(n_name, '-', 'x'), concat(n_name, r_name), "
        "n_name || '/' || r_name "
        "FROM nation JOIN region ON n_regionkey = r_regionkey",
    "strpos_replace_starts_with":
        "SELECT n_name, strpos(n_name, 'A'), replace(n_name, 'A', 'aa'), "
        "replace(n_name, 'A'), starts_with(n_name, 'I') FROM nation",
    "split_part_and_pads":
        "SELECT n_name, split_part(n_name, 'A', 2), lpad(n_name, 9, '*-'), "
        "rpad(n_name, 4), lpad(n_name, 12) FROM nation",
    "regexp_family":
        "SELECT n_name, regexp_like(n_name, 'A.?N'), "
        "regexp_extract(n_name, '([A-Z])A([A-Z])', 2), "
        "regexp_extract(n_name, 'IA'), "
        "regexp_replace(n_name, '(A)(N)', '$2$1'), "
        "regexp_replace(n_name, '[AEIOU]') FROM nation",
    "string_functions_over_nulls":
        "SELECT upper(x), substring(x, 2), x LIKE '%b%', length(x), "
        "concat(x, y), regexp_like(x, 'b') "
        "FROM (VALUES ('abc', 'z'), (NULL, 'y'), ('b', NULL)) t(x, y)",
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_string_sql_matches_the_jax_engine(name):
    got = LocalQueryRunner(device="cpu").execute(SQL[name])
    want = TpuRunner().execute(SQL[name])
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    assert got.rows == want.rows
    assert got.rows


@pytest.mark.parametrize("pattern,escape", [
    ("%green%", None), ("a_b%", None), ("100!%", "!"), ("x.y*z", None),
    ("!_!%", "!"), ("", None)])
def test_like_to_regex_matches_the_jax_engine(pattern, escape):
    from trino_tpu.exec.expr import like_to_regex as tpu_like_to_regex
    assert like_to_regex(pattern, escape) == tpu_like_to_regex(pattern,
                                                               escape)


def _codes_with_an_absent_literal():
    """The same string column in both engines, with the code -1 (a
    literal absent from the dictionary) and a NULL among its rows."""
    values = np.asarray(["forest green", "red", "green tea"], dtype=object)
    codes = np.asarray([0, 1, -1, 2, -1, 1, 0, 2], dtype=np.int32)
    valid = np.asarray([1, 1, 1, 0, 1, 1, 1, 1], dtype=bool)
    tpu = TpuBatch({"s": TpuColumn(TPU_VARCHAR, codes, valid,
                                   TpuDict(values))}, 8)
    port = Batch({"s": Column(VARCHAR, codes, valid,
                              StringDictionary(values))}, 8)
    return tpu, port


@pytest.mark.parametrize("fn,extra", [
    ("like", ("%green%",)), ("upper", ()), ("length", ()),
    ("regexp_like", ("^r",)), ("substring", (2, 3))])
def test_code_minus_one_clamps_like_the_jax_engine(fn, extra):
    from trino_tpu.types import BIGINT as TPU_BIGINT
    from trino_tpu_torch.types import BIGINT
    tpu, port = _codes_with_an_absent_literal()
    out = {"like": BOOLEAN, "regexp_like": BOOLEAN, "length": BIGINT}
    tout = {"like": TPU_BOOLEAN, "regexp_like": TPU_BOOLEAN,
            "length": TPU_BIGINT}
    targs = [TpuRef("s", TPU_VARCHAR)] + [
        TpuConst(v, TPU_VARCHAR if isinstance(v, str) else TPU_BIGINT)
        for v in extra]
    pargs = [InputRef("s", VARCHAR)] + [
        Const(v, VARCHAR if isinstance(v, str) else BIGINT) for v in extra]
    want = tpu_eval(TpuCall(fn, tuple(targs), tout.get(fn, TPU_VARCHAR)),
                    tpu)
    got = eval_expr(Call(fn, tuple(pargs), out.get(fn, VARCHAR)), port)
    w = TpuBatch({"r": want}, 8).to_pylist()
    g = Batch({"r": got}, 8).to_pylist()
    assert g == w
    # code -1 reads dictionary entry 0 in both engines
    assert g[2] == g[0] and g[4] == g[0]
