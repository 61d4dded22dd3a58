"""Int128 decimals in the PyTorch engine against the JAX engine.

Each primitive of trino_tpu_torch/ops/int128.py runs on the same seeded
numpy lanes as its counterpart in trino_tpu/ops/int128.py, mirroring the
cases of tests/test_int128.py (values near +-2^127, negative divisors,
HALF_UP ties) and held to Python big integers too; every lane must be
equal. Then SQL through both runners on the CPU: decimal division
(DECIMAL(38, 6)), long-decimal sums, averages, casts, comparisons and
group keys. Integers and decimals exact, doubles within rel 1e-9.
"""

import random

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from test_torch_tpch import _same  # noqa: E402
from trino_tpu.columnar import Batch as TpuBatch  # noqa: E402
from trino_tpu.columnar import Column as TpuColumn  # noqa: E402
from trino_tpu.exec.executor import _avg_post as tpu_avg_post  # noqa: E402
from trino_tpu.ops import int128 as ti  # noqa: E402
from trino_tpu.runner import LocalQueryRunner as TpuRunner  # noqa: E402
from trino_tpu.types import BIGINT as TPU_BIGINT  # noqa: E402
from trino_tpu.types import DecimalType as TpuDecimal  # noqa: E402
from trino_tpu_torch.columnar import Batch, Column  # noqa: E402
from trino_tpu_torch.exec.executor import _avg_post  # noqa: E402
from trino_tpu_torch.ops import int128 as pi  # noqa: E402
from trino_tpu_torch.runner import LocalQueryRunner  # noqa: E402
from trino_tpu_torch.types import BIGINT, DecimalType  # noqa: E402

M128 = 1 << 128
EDGES = [0, 1, -1, 2 ** 63 - 1, -(2 ** 63), 2 ** 64, -(2 ** 64),
         10 ** 38 - 1, -(10 ** 38 - 1), 2 ** 127 - 1, -(2 ** 127),
         2 ** 127 - 2 ** 64, -(2 ** 127) + 1]


def _to_signed128(q: int) -> int:
    q &= M128 - 1
    return q - M128 if q >= (1 << 127) else q


def _rand_vals(rng, n, lim=10 ** 38):
    out = []
    for _ in range(n):
        mag = rng.choice([10 ** 3, 2 ** 62, 2 ** 64, 10 ** 20, 10 ** 37,
                          lim - 1])
        out.append(rng.randint(-mag, mag))
    return out + [v for v in EDGES if abs(v) < max(lim, 2 ** 64)]


def _np_lanes(vals):
    los, his = zip(*(ti.split_const(v) for v in vals))
    return np.array(los, np.int64), np.array(his, np.int64)


def _both(vals):
    """The same lanes for both engines: (jax lo, hi), (torch lo, hi)."""
    lo, hi = _np_lanes(vals)
    return ((jnp.asarray(lo), jnp.asarray(hi)),
            (torch.from_numpy(lo.copy()), torch.from_numpy(hi.copy())))


def _ints(lo, hi):
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    return [ti.combine_host(int(a), int(b)) for a, b in zip(lo, hi)]


def _same_lanes(got, want):
    """Every output lane bit-identical between the engines."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def rng():
    return random.Random(12345)


def test_split_combine_roundtrip(rng):
    vals = _rand_vals(rng, 50)
    assert [pi.split_const(v) for v in vals] == \
        [ti.split_const(v) for v in vals]
    (_, _), (lo, hi) = _both(vals)
    assert [pi.combine_host(int(a), int(b))
            for a, b in zip(lo, hi)] == vals
    assert _ints(pi.sign_extend(lo), pi.sign_extend(lo)) == \
        _ints(ti.sign_extend(jnp.asarray(lo.numpy())),
              ti.sign_extend(jnp.asarray(lo.numpy())))


def test_add_sub_neg(rng):
    a = _rand_vals(rng, 40)
    b = list(reversed(_rand_vals(rng, 40)))[:len(a)]
    (jal, jah), (pal, pah) = _both(a)
    (jbl, jbh), (pbl, pbh) = _both(b)
    for fn in ("add128", "sub128"):
        _same_lanes(getattr(pi, fn)(pal, pah, pbl, pbh),
                    getattr(ti, fn)(jal, jah, jbl, jbh))
    _same_lanes(pi.neg128(pal, pah), ti.neg128(jal, jah))
    _same_lanes(pi.abs128(pal, pah), ti.abs128(jal, jah))
    assert _ints(*pi.add128(pal, pah, pbl, pbh)) == \
        [_to_signed128(x + y) for x, y in zip(a, b)]
    assert _ints(*pi.neg128(pal, pah)) == [_to_signed128(-x) for x in a]


def test_mul(rng):
    a = _rand_vals(rng, 40, lim=10 ** 19)
    b = list(reversed(_rand_vals(rng, 40, lim=10 ** 19)))[:len(a)]
    (jal, jah), (pal, pah) = _both(a)
    (jbl, jbh), (pbl, pbh) = _both(b)
    got = pi.mul128(pal, pah, pbl, pbh)
    _same_lanes(got, ti.mul128(jal, jah, jbl, jbh))
    assert _ints(*got) == [_to_signed128(x * y) for x, y in zip(a, b)]


def test_mul_const(rng):
    a = _rand_vals(rng, 30, lim=10 ** 30)
    (jl, jh), (pl, ph) = _both(a)
    for c in (1, 7, 10 ** 3, 10 ** 18, 10 ** 19):
        got = pi.mul_const(pl, ph, c)
        _same_lanes(got, ti.mul_const(jl, jh, c))
        assert _ints(*got) == [_to_signed128(x * c) for x in a]


def test_cmp(rng):
    a = _rand_vals(rng, 40)
    b = list(reversed(_rand_vals(rng, 40)))[:len(a)]
    (jal, jah), (pal, pah) = _both(a)
    (jbl, jbh), (pbl, pbh) = _both(b)
    for fn in ("lt128", "eq128", "uge128"):
        _same_lanes([getattr(pi, fn)(pal, pah, pbl, pbh)],
                    [getattr(ti, fn)(jal, jah, jbl, jbh)])
    assert pi.lt128(pal, pah, pbl, pbh).tolist() == \
        [x < y for x, y in zip(a, b)]


def test_divmod_trunc(rng):
    a = _rand_vals(rng, 25)
    # negative divisors and divisors past 2^64 included; no zero
    b = [v if v != 0 else -3 for v in reversed(_rand_vals(rng, 25))][:len(a)]
    (jal, jah), (pal, pah) = _both(a)
    (jbl, jbh), (pbl, pbh) = _both(b)
    got = pi.divmod128_trunc(pal, pah, pbl, pbh)
    _same_lanes(got, ti.divmod128_trunc(jal, jah, jbl, jbh))
    for x, y, q, r in zip(a, b, _ints(got[0], got[1]),
                          _ints(got[2], got[3])):
        eq = abs(x) // abs(y)
        assert q == (-eq if (x < 0) != (y < 0) else eq)
        er = abs(x) % abs(y)
        assert r == (-er if x < 0 else er)


def test_div_round_half_up(rng):
    # HALF_UP ties: 5/10, 15/10, -25/10 round away from zero
    a = _rand_vals(rng, 25) + [5, 15, -25, 35, -5]
    (jl, jh), (pl, ph) = _both(a)
    for d in (2, 10, 10 ** 3, 10 ** 18, 10 ** 21):
        got = pi.div128_round_half_up(pl, ph, d)
        _same_lanes(got, ti.div128_round_half_up(jl, jh, d))
        for x, g in zip(a, _ints(*got)):
            exp = (abs(x) + d // 2) // d
            assert g == (-exp if x < 0 else exp)
    # a per-row signed divisor, negative ones included
    b = [(-1) ** i * (i + 1) * 10 for i in range(len(a))]
    (jbl, jbh), (pbl, pbh) = _both(b)
    _same_lanes(pi.div128_round_half_up_pair(pl, ph, pbl, pbh),
                ti.div128_round_half_up_pair(jl, jh, jbl, jbh))


def test_rescale_roundtrip():
    vals = [123456789012345678901234567, -9 * 10 ** 30, 5, -5, 0, 15, -15]
    (jl, jh), (pl, ph) = _both(vals)
    up = pi.rescale(pl, ph, 6)
    _same_lanes(up, ti.rescale(jl, jh, 6))
    assert _ints(*up) == [v * 10 ** 6 for v in vals]
    assert _ints(*pi.rescale(*up, -6)) == vals
    _same_lanes(pi.rescale(pl, ph, -1), ti.rescale(jl, jh, -1))


def test_sum_lanes(rng):
    vals = _rand_vals(rng, 200, lim=10 ** 36)
    (jl, jh), (pl, ph) = _both(vals)
    _same_lanes(pi.sum_lanes(pl, ph), ti.sum_lanes(jl, jh))
    s0, s1, s2 = pi.sum_lanes(pl, ph)
    tot = pi.combine_sums(s0.sum().reshape(1), s1.sum().reshape(1),
                          s2.sum().reshape(1))
    assert _ints(*tot)[0] == _to_signed128(sum(vals))


def test_to_from_double():
    vals = [0, 5, -5, 2 ** 70, -(2 ** 70), 10 ** 30 + 7, -(10 ** 25)]
    (jl, jh), (pl, ph) = _both(vals)
    d = pi.to_double(pl, ph)
    assert np.array_equal(d.numpy(), np.asarray(ti.to_double(jl, jh)))
    assert d.tolist()[:5] == [float(v) for v in vals[:5]]
    _same_lanes(pi.from_double(d), ti.from_double(jnp.asarray(d.numpy())))
    assert _ints(*pi.from_double(d))[:5] == vals[:5]


def test_div_round_half_up_scaled_single_rounding():
    # 0.29 averaged over 2 rows into a scale one below the sum's rounds
    # once: HALF_UP(29 / 20) = 1 (dividing first would give 2)
    (jl, jh), (pl, ph) = _both([29, -29, 30, -30])
    cnt = np.array([2, 2, 2, 2], np.int64)
    got = pi.div128_round_half_up_scaled(pl, ph, torch.from_numpy(cnt), 1)
    _same_lanes(got, ti.div128_round_half_up_scaled(jl, jh,
                                                    jnp.asarray(cnt), 1))
    assert _ints(*got) == [1, -1, 2, -2]


def test_div_round_half_up_scaled_matches_bigint(rng):
    def half_up(v, d):
        q, r = divmod(abs(v), d)
        q += 2 * r >= d
        return -q if v < 0 else q

    vals = _rand_vals(rng, 64, lim=10 ** 30)
    counts = np.array([rng.randint(1, 10 ** 6) for _ in vals], np.int64)
    (jl, jh), (pl, ph) = _both(vals)
    for k in (0, 1, 3):
        got = pi.div128_round_half_up_scaled(pl, ph,
                                             torch.from_numpy(counts), k)
        _same_lanes(got, ti.div128_round_half_up_scaled(
            jl, jh, jnp.asarray(counts), k))
        assert _ints(*got) == [half_up(v, int(c) * 10 ** k)
                               for v, c in zip(vals, counts)]


def test_avg_post_decimal_downscale_single_rounding():
    lo, hi = _np_lanes([29, 30, -29])
    cnt = np.array([2, 2, 2], np.int64)
    want = tpu_avg_post("s", "c", TpuDecimal(18, 1))(TpuBatch({
        "s": TpuColumn(TpuDecimal(38, 2), jnp.asarray(lo), None,
                       data2=jnp.asarray(hi)),
        "c": TpuColumn(TPU_BIGINT, jnp.asarray(cnt), None)}, 3))
    got = _avg_post("s", "c", DecimalType(18, 1))(Batch({
        "s": Column(DecimalType(38, 2), lo, None, data2=hi),
        "c": Column(BIGINT, cnt, None)}, 3))
    assert got.data.tolist() == [int(v) for v in np.asarray(want.data)] \
        == [1, 2, -1]


_VALS = ("(VALUES ('1.25', '-0.3', 1), ('-7.55', '2.0', 1), "
         "('9.99', '0.0', 2), ('-0.35', '0.1', 2), ('123456789.12', "
         "'-0.7', 3), (NULL, '1.5', 3)) t(x, y, g)")
_WIDE = ("(SELECT CAST(x AS DECIMAL(30,4)) a, CAST(y AS DECIMAL(25,2)) b, "
         "CAST(x AS DECIMAL(6,2)) s, g FROM " + _VALS + ")")
SQL = {
    "decimal_division_is_long":
        "SELECT s / CAST(y AS DECIMAL(3,1)), s * 1.00 / g, "
        "CAST(g AS DECIMAL(10,0)) / 3 FROM (SELECT CAST(x AS DECIMAL(6,2)) s,"
        " y, g FROM " + _VALS + ")",
    "long_decimal_arithmetic":
        "SELECT a + b, a - b, a * b, -a, abs(b), a % b, round(a, 1), "
        "round(a / b, 2) FROM " + _WIDE,
    "long_decimal_comparisons":
        "SELECT a < b, a = a, a <> b, a >= b, a > CAST(1 AS DECIMAL(30,4)), "
        "b <= CAST('-0.70' AS DECIMAL(25,2)) FROM " + _WIDE,
    "long_decimal_casts":
        "SELECT CAST(abs(a) AS DOUBLE), CAST(a AS BIGINT), "
        "CAST(a AS VARCHAR), "
        "CAST(a AS DECIMAL(10,1)), CAST(s AS DECIMAL(30,3)), "
        "CAST(g AS DECIMAL(28,2)), CAST(g * 1.5e0 AS DECIMAL(28,2)), "
        "CAST(CAST(a AS VARCHAR) AS DECIMAL(30,4)) FROM " + _WIDE,
    "long_decimal_sum_avg_min_max":
        "SELECT g, sum(a), avg(a), min(b), max(b), count(a), sum(s) "
        "FROM " + _WIDE + " GROUP BY g ORDER BY g",
    "long_decimal_global_aggregates":
        "SELECT sum(a), avg(b), min(a), max(a) FROM " + _WIDE,
    "long_decimal_group_keys":
        "SELECT a / 2, count(*) FROM (SELECT CAST(n_nationkey % 4 AS "
        "DECIMAL(30,2)) a FROM nation) GROUP BY a / 2 ORDER BY 1",
    "long_decimal_case_and_coalesce":
        "SELECT CASE WHEN g = 1 THEN a ELSE -a END, coalesce(a, "
        "CAST(0 AS DECIMAL(30,4))), nullif(b, CAST('2.0' AS "
        "DECIMAL(25,2))) FROM " + _WIDE,
    "decimal_ratio_over_tpch":
        "SELECT l_returnflag, sum(l_quantity) * 1.00 / count(*), "
        "round(sum(l_quantity) * 1.00 / sum(l_tax + 1), 2) FROM lineitem "
        "GROUP BY l_returnflag ORDER BY 1",
    "sum_of_a_decimal_over_18_digits":
        "SELECT sum(CAST(l_quantity AS DECIMAL(30,2))) FROM lineitem",
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_sql_matches_the_jax_engine(name, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_PALLAS", "interpret")
    got = LocalQueryRunner(device="cpu").execute(SQL[name])
    assert got.rows
    _same(got, TpuRunner().execute(SQL[name]))


def test_cast_of_a_negative_long_decimal_to_double_is_exact():
    """A small negative DECIMAL(p>18) cast to DOUBLE keeps its value in
    the port (ops/int128.py ``to_double``). The JAX engine's cast adds
    2^64 to the low lane as a double and subtracts it again, which loses
    the low digits (-7.55 comes back as -7.5776); that fault is logged in
    ROADMAP.md section C, so this case is held to the exact value, not to
    the JAX engine."""
    sql = ("SELECT CAST(CAST(x AS DECIMAL(30,4)) AS DOUBLE) FROM "
           "(VALUES '-7.55', '-0.0001', '-123456789.12') t(x)")
    got = LocalQueryRunner(device="cpu").execute(sql).rows
    assert got == [[-7.55], [-0.0001], [-123456789.12]]
    want = TpuRunner().execute(sql).rows
    assert want[0] != [-7.55]
