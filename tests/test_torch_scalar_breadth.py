"""The scalar functions of the PyTorch engine against the JAX engine, on
the CPU: bitwise, digests and hashes, hex, HMAC, URL, text, math, the
VARBINARY codecs, JSON parsing, Joda and ISO 8601 entry points.

Every non-container case of tests/test_scalar_breadth.py runs here
through both runners over VALUES rows and tpch.tiny, with more rows and
NULLs. Integers, strings and dates must be equal, doubles within rel
1e-9. Where the JAX engine is at fault (ROADMAP C) the port is held to
Trino's answer instead. A coverage test keeps the port's dispatch table
in step with the reference's: the port leaves out no name of it.
"""

import datetime
import hashlib
import hmac as hm
import math
import struct
import zlib

import numpy as np
import pytest

from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu_torch.exec.executor import QueryError
from trino_tpu_torch.runner import LocalQueryRunner

REL = 1e-9


@pytest.fixture(scope="module")
def jax():
    return TpuRunner()


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner(device="cpu")


def _same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and not math.isnan(b):
                assert a == pytest.approx(b, rel=REL)
            elif isinstance(b, float):
                assert math.isnan(a)
            else:
                assert a == b and type(a) is type(b)


URL = "'https://user@example.com:8080/path/x?a=1&b=two#frag'"
# a table of strings with NULLs, non-ASCII text and an empty string
WORDS = ("(VALUES ('running', 1), ('cats', 2), ('nationalization', 3), "
         "('héllo wörld', 4), ('', 5), (NULL, 6), ('a b&c', 7)) t(s, k)")

SQL = {
    # tests/test_scalar_breadth.py
    "bitwise": "SELECT bitwise_and(12, 10), bitwise_or(12, 10), "
               "bitwise_xor(12, 10), bitwise_not(0), "
               "bitwise_left_shift(1, 4), bitwise_right_shift(16, 2)",
    "bit_count": "SELECT bit_count(7, 64), bit_count(255, 8), "
                 "bit_count(-1, 64)",
    "digests": "SELECT md5('abc'), sha256('abc'), crc32('abc'), "
               "sha1('abc'), sha512('abc')",
    "xxhash64": "SELECT xxhash64('hello'), xxhash64(''), "
                "xxhash64('abcdefghijklmnopqrstuvwxyz0123456789ABCD')",
    "url_functions": f"SELECT url_extract_protocol({URL}), "
                     f"url_extract_host({URL}), url_extract_port({URL}), "
                     f"url_extract_path({URL}), url_extract_query({URL}), "
                     f"url_extract_fragment({URL}), "
                     f"url_extract_parameter({URL}, 'b')",
    "url_encode_decode": "SELECT url_encode('a b&c'), "
                         "url_decode('a+b%26c')",
    "translate_hex_log": "SELECT translate('hello', 'el', 'ip'), "
                         "to_hex(255), log(2, 8)",
    "over_table_rows": "SELECT count(DISTINCT md5(n_name)) FROM "
                       "tpch.tiny.nation",
    "regexp_extract_replace": (
        "SELECT regexp_extract('1a 2b 14m', '(\\d+)([a-z]+)', 2), "
        "regexp_replace('1a 2b 14m', '(\\d+)([a-z]+)', '$2')"),
    "split_part": "SELECT split_part('a.b.c', '.', 2)",
    "string_distance_and_misc": (
        "SELECT levenshtein_distance('kitten', 'sitting'), "
        "hamming_distance('karolin', 'kathrin'), codepoint('A'), chr(66), "
        "normalize('Å'), concat_ws('-', 'a', NULL, 'b')"),
    "math_constants": "SELECT pi(), e(), atan2(1, 1), "
                      "width_bucket(5.3, 0.2, 10.6, 5), is_nan(nan()), "
                      "infinity() > 1e308",
    "bases_and_format": "SELECT to_base(255, 16), from_base('ff', 16), "
                        "format('%s=%d [%.2f]', 'x', 42, 1.5), "
                        "format('%,d', 1234567)",
    "typeof": "SELECT typeof(1), typeof('x'), typeof(1.5e0)",
    "year_of_week": "SELECT year_of_week(DATE '2005-01-01'), "
                    "year_of_week(DATE '2008-12-31')",
    "hmac": "SELECT hmac_sha256('hello', 'key'), hmac_md5('v', 'k'), "
            "hmac_sha1('v', 'k'), hmac_sha512('v', 'k')",
    "utf8_roundtrip": "SELECT from_utf8(to_utf8('héllo'))",
    "big_endian_roundtrip": "SELECT from_big_endian_64(to_big_endian_64(x)),"
                            " from_big_endian_32(to_big_endian_32("
                            "CAST(x % 1000 AS INTEGER))) "
                            "FROM (VALUES 0, 1, -1, 1234567890123) t(x)",
    "ieee754_roundtrip": "SELECT from_ieee754_64(to_ieee754_64(x)), "
                         "from_ieee754_32(to_ieee754_32(CAST(x AS REAL))) "
                         "FROM (VALUES 0.5e0, -2.25e0) t(x)",
    "bar": "SELECT bar(x, 10) FROM (VALUES 0.5e0, 0e0, 1e0, 2e0, -1e0, "
           "0.26e0) t(x)",
    "parse_format_datetime": (
        "SELECT format_datetime(TIMESTAMP '2001-08-22 03:04:05.321', "
        "'yyyy-MM-dd HH:mm:ss'), year(parse_datetime('2020/06/10', "
        "'yyyy/MM/dd'))"),
    "from_iso8601": "SELECT from_iso8601_date('2020-05-11'), "
                    "hour(from_iso8601_timestamp("
                    "'2020-05-11T11:15:05+02:00'))",
    "last_day_of_month": "SELECT last_day_of_month(DATE '2024-02-11'), "
                         "last_day_of_month(DATE '2023-02-01')",
    "timezone_parts": "SELECT timezone_hour(from_iso8601_timestamp("
                      "'2020-05-11T11:15:05+05:30')), "
                      "timezone_minute(from_iso8601_timestamp("
                      "'2020-05-11T11:15:05-05:30'))",
    "word_stem": "SELECT word_stem('running'), word_stem('cats'), "
                 "word_stem('nationalization')",
    "json_parse_format": "SELECT json_format(json_parse("
                         "' {\"a\" : 1, \"b\": [1, 2]} '))",
    "hmac_over_varbinary": "SELECT hmac_sha256(to_big_endian_64(200), "
                           "'k')",
    "format_datetime_millis": "SELECT format_datetime(TIMESTAMP "
                              "'2024-01-01 00:10:00.001', 'HHmmSSS')",
    # the same functions over rows, NULLs and non-ASCII text
    "text_over_rows": (
        f"SELECT k, word_stem(s), md5(s), crc32(s), xxhash64(s), "
        f"url_encode(s), levenshtein_distance(s, 'cats'), "
        f"hamming_distance(s, s), concat_ws('/', s, 'x', s), "
        f"translate(s, 'an', 'AN'), to_hex(s), codepoint(s), "
        f"normalize(s, 'NFD'), from_utf8(to_utf8(s)) "
        f"FROM {WORDS} WHERE k <> 5 ORDER BY k"),
    "numbers_over_rows": (
        "SELECT n_nationkey, bitwise_and(n_nationkey, 6), "
        "bitwise_or(n_regionkey, 8), bitwise_xor(n_nationkey, "
        "n_regionkey), bitwise_not(n_nationkey), bitwise_left_shift("
        "n_nationkey, n_regionkey), bitwise_right_shift(n_nationkey * 977, "
        "n_regionkey), bit_count(n_nationkey, 8), to_hex(n_nationkey * "
        "4099), chr(n_nationkey + 65), to_base(n_nationkey * 31, "
        "n_regionkey + 2), log(2, n_nationkey + 1), atan2(n_nationkey, "
        "n_regionkey + 1), width_bucket(n_nationkey, 2, 20, 6), "
        "width_bucket(n_nationkey, 20, 2, 6), format('%d:%s:%05.1f', "
        "n_nationkey, n_name, n_nationkey / 3.0e0), "
        "from_big_endian_64(to_big_endian_64(n_nationkey - 12)) "
        "FROM tpch.tiny.nation ORDER BY 1"),
    "hashes_over_table": (
        "SELECT count(DISTINCT md5(to_utf8(c_name))), "
        "count(DISTINCT sha256(to_utf8(c_name))), "
        "sum(crc32(to_utf8(c_name))), "
        "sum(xxhash64(to_utf8(c_name)) % 1000003), "
        "sum(from_base(substr(sha1(c_name), 1, 8), 16)), "
        "count(DISTINCT hmac_sha1(c_name, 'k')) FROM tpch.tiny.customer"),
    "url_over_rows": (
        "SELECT url_extract_host(u), url_extract_port(u), "
        "url_extract_path(u), url_extract_query(u), "
        "url_extract_parameter(u, 'q'), url_decode(url_encode(u)) FROM "
        "(VALUES 'http://a.example.org/x/y?q=1&r=2', "
        "'https://b.example.com:443/#f', 'ftp://c.example.net', NULL) "
        "t(u) ORDER BY 1"),
    "json_over_rows": (
        "SELECT json_extract_scalar(j, '$.a'), json_extract(j, '$.b'), "
        "json_array_length(json_extract(j, '$.b')), json_size(j, '$.b'), "
        "json_format(json_parse(j)) FROM (VALUES '{\"a\": 1, \"b\": [1, "
        "2, 3]}', '{\"a\": \"x\", \"b\": {\"c\": true}}', '{\"b\": []}') "
        "t(j)"),
    "math_over_rows": (
        "SELECT x, log(3, x), atan2(x, 2), width_bucket(x, 0, 10, 4), "
        "is_nan(x / 0e0), pi() * x, e() - x FROM (VALUES 0.5e0, 2e0, "
        "9.99e0, 10e0, 11e0, -1e0) t(x) ORDER BY 1"),
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_sql_matches_the_jax_engine(name, jax, port):
    _same(port.execute(SQL[name]).rows, jax.execute(SQL[name]).rows)


def test_scalar_breadth_known_answers(port):
    """The reference tests' own expected values, through the port."""
    q = lambda s: port.execute(s).rows   # noqa: E731
    assert q(SQL["bitwise"]) == [[8, 14, 6, -1, 16, 4]]
    assert q(SQL["bit_count"]) == [[3, 8, 64]]
    got = q(SQL["digests"])[0]
    assert got[0] == "900150983cd24fb0d6963f7d28e17f72"
    assert got[1].startswith("ba7816bf8f01cfea") and got[2] == 891568578
    assert q(SQL["url_functions"]) == [["https", "example.com", 8080,
                                        "/path/x", "a=1&b=two", "frag",
                                        "two"]]
    assert q(SQL["translate_hex_log"]) == [["hippo", "FF", 3.0]]
    assert q(SQL["string_distance_and_misc"]) == [[3, 3, 65, "B", "Å",
                                                   "a-b"]]
    assert q(SQL["bases_and_format"]) == [["ff", 255, "x=42 [1.50]",
                                           "1,234,567"]]
    assert q(SQL["typeof"]) == [["integer", "varchar(1)", "double"]]
    assert q(SQL["year_of_week"]) == [[2004, 2009]]
    assert q(SQL["word_stem"]) == [["run", "cat", "nationalize"]]
    assert q(SQL["format_datetime_millis"]) == [["0010001"]]
    exp = hm.new(b"k", struct.pack(">q", 200), hashlib.sha256).hexdigest()
    assert q(SQL["hmac_over_varbinary"]) == [[exp]]
    assert q(SQL["from_iso8601"]) == [[datetime.date(2020, 5, 11), 11]]
    (b,), = q("SELECT bar(0.5e0, 10)")
    assert len(b) == 10 and b.startswith("█████ ")


def test_xxhash64_equals_the_native_library(jax, port):
    """The port's own xxHash64 (numpy, strings of one length at a time)
    against the JAX engine's, which calls the native serde library, over
    every length from 0 to 80 bytes, and the algorithm's test vectors."""
    from trino_tpu.exec.expr import _xxh64_py
    from trino_tpu_torch.exec.scalars import xxh64_many
    assert xxh64_many([b"", b"a"]).view(np.uint64).tolist() == [
        0xEF46DB3751D8E999, 0xD24EC4F1A98C6E5B]
    rng = np.random.default_rng(7)
    vals = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
            for n in list(range(81)) * 2]
    got = xxh64_many(vals).view(np.uint64)
    assert [int(g) for g in got] == [_xxh64_py(v) for v in vals]
    words = ", ".join(f"'{'x' * n}{n}'" for n in range(0, 70, 3))
    sql = f"SELECT s, xxhash64(s) FROM (VALUES {words}) t(s) ORDER BY 1"
    want = jax.execute(sql).rows
    assert port.execute(sql).rows == want
    assert [r[1] for r in want] == [
        int(np.uint64(_xxh64_py(r[0].encode())).view(np.int64))
        for r in want]


def test_random_range_and_type(port):
    got = port.execute("SELECT random(), random(10), rand() FROM "
                       "lineitem LIMIT 50").rows
    assert len(got) == 50
    assert all(isinstance(r[0], float) and 0.0 <= r[0] < 1.0
               and isinstance(r[1], int) and 0 <= r[1] < 10
               and 0.0 <= r[2] < 1.0 for r in got)
    assert len({r[0] for r in got}) > 1


def test_current_date_and_now(port):
    got = port.execute("SELECT current_date, year(current_date), "
                       "now() > TIMESTAMP '2020-01-01 00:00:00', "
                       "hour(current_time) < 24").rows[0]
    assert got[0] == datetime.datetime.now(datetime.timezone.utc).date() \
        or abs((got[0] - datetime.date.today()).days) <= 1
    assert got[1] >= 2026 and got[2] is True and got[3] is True


# ---- faults of the JAX engine (ROADMAP C): the port gives Trino's answer ----

def test_right_shift_is_logical(port):
    """bitwise_right_shift is >>> (the JAX engine shifts arithmetically):
    a negative BIGINT shifts in zeros; an INTEGER shifts its 32 bits."""
    assert port.execute(
        "SELECT bitwise_right_shift(CAST(-16 AS BIGINT), 2), "
        "bitwise_right_shift(-16, 2), bitwise_right_shift(-1, 0), "
        "bitwise_right_shift(CAST(-1 AS BIGINT), 63), "
        "bitwise_right_shift(5, 64), bitwise_left_shift(1, 64), "
        "bitwise_left_shift(CAST(-1 AS BIGINT), 63)").rows == [[
            (1 << 62) - 4, (1 << 30) - 4, 0xFFFFFFFF, 1, 0, 0, -(1 << 63)]]


def test_double_functions_read_decimal_values(port):
    """sqrt, power, log, atan2 and width_bucket of a DECIMAL read its value
    (the JAX engine reads the unscaled lane: sqrt(2.25) = 15)."""
    got = port.execute("SELECT sqrt(2.25), power(1.5, 2), log(2, 8.0), "
                       "atan2(1.0, 1), width_bucket(5.3, 0.2, 10, 5), "
                       "exp(CAST(1.5 AS DECIMAL(30, 10)))").rows[0]
    assert got[:3] == [1.5, 2.25, 3.0]
    assert got[3] == pytest.approx(math.pi / 4, rel=REL)
    assert got[4] == 3
    assert got[5] == pytest.approx(math.exp(1.5), rel=REL)


def test_decimal_floor_ceil_truncate_sign(port):
    """floor, ceil, truncate and sign of a DECIMAL give the integer value
    (kept at the column's scale), short and long alike (the JAX engine
    returns a short decimal unchanged, or its unscaled sign)."""
    from decimal import ROUND_CEILING, ROUND_DOWN, ROUND_FLOOR, Decimal
    xs = ["1.25", "-7.55", "-0.05", "9.99", "2.00", "-0.35", "0.00"]
    for t in ("DECIMAL(9, 3)", "DECIMAL(30, 3)", "DECIMAL(38, 20)"):
        rows = port.execute(
            f"SELECT floor(c), ceil(c), truncate(c), sign(c) FROM (SELECT "
            f"CAST(x AS {t}) c FROM (VALUES " + ", ".join(
                f"'{x}'" for x in xs) + ") t(x))").rows
        for x, r in zip(xs, rows):
            d = Decimal(x)
            assert r == [d.to_integral_value(ROUND_FLOOR),
                         d.to_integral_value(ROUND_CEILING),
                         d.to_integral_value(ROUND_DOWN),
                         Decimal((d > 0) - (d < 0))], (t, x, r)
    big = port.execute("SELECT floor(x), ceil(x) FROM (VALUES CAST("
                       "'-12345678901234567890.5' AS DECIMAL(30, 1))) "
                       "t(x)").rows
    assert big == [[Decimal("-12345678901234567891"),
                    Decimal("-12345678901234567890")]]


def test_long_decimal_greatest_least(port):
    """greatest/least of DECIMAL(p>18) compare all 128 bits (the JAX
    engine compares the low lanes)."""
    from decimal import Decimal
    pairs = [("12345678901234567890.25", "-3.50"), ("-7.55", "-7.56"),
             ("0.00", "99999999999999999999.99"),
             ("-18446744073709551616.00", "-1.00")]
    rows = port.execute(
        "SELECT greatest(a, b), least(a, b) FROM (SELECT CAST(x AS "
        "DECIMAL(30, 2)) a, CAST(y AS DECIMAL(30, 2)) b FROM (VALUES "
        + ", ".join(f"('{x}', '{y}')" for x, y in pairs) + ") t(x, y))"
    ).rows
    assert rows == [[max(Decimal(x), Decimal(y)), min(Decimal(x),
                                                      Decimal(y))]
                    for x, y in pairs]


def test_digests_read_varbinary_bytes(port):
    """A VARBINARY's digests and hex read its bytes (the JAX engine
    re-encodes the carried text, which differs past ASCII)."""
    raw = "héllo".encode()
    assert port.execute("SELECT md5(to_utf8('héllo')), crc32(to_utf8("
                        "'héllo')), to_hex(to_utf8('héllo')), md5('héllo')"
                        ).rows == [[hashlib.md5(raw).hexdigest(),
                                    zlib.crc32(raw), raw.hex().upper(),
                                    hashlib.md5(raw).hexdigest()]]


def test_errors_raise(port):
    for sql, msg in [
            ("SELECT to_base(5, 40)", "radix"),
            ("SELECT from_base('zz', 10)", "not a number"),
            ("SELECT hamming_distance('ab', 'abc')", "same length"),
            ("SELECT json_parse('{x')", "JSON")]:
        with pytest.raises(QueryError, match=msg):
            port.execute(sql)
    # try() turns a function's error into NULL
    assert port.execute("SELECT try(from_base('zz', 10))").rows == [[None]]


# ---- the port's dispatch against the reference's ---------------------------

# the functions of geometries (ops/geo.py), the last the port took in
GEO_NAMES = {"st_point", "st_x", "st_y", "st_distance",
             "st_geometryfromtext", "st_astext", "st_contains",
             "great_circle_distance"}


def test_dispatch_covers_every_scalar_function_of_the_reference():
    from trino_tpu.exec.expr import _DISPATCH as TPU_DISPATCH
    from trino_tpu_torch.exec.expr import _DISPATCH
    missing = set(TPU_DISPATCH) - set(_DISPATCH)
    assert missing == set()
    assert GEO_NAMES <= set(_DISPATCH)
    # the container functions are all in (exec/complex.py)
    for name in ("element_at", "split", "array_join", "$array",
                 "value_at_quantile"):
        assert name in _DISPATCH


@pytest.mark.parametrize("sql", [
    "SELECT split('a.b', '.')", "SELECT array_join(ARRAY['x'], '-')",
    "SELECT regexp_split('a,b', ',')"])
def test_container_functions_stay_not_yet_ported(port, sql):
    """Once outside the port, these three now equal the JAX engine."""
    want = TpuRunner().execute(sql).rows
    assert port.execute(sql).rows == want


def test_keyed_transform_tables_follow_their_dictionary():
    """A named transform's host table is kept by the dictionary it was
    built over and reused only there: another dictionary, or another
    function key, computes afresh."""
    import torch
    from trino_tpu_torch.columnar import Column, StringDictionary
    from trino_tpu_torch.exec import expr
    from trino_tpu_torch.types import VARCHAR

    def col(values):
        d, codes = StringDictionary.from_strings(values)
        return Column(VARCHAR, torch.from_numpy(codes), None, d)
    calls = []

    def upper(v):
        calls.append(v)
        return v.upper()
    a, b = col(["x", "y", "x"]), col(["p", "q"])
    got = [expr._dict_transform(c, upper, VARCHAR, key="test-upper")
           for c in (a, a, b, a)]
    assert [g.dictionary.values[g.data].tolist() for g in got] == [
        ["X", "Y", "X"], ["X", "Y", "X"], ["P", "Q"], ["X", "Y", "X"]]
    assert calls == ["x", "y", "p", "q"]
    lower = expr._dict_transform(a, str.lower, VARCHAR, key="test-lower")
    assert lower.dictionary.values[lower.data].tolist() == ["x", "y", "x"]
    # without a key nothing is kept
    expr._dict_transform(a, upper, VARCHAR)
    assert calls[-2:] == ["x", "y"]
