"""The port's page frames (trino_tpu_torch/serde.py with its own C++
codec, csrc/pageserde.cpp) against the JAX package's (trino_tpu/serde.py):
the same rows with the same dictionaries give the same bytes, each
package reads the other's frames, every lane kind of the port
round-trips, a corrupted frame raises, and the codec has no fallback.

Cells compare as the other port tests do: integers, strings and dates
exactly, doubles within rel 1e-9.
"""

import datetime
import decimal

import numpy as np
import pytest

from _torch_server import same_rows
from trino_tpu import serde as jax_serde
from trino_tpu.columnar import batch_from_pylist as jax_batch
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.stage.repartition import _fnv1a64
from trino_tpu.types import parse_type as jax_type
from trino_tpu_torch import serde
from trino_tpu_torch.columnar import batch_from_pylist
from trino_tpu_torch.ops import native
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.types import parse_type

D = datetime.date
DEC = decimal.Decimal

# the lane kinds both packages frame: numeric, long decimal, date,
# varchar and null lanes
SHARED = {
    "bigint": ("bigint", [1, None, -3, 1 << 40, 0]),
    "double": ("double", [1.5, -2.25, None, 1e300, 0.1]),
    "integer": ("integer", [7, -7, None, 0, 2147483647]),
    "boolean": ("boolean", [True, False, None, True, True]),
    "date": ("date", [D(2020, 1, 1), None, D(1969, 12, 31),
                      D(1998, 9, 2), D(1, 1, 1)]),
    "varchar": ("varchar", ["alpha", None, "beta", "alpha", "ünï"]),
    "short_decimal": ("decimal(12,2)", [DEC("1.25"), DEC("-7.55"), None,
                                        DEC("9999999999.99"), DEC("0")]),
    "long_decimal": ("decimal(30,4)",
                     [DEC("123456789012345678901.5"), DEC("-7.5500"),
                      None, DEC("0"), DEC("-99999999999999999999.9999")]),
}


def _pair(cols):
    data = {k: SHARED[k][1] for k in cols}
    return (jax_batch(data, {k: jax_type(SHARED[k][0]) for k in cols}),
            batch_from_pylist(data, {k: parse_type(SHARED[k][0])
                                     for k in cols}, device="cpu"))


@pytest.mark.parametrize("codec", [serde.CODEC_STORE, serde.CODEC_LZ4])
@pytest.mark.parametrize("kind", sorted(SHARED))
def test_frame_bytes_equal_the_jax_packages(kind, codec):
    jb, pb = _pair([kind])
    assert serde.serialize_batch(pb, codec=codec) == \
        jax_serde.serialize_batch(jb, codec=codec)


def test_frame_bytes_equal_on_a_wide_batch():
    jb, pb = _pair(sorted(SHARED))
    frame = serde.serialize_batch(pb)
    assert frame == jax_serde.serialize_batch(jb)
    # each package reads the other's frame to the same rows
    assert same_rows(serde.deserialize_batch(frame, "cpu").to_pylist(),
                     jax_serde.deserialize_batch(frame).to_pylist())
    assert same_rows(jax_serde.deserialize_batch(frame).to_pylist(),
                     jb.to_pylist())


def test_lz4_pages_of_large_lanes_equal_the_jax_packages():
    """Lanes past a megabyte in all are compressed and decompressed by
    the codec's thread pool: the bytes stay the JAX package's."""
    rng = np.random.default_rng(3)
    data = {"k": [int(x) for x in rng.integers(0, 50, 150_000)],
            "v": [float(x) for x in rng.integers(0, 9, 150_000)]}
    jb = jax_batch(data, {"k": jax_type("bigint"), "v": jax_type("double")})
    pb = batch_from_pylist(data, {"k": parse_type("bigint"),
                                  "v": parse_type("double")}, device="cpu")
    frame = serde.serialize_batch(pb)
    assert frame == jax_serde.serialize_batch(jb)
    assert len(frame) < 2 * 150_000 * 8 // 2    # compressed
    assert serde.deserialize_batch(frame, "cpu").to_pylist() == \
        pb.to_pylist()


# every lane kind of the port, as the executor makes it; each query's
# rows after a frame round trip equal the JAX engine's rows
ROUND_TRIP = {
    "numeric_nulls": "SELECT CAST(NULL AS BIGINT) AS a, 1.5 AS b, "
                     "CAST(2 AS INTEGER) AS c, true AS d",
    "long_decimal": "SELECT CAST('-123456789012345678.125' AS "
                    "DECIMAL(30,3)) AS d, o_orderkey FROM orders "
                    "WHERE o_orderkey < 10",
    "dates_strings": "SELECT o_orderdate, o_orderpriority, o_comment "
                     "FROM orders WHERE o_orderkey < 100",
    "timestamp": "SELECT TIMESTAMP '2020-02-29 12:34:56.789' AS t",
    "time": "SELECT TIME '01:02:03.456' AS t",
    "timestamp_tz": "SELECT TIMESTAMP '2020-02-29 12:34:56.789 "
                    "America/New_York' AS t",
    "array": "SELECT ARRAY[1, 2, NULL, 4] AS a, ARRAY['x', 'y'] AS b",
    "map": "SELECT map(ARRAY[1, 2], ARRAY['a', 'b']) AS m",
    "row": "SELECT CAST(ROW(1, 'x') AS ROW(a BIGINT, b VARCHAR)) AS r",
    "nested": "SELECT ARRAY[map(ARRAY['k'], ARRAY[1.5])] AS am",
    "hll": "SELECT cardinality(approx_set(o_custkey)) AS c FROM orders",
}


@pytest.fixture(scope="module")
def runners():
    return TpuRunner(), LocalQueryRunner(device="cpu")


@pytest.mark.parametrize("name", sorted(ROUND_TRIP))
def test_every_lane_kind_round_trips(runners, name):
    jr, pr = runners
    sql = ROUND_TRIP[name]
    batch = pr.execute_batch(sql)
    frame = serde.serialize_batch(batch)
    back = serde.deserialize_batch(frame, "cpu")
    assert back.schema() == batch.schema()
    assert same_rows(back.to_pylist(), batch.to_pylist())
    assert same_rows(back.to_pylist(), jr.execute(sql).rows)


def test_sketch_and_int128_lanes_cross_the_wire(runners):
    """Partial aggregates cross the exchange in these lanes: an HLL
    sketch column (the ragged elements lane) and an Int128 sum."""
    _, pr = runners
    b = pr.execute_batch(
        "SELECT o_orderstatus, approx_set(o_custkey) AS s, "
        "sum(CAST(o_totalprice AS DECIMAL(38,2))) AS t "
        "FROM orders GROUP BY o_orderstatus")
    assert b.column("s").elements is not None
    assert b.column("t").data2 is not None
    back = serde.deserialize_batch(serde.serialize_batch(b), "cpu")
    n = b.num_rows_host()
    for name in ("s", "t"):
        c0, c1 = b.column(name), back.column(name)
        assert c1.data[:n].tolist() == c0.data[:n].tolist()
        assert c1.data2[:n].tolist() == c0.data2[:n].tolist()
    e0, e1 = b.column("s").elements, back.column("s").elements
    assert e1.data[:e0.capacity].tolist() == e0.data.tolist()


def test_corrupted_frame_raises():
    _, pb = _pair(sorted(SHARED))
    frame = bytearray(serde.serialize_batch(pb))
    frame[len(frame) // 2] ^= 0x40
    with pytest.raises(ValueError, match="checksum"):
        serde.deserialize_batch(bytes(frame), "cpu")
    assert not serde.frame_valid(bytes(frame))
    assert not serde.frame_valid(b"TPG1")
    with pytest.raises(ValueError):
        serde.deserialize_batch(b"nope", "cpu")


def test_the_codec_has_no_fallback(monkeypatch, tmp_path):
    """Without a C++ compiler and without a built library, framing
    raises instead of falling back to another checksum."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "_compiler", lambda cxx: None)
    monkeypatch.setattr(serde, "_LIB", None)
    _, pb = _pair(["bigint"])
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        serde.serialize_batch(pb)


def test_fnv1a_of_the_codec_equals_the_python_loop():
    rng = np.random.default_rng(11)
    vals = ["", "a", "Customer#000000001", "ünïcødé ✓"] + [
        "".join(chr(int(c)) for c in rng.integers(32, 600, int(k)))
        for k in rng.integers(0, 40, 500)]
    got = serde.fnv1a64_many(vals)
    assert got.dtype == np.uint64
    assert [int(x) for x in got] == [_fnv1a64(v.encode("utf-8"))
                                     for v in vals]
