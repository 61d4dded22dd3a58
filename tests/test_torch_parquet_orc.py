"""The PyTorch engine's Parquet and ORC readers and writers against the
JAX engine's, on the CPU.

Every assertion of tests/test_parquet_localfile.py, tests/test_orc.py and
tests/test_format_writers.py runs here against the port (files written
by pyarrow, an independent writer, where those tests use it), and the
port's rows are held equal to the JAX engine's on the same files. The
port's writers must write byte-identical files to the reference's for
the same rows (tpch.tiny lineitem's writable columns, NULLs, non-ASCII
strings, booleans, dates), and each package must read the other's files
to the same rows.
"""

import datetime
import json
import os

import numpy as np
import pytest

from trino_tpu.columnar import batch_from_pylist as jax_batch
from trino_tpu.connectors.localfile import \
    LocalFileConnector as JaxLocalFile
from trino_tpu.formats import orc as jorc
from trino_tpu.formats import parquet as jpq
from trino_tpu.formats.orc_writer import write_orc as jax_write_orc
from trino_tpu.formats.parquet_writer import \
    write_parquet as jax_write_parquet
from trino_tpu.runner import LocalQueryRunner as JaxRunner
from trino_tpu.types import (BIGINT as J_BIGINT, BOOLEAN as J_BOOLEAN,
                             DATE as J_DATE, DOUBLE as J_DOUBLE,
                             VARCHAR as J_VARCHAR)
from trino_tpu_torch.columnar import batch_from_pylist
from trino_tpu_torch.connectors.localfile import LocalFileConnector
from trino_tpu_torch.formats.orc import (num_stripes, read_meta, read_orc,
                                         schema_of)
from trino_tpu_torch.formats.orc_writer import write_orc
from trino_tpu_torch.formats.parquet import (read_metadata, read_parquet,
                                             snappy_decompress)
from trino_tpu_torch.formats.parquet_writer import write_parquet
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.sql.parser import parse_statement
from trino_tpu_torch.types import BIGINT, BOOLEAN, DATE, DOUBLE, VARCHAR

CPU = "cpu"
REL = 1e-9


def _runner(path, fmt=None):
    conn = LocalFileConnector(str(path), device=CPU)
    if fmt:
        conn.write_format = fmt
    r = LocalQueryRunner(device=CPU)
    r.catalogs.register("files", conn)
    return r


def _jax_runner(path, fmt=None):
    conn = JaxLocalFile(str(path))
    if fmt:
        conn.write_format = fmt
    r = JaxRunner()
    r.catalogs.register("files", conn)
    return r


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=REL)
            else:
                assert a == b


# --------------------------------------------------------------------------
# tests/test_parquet_localfile.py
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    d = tmp_path_factory.mktemp("files")
    n = 1000
    rng = np.random.default_rng(0)
    table = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "qty": pa.array(rng.integers(0, 50, n).astype(np.int32)),
        "price": pa.array(rng.uniform(1.0, 100.0, n)),
        "flag": pa.array((np.arange(n) % 3 == 0)),
        "name": pa.array([f"item_{i % 17}" for i in range(n)]),
        "maybe": pa.array([None if i % 5 == 0 else i
                           for i in range(n)], type=pa.int64()),
        "day": pa.array([datetime.date(1995, 1, 1)
                         + datetime.timedelta(days=int(i % 700))
                         for i in range(n)]),
    })
    pq.write_table(table, d / "plain.parquet", compression="none",
                   use_dictionary=False)
    pq.write_table(table, d / "snappy.parquet", compression="snappy")
    pq.write_table(table, d / "gzipped.parquet", compression="gzip")
    pq.write_table(table, d / "grouped.parquet", compression="snappy",
                   row_group_size=100)
    with open(d / "people.csv", "w") as f:
        f.write("name,age,score\nalice,30,1.5\nbob,25,2.25\n")
    with open(d / "events.json", "w") as f:
        f.write(json.dumps({"kind": "click", "n": 3}) + "\n")
        f.write(json.dumps({"kind": "view", "n": 7}) + "\n")
    return d


def _expected(table_rows=1000):
    rng = np.random.default_rng(0)
    qty = rng.integers(0, 50, table_rows).astype(np.int32)
    price = rng.uniform(1.0, 100.0, table_rows)
    return qty, price


def test_snappy_roundtrip_against_reference_vectors():
    pa = pytest.importorskip("pyarrow")
    raw = b"trino-tpu snappy " * 100 + os.urandom(50)
    comp = pa.compress(raw, codec="snappy", asbytes=True)
    assert snappy_decompress(comp) == raw == jpq.snappy_decompress(comp)


@pytest.mark.parametrize("fname", ["plain.parquet", "snappy.parquet",
                                   "gzipped.parquet",
                                   "grouped.parquet"])
def test_read_parquet_matches_pyarrow(datadir, fname):
    pq = pytest.importorskip("pyarrow.parquet")
    path = str(datadir / fname)
    got = read_parquet(path, device=CPU)
    ref = pq.read_table(path).to_pydict()
    n = got.num_rows_host()
    assert n == 1000
    rows = got.to_pylist()
    names = list(got.columns)
    for i in (0, 1, 499, 999):
        for j, col in enumerate(names):
            want = ref[col][i]
            have = rows[i][j]
            if isinstance(want, float):
                assert have == pytest.approx(want)
            else:
                assert have == want, (col, i, have, want)
    # every row equals the JAX engine's reader's
    assert rows == jpq.read_parquet(path).to_pylist()


def test_metadata_and_row_groups(datadir):
    meta = read_metadata(str(datadir / "grouped.parquet"))
    assert meta.num_rows == 1000
    assert len(meta.row_groups) == 10
    one = read_parquet(str(datadir / "grouped.parquet"), row_group=3,
                       device=CPU)
    assert one.num_rows_host() == 100
    assert one.to_pylist() == jpq.read_parquet(
        str(datadir / "grouped.parquet"), row_group=3).to_pylist()


def test_column_projection(datadir):
    b = read_parquet(str(datadir / "snappy.parquet"),
                     columns=["id", "name"], device=CPU)
    assert list(b.columns) == ["id", "name"]
    assert b.to_pylist() == jpq.read_parquet(
        str(datadir / "snappy.parquet"), columns=["id", "name"]).to_pylist()


def test_localfile_connector_sql(datadir):
    runner = _runner(datadir)
    jax = _jax_runner(datadir)
    sqls = ["SELECT count(*), sum(qty) FROM files.default.snappy",
            "SELECT count(*) FROM files.default.snappy "
            "WHERE flag AND qty > 25",
            "SELECT count(*) FROM files.default.grouped "
            "WHERE flag AND qty > 25",
            "SELECT count(*) FROM files.default.snappy WHERE maybe IS NULL",
            "SELECT min(day), max(day) FROM files.default.snappy"]
    got = [runner.execute(s).rows for s in sqls]
    qty, _ = _expected()
    assert got[0] == [[1000, int(qty.sum())]]
    flag = np.arange(1000) % 3 == 0
    assert got[1] == [[int((flag & (qty > 25)).sum())]]
    # split-per-row-group scan agrees
    assert got[2] == got[1]
    # nulls survive
    assert got[3] == [[200]]
    # dates decode
    assert got[4][0][0] == datetime.date(1995, 1, 1)
    assert got == [jax.execute(s).rows for s in sqls]


def test_localfile_csv_json(datadir):
    runner = _runner(datadir)
    jax = _jax_runner(datadir)
    sql = "SELECT name, age FROM files.default.people ORDER BY age DESC"
    assert runner.execute(sql).rows == [['alice', 30], ['bob', 25]] \
        == jax.execute(sql).rows
    sql = "SELECT sum(n) FROM files.default.events"
    assert runner.execute(sql).rows == [[10]] == jax.execute(sql).rows
    tables = {r[0] for r in runner.execute(
        "SHOW TABLES FROM files.default").rows}
    assert {"people", "events", "snappy"} <= tables


def test_strings_and_varchar_agg(datadir):
    runner = _runner(datadir)
    got = runner.execute(
        "SELECT count(DISTINCT name) FROM files.default.plain").rows
    assert got == [[17]]


# --------------------------------------------------------------------------
# tests/test_orc.py
# --------------------------------------------------------------------------

N = 4000


@pytest.fixture(scope="module")
def table():
    pa = pytest.importorskip("pyarrow")
    rng = np.random.default_rng(11)
    # `skewed` forces RLEv2 PATCHED_BASE (a few huge outliers over a
    # narrow base range); `runs` forces SHORT_REPEAT / DELTA
    skewed = rng.integers(0, 100, N)
    skewed[::500] = 10**15
    return pa.table({
        "id": pa.array(np.arange(N, dtype=np.int64)),
        "qty": pa.array(rng.integers(0, 50, N).astype(np.int32)),
        "price": pa.array(np.round(rng.uniform(1.0, 100.0, N), 4)),
        "flag": pa.array((np.arange(N) % 3 == 0)),
        "name": pa.array([f"orc_{i % 23}" for i in range(N)]),
        "maybe": pa.array([None if i % 7 == 0 else i * 11
                           for i in range(N)], type=pa.int64()),
        "day": pa.array([datetime.date(2001, 6, 1)
                         + datetime.timedelta(days=int(i % 900))
                         for i in range(N)]),
        "ts": pa.array([datetime.datetime(2022, 5, 6, 7, 8, 9, 250000)
                        + datetime.timedelta(seconds=int(i))
                        for i in range(N)], type=pa.timestamp("ms")),
        "skewed": pa.array(skewed, pa.int64()),
        "runs": pa.array(np.repeat(np.arange(N // 100), 100)),
    })


@pytest.fixture(scope="module", params=["UNCOMPRESSED", "ZLIB",
                                        "SNAPPY", "ZSTD"])
def orc_file(request, table, tmp_path_factory):
    po = pytest.importorskip("pyarrow.orc")
    d = tmp_path_factory.mktemp("orc")
    path = str(d / f"data_{request.param}.orc")
    po.write_table(table, path, compression=request.param)
    return path


def test_schema(orc_file):
    s = schema_of(orc_file)
    assert str(s["id"]) == "bigint"
    assert str(s["qty"]) == "integer"
    assert str(s["price"]) == "double"
    assert str(s["flag"]) == "boolean"
    assert str(s["day"]) == "date"
    assert str(s["ts"]) == "timestamp(3)"
    assert {k: str(v) for k, v in s.items()} == \
        {k: str(v) for k, v in jorc.schema_of(orc_file).items()}


def test_full_read_matches_pyarrow(orc_file, table):
    b = read_orc(orc_file, device=CPU)
    rows = b.to_pylist()
    assert len(rows) == N
    want = table.to_pylist()
    names = list(b.names)
    for i in (0, 1, 17, N // 2, N - 1):
        got = dict(zip(names, rows[i]))
        for k in ("id", "qty", "flag", "name", "maybe", "day", "ts",
                  "skewed", "runs"):
            assert got[k] == want[i][k], (i, k, got[k], want[i][k])
        assert abs(got["price"] - want[i]["price"]) < 1e-9
    assert rows == jorc.read_orc(orc_file).to_pylist()


def test_patched_base_and_runs_whole_column(orc_file, table):
    b = read_orc(orc_file, columns=["skewed", "runs", "maybe"], device=CPU)
    sk = [r[0] for r in b.to_pylist()]
    assert sk == table.column("skewed").to_pylist()
    rn = [r[1] for r in b.to_pylist()]
    assert rn == table.column("runs").to_pylist()
    mb = [r[2] for r in b.to_pylist()]
    assert mb == table.column("maybe").to_pylist()


def test_multi_stripe(table, tmp_path_factory):
    pa = pytest.importorskip("pyarrow")
    po = pytest.importorskip("pyarrow.orc")
    d = tmp_path_factory.mktemp("orcs")
    path = str(d / "striped.orc")
    big = pa.concat_tables([table] * 8)  # exceed one stripe's rows
    po.write_table(big, path, compression="SNAPPY",
                   stripe_size=16 * 1024)
    meta = read_meta(path)
    assert len(meta.stripes) > 1
    assert num_stripes(path) == len(meta.stripes)
    b = read_orc(path, device=CPU)
    assert [r[0] for r in b.to_pylist()] == list(range(N)) * 8
    # single-stripe read == that stripe's slice
    b0 = read_orc(path, stripe_index=0, device=CPU)
    assert b0.num_rows_host() == meta.stripes[0].num_rows
    assert b0.to_pylist() == jorc.read_orc(path, stripe_index=0).to_pylist()


def test_sql_over_orc(table, tmp_path_factory):
    po = pytest.importorskip("pyarrow.orc")
    d = tmp_path_factory.mktemp("orcsql")
    po.write_table(table, str(d / "events.orc"), compression="ZLIB",
                   stripe_size=32 * 1024)
    runner = _runner(d)
    rows = runner.execute(
        "SELECT count(*), sum(qty), min(day), max(name) "
        "FROM files.default.events").rows
    want_qty = sum(table.column("qty").to_pylist())
    assert rows == [[N, want_qty, datetime.date(2001, 6, 1),
                     "orc_9"]]
    sql = ("SELECT name, count(*) c FROM files.default.events "
           "WHERE maybe IS NOT NULL GROUP BY name "
           "ORDER BY c DESC, name LIMIT 3")
    top = runner.execute(sql).rows
    assert len(top) == 3
    assert top == _jax_runner(d).execute(sql).rows


# --------------------------------------------------------------------------
# tests/test_format_writers.py
# --------------------------------------------------------------------------

_SAMPLE = ({"k": [1, 2, None, 4], "s": ["alpha", None, "beta", "g"],
            "v": [1.5, -2.25, None, 0.0], "f": [True, None, False, True],
            "d": [0, 10957, None, 20000]})
_TYPES = {"k": BIGINT, "s": VARCHAR, "v": DOUBLE, "f": BOOLEAN, "d": DATE}
_JTYPES = {"k": J_BIGINT, "s": J_VARCHAR, "v": J_DOUBLE, "f": J_BOOLEAN,
           "d": J_DATE}


def _sample():
    return batch_from_pylist(_SAMPLE, _TYPES, CPU)


EXPECT = [
    [1, "alpha", 1.5, True, datetime.date(1970, 1, 1)],
    [2, None, -2.25, None, datetime.date(2000, 1, 1)],
    [None, "beta", None, False, None],
    [4, "g", 0.0, True, datetime.date(2024, 10, 4)],
]


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_writer_roundtrips_own_reader(tmp_path, fmt):
    path = str(tmp_path / f"t.{fmt}")
    if fmt == "parquet":
        write_parquet(path, _sample())
        back = read_parquet(path, device=CPU)
    else:
        write_orc(path, _sample())
        back = read_orc(path, device=CPU)
    assert back.to_pylist() == EXPECT


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_writer_roundtrips_pyarrow(tmp_path, fmt):
    path = str(tmp_path / f"t.{fmt}")
    if fmt == "parquet":
        pa = pytest.importorskip("pyarrow.parquet")
        write_parquet(path, _sample())
        t = pa.read_table(path)
    else:
        po = pytest.importorskip("pyarrow.orc")
        write_orc(path, _sample())
        t = po.ORCFile(path).read()
    d = t.to_pydict()
    assert d["k"] == [1, 2, None, 4]
    assert d["s"] == ["alpha", None, "beta", "g"]
    assert d["v"] == [1.5, -2.25, None, 0.0]
    assert d["f"] == [True, None, False, True]
    assert d["d"][1] == datetime.date(2000, 1, 1)


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_sql_create_insert_select_localfile(tmp_path, fmt):
    r = _runner(tmp_path, fmt)
    r.execute("CREATE TABLE files.default.sales "
              "(id BIGINT, region VARCHAR, amount DOUBLE)")
    r.execute("INSERT INTO files.default.sales VALUES "
              "(1, 'east', 10.5), (2, 'west', NULL), (3, NULL, 7.25)")
    r.execute("INSERT INTO files.default.sales VALUES (4, 'east', 1.0)")
    rows = r.execute("SELECT region, count(*), sum(amount) "
                     "FROM files.default.sales GROUP BY region "
                     "ORDER BY region").rows
    assert rows == [["east", 2, 11.5], ["west", 1, None],
                    [None, 1, 7.25]]
    # the file on disk is genuinely the declared format
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == f".{fmt}"
    r.execute("DROP TABLE files.default.sales")
    assert not list(tmp_path.iterdir())


# --------------------------------------------------------------------------
# the two packages on the same files
# --------------------------------------------------------------------------

WRITABLE_LINEITEM = ["l_orderkey", "l_partkey", "l_linenumber",
                     "l_quantity", "l_extendedprice", "l_discount",
                     "l_tax", "l_returnflag", "l_linestatus", "l_shipdate",
                     "l_commitdate", "l_shipinstruct", "l_shipmode",
                     "l_comment"]


def _mixed(n: int, seed: int):
    """Rows with NULLs in every column, non-ASCII and empty strings,
    booleans and dates."""
    rng = np.random.default_rng(seed)
    words = ["", "a", "héllo", "wörld ✓", "naïve café", "日本語",
             "x" * 40, "Ω≈ç√∫"]
    return {
        "k": [None if i % 7 == 0 else int(v) for i, v in
              enumerate(rng.integers(-2**62, 2**62, n))],
        "i": [None if i % 11 == 0 else int(v) for i, v in
              enumerate(rng.integers(-2**31, 2**31, n))],
        "s": [None if i % 5 == 0 else words[int(v)] + str(i % 3)
              for i, v in enumerate(rng.integers(0, len(words), n))],
        "v": [None if i % 13 == 0 else float(v) for i, v in
              enumerate(rng.normal(0, 1e6, n))],
        "f": [None if i % 3 == 0 else bool(v) for i, v in
              enumerate(rng.integers(0, 2, n))],
        "d": [None if i % 9 == 0 else int(v) for i, v in
              enumerate(rng.integers(-5000, 30000, n))],
    }


def _mixed_types(mod):
    return {"k": mod.BIGINT, "i": mod.INTEGER, "s": mod.VARCHAR,
            "v": mod.DOUBLE, "f": mod.BOOLEAN, "d": mod.DATE}


@pytest.fixture(scope="module")
def lineitem():
    """tpch.tiny lineitem's writable columns through both engines."""
    cols = ", ".join(WRITABLE_LINEITEM)
    sql = f"SELECT {cols} FROM tpch.tiny.lineitem"
    port = LocalQueryRunner(device=CPU)
    _, _, batch = port._run_query_batch(parse_statement(sql).query)
    return batch, JaxRunner().execute(sql).rows


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_writers_write_the_references_bytes_for_lineitem(tmp_path, fmt,
                                                         lineitem):
    batch, jax_rows = lineitem
    assert batch.to_pylist() == jax_rows
    from trino_tpu import types as jt
    jtypes = {c: jt.parse_type(str(batch.column(c).type))
              for c in batch.names}
    ref = jax_batch({c: [r[i] for r in jax_rows]
                     for i, c in enumerate(batch.names)}, jtypes)
    ours, theirs = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
    if fmt == "parquet":
        write_parquet(str(ours), batch)
        jax_write_parquet(str(theirs), ref)
    else:
        write_orc(str(ours), batch)
        jax_write_orc(str(theirs), ref)
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 3000])
def test_writers_write_the_references_bytes_nulls_and_text(tmp_path, fmt, n):
    from trino_tpu import types as jt
    from trino_tpu_torch import types as tt
    data = _mixed(n, seed=n)
    ours, theirs = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
    port = batch_from_pylist(data, _mixed_types(tt), CPU)
    jax = jax_batch(data, _mixed_types(jt))
    if fmt == "parquet":
        write_parquet(str(ours), port)
        jax_write_parquet(str(theirs), jax)
    else:
        write_orc(str(ours), port)
        jax_write_orc(str(theirs), jax)
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_each_package_reads_the_others_files(tmp_path, fmt):
    from trino_tpu import types as jt
    from trino_tpu_torch import types as tt
    data = _mixed(2500, seed=7)
    port_path, jax_path = tmp_path / f"p.{fmt}", tmp_path / f"j.{fmt}"
    port = batch_from_pylist(data, _mixed_types(tt), CPU)
    jax = jax_batch(data, _mixed_types(jt))
    if fmt == "parquet":
        write_parquet(str(port_path), port)
        jax_write_parquet(str(jax_path), jax)
        jax_read = jpq.read_parquet(str(port_path)).to_pylist()
        port_read = read_parquet(str(jax_path), device=CPU).to_pylist()
    else:
        write_orc(str(port_path), port)
        jax_write_orc(str(jax_path), jax)
        jax_read = jorc.read_orc(str(port_path)).to_pylist()
        port_read = read_orc(str(jax_path), device=CPU).to_pylist()
    want = port.to_pylist()
    assert jax_read == want
    assert port_read == want


def _pyarrow_files(tmp_path):
    """Parquet files with dictionary pages, data pages v2 and every codec;
    ORC files with every codec and several stripes."""
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    po = pytest.importorskip("pyarrow.orc")
    rng = np.random.default_rng(3)
    n = 3000
    t = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "name": pa.array([None if i % 11 == 0 else f"név_{i % 37}"
                          for i in range(n)]),
        "long": pa.array([f"a longer string, number {i % 29} of them"
                          for i in range(n)]),
        "x": pa.array(rng.normal(size=n)),
        "r": pa.array(rng.normal(size=n).astype(np.float32)),
        "q": pa.array(rng.integers(-9, 9, n).astype(np.int32)),
        "ts": pa.array([datetime.datetime(2020, 1, 1)
                        + datetime.timedelta(milliseconds=int(v))
                        for v in rng.integers(0, 10**10, n)],
                       type=pa.timestamp("ms")),
    })
    paths = []
    for comp in ("none", "snappy", "gzip", "zstd"):
        for version in ("1.0", "2.0"):
            p = tmp_path / f"{comp}_{version}.parquet"
            pq.write_table(t, p, compression=comp, row_group_size=1000,
                           data_page_version=version)
            paths.append(p)
    for comp in ("UNCOMPRESSED", "ZLIB", "SNAPPY", "ZSTD"):
        p = tmp_path / f"{comp}.orc"
        po.write_table(pa.concat_tables([t] * 3), p, compression=comp,
                       stripe_size=16 * 1024)
        paths.append(p)
    return paths


def test_both_readers_give_equal_rows_on_third_party_files(tmp_path):
    for p in _pyarrow_files(tmp_path):
        if p.suffix == ".parquet":
            groups = jpq.num_row_groups(str(p))
            assert read_parquet(str(p), device=CPU).to_pylist() == \
                jpq.read_parquet(str(p)).to_pylist(), p.name
            assert read_parquet(str(p), ["long", "id"], groups - 1,
                                device=CPU).to_pylist() == \
                jpq.read_parquet(str(p), ["long", "id"],
                                 groups - 1).to_pylist(), p.name
        else:
            assert read_orc(str(p), device=CPU).to_pylist() == \
                jorc.read_orc(str(p)).to_pylist(), p.name
            last = jorc.num_stripes(str(p)) - 1
            assert read_orc(str(p), ["name", "ts"], last,
                            device=CPU).to_pylist() == \
                jorc.read_orc(str(p), ["name", "ts"], last).to_pylist()


def test_strings_code_by_first_appearance(tmp_path):
    """A string column read from a file codes its values as
    StringDictionary.from_strings does, NULLs as 0."""
    from trino_tpu_torch.columnar import StringDictionary
    data = {"s": [None, "b", "a", None, "b", "ccccccccccc", "a", "日本"]}
    path = str(tmp_path / "s.parquet")
    write_parquet(path, batch_from_pylist(data, {"s": VARCHAR}, CPU))
    for b in (read_parquet(path, device=CPU),
              read_orc(_orc_copy(tmp_path, data), device=CPU)):
        col = b.column("s")
        d, codes = StringDictionary.from_strings(data["s"])
        assert list(col.dictionary.values) == list(d.values)
        assert col.data[:len(codes)].tolist() == codes.tolist()


def _orc_copy(tmp_path, data):
    path = str(tmp_path / "s.orc")
    write_orc(path, batch_from_pylist(data, {"s": VARCHAR}, CPU))
    return path


def test_localfile_ctas_insert_drop_against_the_jax_engine(tmp_path):
    """CTAS, INSERT and DROP in both formats through both engines give the
    same rows and the same files."""
    for fmt in ("parquet", "orc"):
        port_dir, jax_dir = tmp_path / f"p{fmt}", tmp_path / f"j{fmt}"
        port_dir.mkdir()
        jax_dir.mkdir()
        runners = (_runner(port_dir, fmt), _jax_runner(jax_dir, fmt))
        stmts = [
            "CREATE TABLE files.default.li AS SELECT l_orderkey, "
            "l_returnflag, l_quantity, l_shipdate FROM tpch.tiny.lineitem "
            "WHERE l_orderkey < 2000",
            "INSERT INTO files.default.li (l_orderkey, l_quantity) "
            "VALUES (1, 2.5), (7, NULL)"]
        for s in stmts:
            for r in runners:
                r.execute(s)
        assert (port_dir / f"li.{fmt}").read_bytes() == \
            (jax_dir / f"li.{fmt}").read_bytes()
        q = ("SELECT l_returnflag, count(*), sum(l_quantity), "
             "max(l_shipdate) FROM files.default.li GROUP BY 1 ORDER BY 1")
        _same_rows(runners[0].execute(q).rows, runners[1].execute(q).rows)
        for r in runners:
            r.execute("DROP TABLE files.default.li")
        assert not list(port_dir.iterdir())
