"""Civil-date arithmetic of the PyTorch engine
(trino_tpu_torch/ops/datetime.py) against the JAX engine's
(trino_tpu/ops/datetime.py) on the CPU, and SQL date expressions through
both engines. Dates are exact.

Then the TIMESTAMP, TIME and TIMESTAMP WITH TIME ZONE lanes and their
functions (exec/timefns.py): every case of tests/test_datetime_json.py
and tests/test_timestamptz.py and more rows (DST edges, dates before
1970, NULLs, named and fixed zones, the MySQL and Joda formats, ISO 8601,
JSON) through both runners, equal rows; the zone offsets of
ops/timezone.py against zoneinfo; the instant-based keys of GROUP BY,
DISTINCT, JOIN and ORDER BY; and the queries of chip_smoke.py's
scalar_sf10 phase at tpch.tiny. Where the JAX engine is at fault
(ROADMAP C) the port is held to Trino's answer.
"""

import datetime

from zoneinfo import ZoneInfo

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu.ops import datetime as tpu_dt
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu_torch.ops import datetime as dt
from trino_tpu_torch.runner import LocalQueryRunner


def _days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


# month ends, leap days, century rules, dates before the epoch
EDGES = [_days(2000, 1, 31), _days(2000, 2, 29), _days(1900, 2, 28),
         _days(2100, 3, 31), _days(1999, 12, 31), _days(1969, 12, 31),
         _days(1600, 2, 29), _days(1, 1, 1), _days(1970, 1, 1),
         _days(2024, 8, 31), _days(1583, 10, 15), _days(9999, 12, 31)]


def _day_lane():
    rng = np.random.default_rng(3)
    return np.concatenate([np.asarray(EDGES, np.int64),
                           rng.integers(-800_000, 2_900_000, 4000)])


def test_civil_round_trip_matches_jax():
    days = _day_lane()
    got = dt.civil_from_days(torch.from_numpy(days))
    want = tpu_dt.civil_from_days(jnp.asarray(days))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    back = dt.days_from_civil(*got)
    assert np.array_equal(back.numpy(), days)


@pytest.mark.parametrize("field", ["year", "month", "day", "quarter",
                                   "day_of_week", "day_of_year", "week"])
def test_extract_field_matches_jax(field):
    days = _day_lane()
    got = dt.extract_field(torch.from_numpy(days), field)
    want = tpu_dt.extract_field(jnp.asarray(days), field)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_extract_field_matches_python():
    days = _day_lane()[:400]
    # python's dates span the years 1 to 9999
    days = days[(days >= EDGES[7]) & (days <= EDGES[-1])]
    got = {f: dt.extract_field(torch.from_numpy(days), f).numpy()
           for f in ("year", "month", "day", "quarter")}
    for k, d in enumerate(days):
        date = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(d))
        assert (got["year"][k], got["month"][k], got["day"][k],
                got["quarter"][k]) == (date.year, date.month, date.day,
                                       (date.month - 1) // 3 + 1)


@pytest.mark.parametrize("months", [-25, -12, -1, 0, 1, 2, 3, 11, 12, 13,
                                    48, 1200])
def test_add_months_matches_jax(months):
    days = _day_lane()
    m = np.full(days.shape, months, np.int64)
    got = dt.add_months(torch.from_numpy(days), torch.from_numpy(m))
    want = tpu_dt.add_months(jnp.asarray(days), jnp.asarray(m))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_add_months_clamps_to_month_end():
    jan31 = torch.tensor([_days(2000, 1, 31), _days(2001, 1, 31)])
    one = torch.ones(2, dtype=torch.int64)
    assert dt.add_months(jan31, one).tolist() == [_days(2000, 2, 29),
                                                  _days(2001, 2, 28)]


SQL = [
    "SELECT o_orderdate, o_orderdate + INTERVAL '1' MONTH, "
    "o_orderdate - INTERVAL '2' YEAR, year(o_orderdate), "
    "month(o_orderdate), day(o_orderdate), quarter(o_orderdate), "
    "EXTRACT(YEAR FROM o_orderdate), day_of_week(o_orderdate) "
    "FROM orders WHERE o_orderkey < 200 ORDER BY o_orderkey",
    "SELECT count(*) FROM lineitem WHERE l_shipdate "
    ">= DATE '1996-01-31' + INTERVAL '1' MONTH "
    "AND l_shipdate < DATE '1996-02-29' + INTERVAL '1' YEAR",
]


@pytest.mark.parametrize("sql", SQL)
def test_date_sql_matches_jax(sql):
    want = TpuRunner().execute(sql)
    got = LocalQueryRunner(device="cpu").execute(sql)
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    assert got.rows == want.rows and len(got.rows) > 0


# ---- TIMESTAMP, TIME and TIMESTAMP WITH TIME ZONE ---------------------------

# DST edges in New York, a date before 1970, a leap day, NULL
TS = ("(VALUES (TIMESTAMP '2020-03-08 01:30:00', 1), "
      "(TIMESTAMP '2020-03-08 02:30:00', 2), "
      "(TIMESTAMP '2020-11-01 01:30:00', 3), "
      "(TIMESTAMP '1969-12-31 23:59:59.999', 4), "
      "(TIMESTAMP '2024-02-29 12:34:56.789', 5), (NULL, 6)) t(ts, k)")

TIME_SQL = {
    # tests/test_datetime_json.py
    "time_literal_and_fields": (
        "SELECT TIME '10:30:45', hour(TIME '10:30:45'), "
        "minute(TIME '10:30:45'), second(TIME '10:30:45'), "
        "millisecond(TIME '10:30:45.123')"),
    "time_compare_cast": ("SELECT TIME '11:00:00' > TIME '10:30:00', "
                          "CAST('09:08:07' AS time)"),
    "time_min_max": ("SELECT min(t), max(t) FROM (VALUES TIME '10:00:00', "
                     "TIME '09:00:00', NULL) x(t)"),
    "unixtime_roundtrip": ("SELECT to_unixtime(from_unixtime(12345)), "
                           "from_unixtime(86400), from_unixtime(1.5e0)"),
    "date_format_parse": (
        "SELECT date_format(TIMESTAMP '2020-03-01 10:30:00', "
        "'%Y-%m-%d %H:%i'), date_format(DATE '2021-06-15', '%W'), "
        "date_parse('2020-03-01 10:30', '%Y-%m-%d %H:%i')"),
    "date_parse_bad_input_null": (
        "SELECT date_parse(x, '%Y-%m-%d') FROM (VALUES 'nope', "
        "'2020-01-02') t(x) ORDER BY 1"),
    "json_extract_scalar": (
        "SELECT json_extract_scalar(j, '$.name'), "
        "json_extract_scalar(j, '$.tags[1]'), "
        "json_extract_scalar(j, '$.missing'), "
        "json_array_length(json_extract(j, '$.tags')), json_size(j, '$') "
        "FROM (VALUES '{\"name\": \"ab\", \"tags\": [\"x\", \"y\"], "
        "\"n\": 3}') t(j)"),
    "json_invalid_and_types": (
        "SELECT json_extract_scalar('not json', '$.a'), "
        "json_extract_scalar('[1,2,3]', '$[2]'), "
        "json_extract_scalar('{\"b\": true}', '$.b')"),
    "nth_value": (
        "SELECT x, nth_value(x, 2) OVER (ORDER BY x ROWS BETWEEN UNBOUNDED "
        "PRECEDING AND UNBOUNDED FOLLOWING) FROM (VALUES 10, 20, 30) t(x)"),
    "nth_value_running": ("SELECT x, nth_value(x, 3) OVER (ORDER BY x) "
                          "FROM (VALUES 1, 2, 3) t(x) ORDER BY x"),
    "nth_value_partitioned": (
        "SELECT DISTINCT n_regionkey, nth_value(n_name, 2) OVER (PARTITION "
        "BY n_regionkey ORDER BY n_nationkey ROWS BETWEEN UNBOUNDED "
        "PRECEDING AND UNBOUNDED FOLLOWING) FROM tpch.tiny.nation "
        "ORDER BY 1"),
    # tests/test_timestamptz.py
    "tstz_literal_and_display": (
        "SELECT TIMESTAMP '2020-06-01 10:30:00 +05:30'"),
    "tstz_instant_equality": (
        "SELECT TIMESTAMP '2020-01-01 12:00:00 +02:00' = "
        "TIMESTAMP '2020-01-01 10:00:00 UTC', "
        "TIMESTAMP '2020-01-01 12:00:00 +02:00' < "
        "TIMESTAMP '2020-01-01 11:00:00 UTC'"),
    "tstz_field_extraction": (
        "SELECT hour(TIMESTAMP '2020-06-01 23:30:00 -07:00'), "
        "day(TIMESTAMP '2020-06-01 23:30:00 -07:00'), "
        "hour(CAST(TIMESTAMP '2020-06-01 23:30:00 -07:00' AS timestamp))"),
    "at_time_zone": ("SELECT TIMESTAMP '2020-01-01 00:00:00 UTC' "
                     "AT TIME ZONE '+05:30'"),
    "with_timezone_and_iso8601": (
        "SELECT with_timezone(TIMESTAMP '2020-01-01 12:00:00', '+02:00'), "
        "to_iso8601(TIMESTAMP '2020-01-01 12:00:00 +02:00')"),
    "tstz_cast": (
        "SELECT CAST('2020-03-04 05:06:07' AS timestamp with time zone), "
        "CAST(TIMESTAMP '2020-03-04 23:30:00 -03:00' AS date)"),
    "tstz_order": (
        "SELECT t FROM (VALUES TIMESTAMP '2020-01-01 12:00:00 +05:00', "
        "TIMESTAMP '2020-01-01 12:00:00 +00:00', "
        "TIMESTAMP '2020-01-01 12:00:00 -03:00') v(t) ORDER BY t"),
    "tstz_group_by_instant": (
        "SELECT t, count(*) FROM (VALUES "
        "TIMESTAMP '2020-01-01 12:00:00 +02:00', "
        "TIMESTAMP '2020-01-01 10:00:00 UTC', "
        "TIMESTAMP '2020-01-01 11:00:00 UTC') v(t) "
        "GROUP BY t ORDER BY 2 DESC"),
    "named_zone": ("SELECT TIMESTAMP '2020-06-01 00:00:00 UTC' "
                   "AT TIME ZONE 'America/New_York'"),
    # over rows
    "timestamp_fields_and_formats": (
        "SELECT k, ts, hour(ts), minute(ts), second(ts), millisecond(ts), "
        "year(ts), month(ts), day_of_week(ts), day_of_year(ts), week(ts), "
        "quarter(ts), CAST(ts AS DATE), CAST(ts AS VARCHAR), "
        "to_iso8601(ts), date_format(ts, '%Y/%m/%d %H:%i:%s.%f %p %W %a "
        "%b %M %j'), format_datetime(ts, 'yyyy-MM-dd HH:mm:ss.SSS EEE "
        f"MMM'), to_unixtime(ts), last_day_of_month(ts), year_of_week(ts) "
        f"FROM {TS} ORDER BY k"),
    "timestamp_arithmetic": (
        "SELECT k, ts + INTERVAL '1' DAY, ts - INTERVAL '90' MINUTE, "
        "ts + INTERVAL '1' MONTH, ts - INTERVAL '1' YEAR, "
        "date_trunc('month', ts), date_trunc('hour', ts), "
        "date_trunc('week', ts), date_trunc('quarter', ts), "
        "date_trunc('second', ts), date_add('hour', 5, ts), "
        "date_add('month', -13, ts), date_add('day', 40, ts), "
        "date_diff('hour', TIMESTAMP '2020-01-01 00:00:00', ts), "
        "date_diff('day', TIMESTAMP '2020-01-01 00:00:00', ts), "
        "date_diff('month', TIMESTAMP '2020-01-31 00:00:00', ts), "
        "date_diff('year', ts, TIMESTAMP '2030-06-01 00:00:00'), "
        "date_diff('second', ts, TIMESTAMP '2030-06-01 00:00:00') "
        f"FROM {TS} ORDER BY k"),
    "timestamp_zones": (
        "SELECT k, ts AT TIME ZONE 'America/New_York', "
        "ts AT TIME ZONE 'Asia/Kolkata', ts AT TIME ZONE '-03:30', "
        "hour(ts AT TIME ZONE 'Europe/Berlin'), "
        "timezone_hour(ts AT TIME ZONE 'America/Los_Angeles'), "
        "CAST(ts AT TIME ZONE 'America/Los_Angeles' AS VARCHAR), "
        "to_iso8601(ts AT TIME ZONE 'Australia/Adelaide') "
        f"FROM {TS} ORDER BY k"),
    "timestamp_casts": (
        "SELECT k, CAST(ts AS timestamp with time zone), "
        "CAST(CAST(ts AS VARCHAR) AS timestamp), "
        "CAST(CAST(ts AS DATE) AS timestamp), date(ts), "
        "CAST(CAST(ts AS VARCHAR) AS timestamp with time zone) "
        f"FROM {TS} ORDER BY k"),
    "dates_over_orders": (
        "SELECT o_orderkey, date_format(o_orderdate, '%Y-%m'), "
        "to_iso8601(o_orderdate), CAST(o_orderdate AS TIMESTAMP) "
        "+ INTERVAL '13' HOUR, hour(at_timezone(CAST(o_orderdate AS "
        "TIMESTAMP) + INTERVAL '13' HOUR, 'America/Los_Angeles')), "
        "year_of_week(o_orderdate), date_trunc('month', o_orderdate), "
        "last_day_of_month(o_orderdate), date_diff('day', o_orderdate, "
        "DATE '1998-12-31'), date_add('quarter', 1, o_orderdate), "
        "from_iso8601_date(CAST(o_orderdate AS VARCHAR)) "
        "FROM tpch.tiny.orders WHERE o_orderkey < 400 ORDER BY 1"),
    "parse_functions": (
        "SELECT parse_datetime(s, 'yyyy-MM-dd HH:mm:ss'), "
        "from_iso8601_timestamp(i), date_parse(s, '%Y-%m-%d %H:%i:%s') "
        "FROM (VALUES ('2020-01-02 03:04:05', '2020-05-11T11:15:05+02:00'),"
        " ('1999-12-31 23:59:59', '2020-05-11T11:15:05.123Z'), "
        "('2000-02-29 00:00:00', '2021-01-01T00:00:00-08:00')) t(s, i)"),
    "clock_types": ("SELECT typeof(current_date), typeof(now()), "
                    "typeof(current_time), typeof(localtimestamp), "
                    "typeof(current_timestamp), typeof(localtime)"),
    # scalar_sf10's lineitem query (chip_smoke.py) at tpch.tiny
    "scalar_lineitem": None,
}


@pytest.fixture(scope="module")
def runners():
    return TpuRunner(), LocalQueryRunner(device="cpu")


def _rows_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9)
            else:
                assert a == b and type(a) is type(b)
                if isinstance(b, datetime.datetime):
                    # the same instant shown in the same zone
                    assert a.utcoffset() == b.utcoffset()


@pytest.mark.parametrize("name", sorted(TIME_SQL))
def test_time_sql_matches_the_jax_engine(name, runners):
    from chip_smoke import SCALAR_LINEITEM_SQL
    sql = TIME_SQL[name] or SCALAR_LINEITEM_SQL.format(schema="tiny")
    want = runners[0].execute(sql)
    got = runners[1].execute(sql)
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    _rows_equal(got.rows, want.rows)


def test_time_sql_known_answers(runners):
    port = runners[1]
    q = lambda s: port.execute(s).rows   # noqa: E731
    assert q(TIME_SQL["time_literal_and_fields"]) == [
        [datetime.time(10, 30, 45), 10, 30, 45, 123]]
    assert q(TIME_SQL["date_format_parse"]) == [
        ["2020-03-01 10:30", "Tuesday", datetime.datetime(2020, 3, 1, 10,
                                                          30)]]
    assert q(TIME_SQL["date_parse_bad_input_null"]) == [
        [datetime.datetime(2020, 1, 2)], [None]]
    got = q(TIME_SQL["tstz_literal_and_display"])[0][0]
    assert got == datetime.datetime(2020, 6, 1, 10, 30, tzinfo=datetime.
                                    timezone(datetime.timedelta(hours=5.5)))
    assert got.utcoffset() == datetime.timedelta(hours=5.5)
    assert q(TIME_SQL["tstz_field_extraction"]) == [[23, 1, 23]]
    wt, iso = q(TIME_SQL["with_timezone_and_iso8601"])[0]
    assert wt.astimezone(datetime.timezone.utc).hour == 10
    assert iso == "2020-01-01T12:00:00.000+02:00"
    assert q(TIME_SQL["named_zone"])[0][0].utcoffset() == \
        datetime.timedelta(hours=-4)


def test_instant_keys_across_zones(runners):
    """GROUP BY, DISTINCT, JOIN and ORDER BY treat equal instants written
    in different zones as equal (the zone lane is payload); count(DISTINCT)
    too, where the JAX engine counts each zone apart (ROADMAP C)."""
    port = runners[1]
    v = ("(VALUES (TIMESTAMP '2020-01-01 12:00:00 +02:00', 1), "
         "(TIMESTAMP '2020-01-01 10:00:00 UTC', 2), "
         "(TIMESTAMP '2020-01-01 05:00:00 -05:00', 3), "
         "(TIMESTAMP '2020-01-01 15:30:00 Asia/Kolkata', 4), "
         "(TIMESTAMP '2020-01-01 11:00:00 UTC', 5))")
    q = lambda s: port.execute(s).rows   # noqa: E731
    assert q(f"SELECT count(*), count(DISTINCT t) FROM {v} x(t, k)") == \
        [[5, 2]]
    assert [r[1] for r in q(f"SELECT t, count(*) FROM {v} x(t, k) "
                            "GROUP BY t ORDER BY 2 DESC")] == [4, 1]
    assert len(q(f"SELECT DISTINCT t FROM {v} x(t, k)")) == 2
    pairs = q(f"SELECT a.k, b.k FROM {v} a(t, k) JOIN {v} b(t, k) "
              "ON a.t = b.t WHERE a.k < b.k ORDER BY 1, 2")
    assert pairs == [[1, 2], [1, 3], [1, 4], [2, 3], [2, 4], [3, 4]]
    # order by instant; equal instants keep their input order
    assert [r[0] for r in q(f"SELECT k FROM {v} x(t, k) ORDER BY t, k")] \
        == [1, 2, 3, 4, 5]
    assert q(f"SELECT count(*) FROM {v} a(t, k) WHERE t IN (SELECT t FROM "
             f"{v} b(t, k) WHERE k = 2)") == [[4]]


def _zone_offsets(zone, instants_ms):
    zi = ZoneInfo(zone)
    epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
    return [int((epoch + datetime.timedelta(milliseconds=int(v)))
                .astimezone(zi).utcoffset().total_seconds()) // 60
            for v in instants_ms]


@pytest.mark.parametrize("zone", ["America/Los_Angeles", "Europe/London",
                                  "Australia/Lord_Howe", "Asia/Kolkata",
                                  "America/Sao_Paulo", "Pacific/Apia"])
def test_zone_offsets_match_zoneinfo(zone):
    """The transition table and searchsorted of ops/timezone.py against
    zoneinfo per instant, over random instants from 1900 to 2100 and the
    instants either side of every transition of 1990-2030."""
    from trino_tpu_torch.ops import timezone as tz
    rng = np.random.default_rng(11)
    ms = rng.integers(-2_208_988_800_000, 4_102_444_800_000, 3000)
    starts, _ = tz.transitions(zone, 7305, 21915)
    edges = np.concatenate([starts[1:] - 1, starts[1:], starts[1:] + 1])
    ms = np.concatenate([ms, edges])
    got = tz.offsets_at(zone, torch.from_numpy(ms)).numpy()
    assert got.tolist() == _zone_offsets(zone, ms)


@pytest.mark.parametrize("zone", ["America/New_York", "Europe/Berlin",
                                  "Australia/Lord_Howe"])
def test_local_offsets_follow_java_time(zone):
    """A wall-clock time in a gap reads with the offset before it, in an
    overlap with the earlier offset: zoneinfo's fold=0, java.time's
    ZonedDateTime.of."""
    from trino_tpu_torch.ops import timezone as tz
    zi = ZoneInfo(zone)
    rng = np.random.default_rng(5)
    local = rng.integers(0, 2_000_000_000_000, 2000)
    starts, _ = tz.transitions(zone, 0, 23148)
    # every minute within two hours of each transition, as a local time
    near = (starts[1:, None] + np.arange(-120, 121)[None, :] * 60_000
            + 30_000).ravel()
    local = np.concatenate([local, near])
    got = tz.offsets_for_local(zone, torch.from_numpy(local)).numpy()
    epoch = datetime.datetime(1970, 1, 1)
    want = [int((epoch + datetime.timedelta(milliseconds=int(v)))
                .replace(tzinfo=zi).utcoffset().total_seconds()) // 60
            for v in local]
    assert got.tolist() == want


def test_with_timezone_at_dst_edges(runners):
    """with_timezone reads the wall-clock time in the zone as java.time
    does and shows the offset at the instant; the JAX engine takes the
    offset at the local time read as UTC, wrong for a few hours around
    each transition (ROADMAP C)."""
    port = runners[1]
    rows = port.execute(
        "SELECT with_timezone(ts, 'America/New_York') FROM (VALUES "
        "TIMESTAMP '2020-03-08 05:00:00', TIMESTAMP '2020-03-08 02:30:00', "
        "TIMESTAMP '2020-11-01 01:30:00', TIMESTAMP '2020-11-01 02:30:00', "
        "TIMESTAMP '2020-07-01 12:00:00') t(ts)").rows
    utc = datetime.timezone.utc
    want = [(2020, 3, 8, 9, 0, -4), (2020, 3, 8, 7, 30, -4),
            (2020, 11, 1, 5, 30, -4), (2020, 11, 1, 7, 30, -5),
            (2020, 7, 1, 16, 0, -4)]
    for (got,), (y, m, d, h, mi, off) in zip(rows, want):
        assert got == datetime.datetime(y, m, d, h, mi, tzinfo=utc)
        assert got.utcoffset() == datetime.timedelta(hours=off)


def test_zoned_values_keep_their_offset(runners):
    """date_trunc, date_add and interval arithmetic over a zoned value
    work on its wall-clock time and keep its offset (the JAX engine
    raises); date_format reads the wall-clock time (the JAX engine
    formats UTC)."""
    port = runners[1]
    got = port.execute(
        "SELECT date_trunc('quarter', CAST(DATE '2020-05-17' AS TIMESTAMP) "
        "AT TIME ZONE 'Asia/Kolkata'), date_format(TIMESTAMP "
        "'2020-01-01 23:30:00 -05:00', '%Y-%m-%d %H'), "
        "TIMESTAMP '2020-01-31 23:30:00 -05:00' + INTERVAL '1' MONTH, "
        "TIMESTAMP '2020-01-01 23:30:00 -05:00' + INTERVAL '1' DAY, "
        "date_add('month', 1, TIMESTAMP '2020-01-31 23:30:00 -05:00')"
    ).rows
    ist = datetime.timezone(datetime.timedelta(hours=5, minutes=30))
    est = datetime.timezone(datetime.timedelta(hours=-5))
    assert got == [[datetime.datetime(2020, 4, 1, tzinfo=ist),
                    "2020-01-01 23",
                    datetime.datetime(2020, 2, 29, 23, 30, tzinfo=est),
                    datetime.datetime(2020, 1, 2, 23, 30, tzinfo=est),
                    datetime.datetime(2020, 2, 29, 23, 30, tzinfo=est)]]
    assert got[0][0].utcoffset() == ist.utcoffset(None)


def test_unknown_zone_raises(runners):
    from trino_tpu_torch.exec.executor import QueryError
    port = runners[1]
    for sql in ["SELECT TIMESTAMP '2020-01-01 00:00:00' AT TIME ZONE "
                "'Mars/Olympus'",
                "SELECT with_timezone(TIMESTAMP '2020-01-01 00:00:00', "
                "'Nowhere/Town')",
                "SELECT TIMESTAMP '2020-01-01 00:00:00' AT TIME ZONE "
                "'+5x'"]:
        with pytest.raises(QueryError, match="time zone"):
            port.execute(sql)


def test_scalar_sf10_queries_at_tiny():
    """chip_smoke.py's scalar_sf10 queries through the port at tpch.tiny,
    against the phase's own numpy references over the same generators
    (those the card run holds its sf10 rows to)."""
    import chip_smoke as cs
    from trino_tpu_torch.connectors import tpch, tpch_device
    want, _ = cs.scalar_references(tpch, tpch_device, "tiny",
                                   torch.device("cpu"))
    port = LocalQueryRunner(device="cpu")
    for name, sql in (("lineitem", cs.SCALAR_LINEITEM_SQL),
                      ("orders", cs.SCALAR_ORDERS_SQL),
                      ("customer", cs.SCALAR_CUSTOMER_SQL)):
        got = port.execute(sql.format(schema="tiny")).rows
        assert cs.scalar_rows_errors(got, want[name]) == [], name
        assert len(got) > 0


ZONED_ORDERS = (
    "SELECT o_orderkey, with_timezone(CAST(o_orderdate AS TIMESTAMP) + "
    "INTERVAL '7' HOUR, 'Europe/Berlin') t, CAST(o_orderdate AS TIMESTAMP) "
    "AT TIME ZONE 'America/New_York' u FROM orders WHERE o_orderkey < 3000")


def test_zoned_lanes_through_spill_union_and_window(monkeypatch):
    """A TIMESTAMP WITH TIME ZONE column keeps its zone lane through a
    spilled join, UNION, INTERSECT and a window partition, and compares by
    instant there: the spilled rows equal the unspilled, and INTERSECT
    and UNION of the same instants in two zones keep each instant once."""
    from trino_tpu_torch.config import CONFIG
    port = LocalQueryRunner(device="cpu")
    join = (f"SELECT a.o_orderkey, a.t, b.u FROM ({ZONED_ORDERS}) a JOIN "
            f"({ZONED_ORDERS}) b ON a.o_orderkey % 3 = b.o_orderkey % 3 "
            "WHERE a.o_orderkey < 200 ORDER BY 1, 2, 3")
    whole = port.execute(join)
    monkeypatch.setattr(CONFIG, "max_batch_rows", 4096)
    spilled = port.execute(join)
    assert spilled.spill_bytes > 0 and spilled.rows == whole.rows
    assert all(r[1].utcoffset() in (datetime.timedelta(hours=1),
                                    datetime.timedelta(hours=2))
               for r in whole.rows)
    monkeypatch.undo()
    q = lambda s: port.execute(s).rows   # noqa: E731
    n, nd = q(f"SELECT count(*), count(DISTINCT t) FROM ({ZONED_ORDERS}) "
              "x")[0]
    assert nd < n
    # the same instants, once in Berlin time and once in UTC
    both = (f"SELECT t FROM ({ZONED_ORDERS}) x {{op}} SELECT t AT TIME ZONE "
            f"'UTC' FROM ({ZONED_ORDERS}) y")
    assert q(f"SELECT count(*) FROM ({both.format(op='INTERSECT')}) z") \
        == [[nd]]
    assert q(f"SELECT count(*) FROM ({both.format(op='UNION')}) z") \
        == [[nd]]
    assert q(f"SELECT count(*) FROM ({both.format(op='UNION ALL')}) z") \
        == [[2 * n]]
    ranks = q(f"SELECT max(r) FROM (SELECT dense_rank() OVER (PARTITION "
              f"BY t ORDER BY z) r FROM (SELECT t, 1 z FROM "
              f"({ZONED_ORDERS}) x UNION ALL SELECT t AT TIME ZONE "
              f"'+09:00', 2 FROM "
              f"({ZONED_ORDERS}) y) w) v")
    assert ranks == [[2]]
