"""The PyTorch engine's geometry functions against the JAX engine's, on
the CPU.

Every SQL case of tests/test_geospatial.py runs through both engines.
Then a seeded table of 20,000 points, many of them exactly on polygon
edges and vertices, goes against polygons with holes: ST_Contains must
give exactly the JAX engine's booleans and a numpy ray cast's (each step
a separate IEEE operation), the distances within rel 1e-9.
"""

import math

import numpy as np
import pytest

from trino_tpu.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.testing import TestingConnector
from trino_tpu_torch.types import BIGINT, DOUBLE

CPU = "cpu"
REL = 1e-9


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner(device=CPU)


@pytest.fixture(scope="module")
def jax():
    return JaxRunner()


def _same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert float(a) == pytest.approx(b, rel=REL)
            elif isinstance(a, float) or type(b).__name__ == "Decimal":
                assert float(a) == float(b)
            else:
                assert a == b


# tests/test_geospatial.py, case by case
GEO_SQL = {
    "point_accessors": "SELECT ST_X(ST_Point(1.5, 2.5)), "
                       "ST_Y(ST_Point(1.5, 2.5))",
    "distance": "SELECT ST_Distance(ST_Point(0.0, 0.0), "
                "ST_Point(3.0, 4.0))",
    "wkt_roundtrip": "SELECT ST_AsText(ST_Point(1.0, -2.5)), "
                     "ST_X(ST_GeometryFromText('POINT (7 8)')), "
                     "ST_Y(ST_GeometryFromText('POINT (7 8)'))",
    "contains_vectorized_over_table": (
        "SELECT x, ST_Contains(ST_GeometryFromText("
        "'POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))'), "
        "ST_Point(x, y)) FROM (VALUES (5.0, 5.0), (15.0, 5.0), "
        "(-1.0, 2.0), (9.9, 9.9)) t(x, y) ORDER BY x"),
    "contains_multiple_polygons": (
        "SELECT ST_Contains(ST_GeometryFromText(p), ST_Point(1.0, 1.0)) "
        "FROM (VALUES ('POLYGON ((0 0, 2 0, 2 2, 0 2, 0 0))'), "
        "('POLYGON ((5 5, 6 5, 6 6, 5 6, 5 5))')) t(p)"),
    "great_circle_distance": (
        "SELECT great_circle_distance(36.12, -86.67, 33.94, -118.40)"),
    "point_in_where_clause": (
        "SELECT count(*) FROM (VALUES (1.0, 1.0), (3.0, 3.0), "
        "(9.0, 9.0)) t(x, y) WHERE ST_Distance(ST_Point(x, y), "
        "ST_Point(0.0, 0.0)) < 5.0"),
    "contains_donut_polygon_hole_excluded": (
        "SELECT x, ST_Contains(ST_GeometryFromText('POLYGON ((0 0, 10 0, "
        "10 10, 0 10, 0 0), (4 4, 6 4, 6 6, 4 6, 4 4))'), "
        "ST_Point(x, y)) FROM (VALUES (5.0, 5.0), (2.0, 5.0), (4.5, 4.5), "
        "(11.0, 5.0), (6.5, 5.0)) t(x, y) ORDER BY x"),
    "contains_multiple_holes": (
        "SELECT ST_Contains(ST_GeometryFromText('POLYGON ((0 0, 12 0, "
        "12 4, 0 4, 0 0), (1 1, 3 1, 3 3, 1 3, 1 1), (8 1, 10 1, 10 3, "
        "8 3, 8 1))'), ST_Point(x, y)) FROM (VALUES (2.0, 2.0), "
        "(9.0, 2.0), (5.0, 2.0)) t(x, y)"),
    "contains_single_ring_unchanged": (
        "SELECT ST_Contains(ST_GeometryFromText("
        "'POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0))'), ST_Point(x, x)) "
        "FROM (VALUES 2.0, 5.0) t(x)"),
}

EXPECT = {
    "point_accessors": [[1.5, 2.5]],
    "distance": [[5.0]],
    "wkt_roundtrip": [["POINT (1 -2.5)", 7.0, 8.0]],
    "contains_multiple_polygons": [[True], [False]],
    "point_in_where_clause": [[2]],
    "contains_multiple_holes": [[False], [False], [True]],
    "contains_single_ring_unchanged": [[True], [False]],
}


@pytest.mark.parametrize("name", sorted(GEO_SQL))
def test_geospatial_sql_equals_the_jax_engine(port, jax, name):
    got = port.execute(GEO_SQL[name]).rows
    _same(got, jax.execute(GEO_SQL[name]).rows)
    if name in EXPECT:
        assert got == EXPECT[name]
    if name == "great_circle_distance":
        # the reference's documented example: BNA -> LAX ~2886.45 km
        assert got[0][0] == pytest.approx(2886.45, abs=0.5)
    if name == "contains_donut_polygon_hole_excluded":
        assert [[float(x), c] for x, c in got] == [
            [2.0, True], [4.5, False], [5.0, False], [6.5, True],
            [11.0, False]]


def test_geometry_columns_render_and_concat(port, jax):
    """A geometry column in both forms (points and WKT shapes) renders
    as WKT and goes through UNION ALL, ORDER BY and a filter."""
    sql = ("SELECT g FROM (SELECT ST_Point(x, y) AS g, x FROM (VALUES "
           "(1.5, -2.0), (0.0, 3.0)) t(x, y) UNION ALL SELECT "
           "ST_GeometryFromText('POLYGON ((0 0, 1 0, 1 1, 0 0))'), 9.0) "
           "u WHERE x > 0 ORDER BY x")
    assert port.execute(sql).rows == [["POINT (1.5 -2)"],
                                      ["POLYGON ((0 0, 1 0, 1 1, 0 0))"]]
    sql = ("SELECT ST_AsText(ST_Point(x, y)), count(*) FROM (VALUES "
           "(1.0, 2.0), (1.0, 2.0), (0.5, -0.25), (-0.0, 0.0), (0.0, 0.0)) "
           "t(x, y) GROUP BY 1 ORDER BY 1")
    got = port.execute(sql).rows
    assert got == jax.execute(sql).rows
    assert got == [["POINT (0 0)", 2], ["POINT (0.5 -0.25)", 1],
                   ["POINT (1 2)", 2]]


# --------------------------------------------------------------------------
# a seeded table of points against polygons with holes
# --------------------------------------------------------------------------

POLYGONS = [
    # a square with a square hole
    "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (4 4, 6 4, 6 6, 4 6, 4 4))",
    # slanted edges (exact on the points (2t, t)) and a triangular hole
    "POLYGON ((0 0, 10 5, 4 12, -3 6, 0 0), (1 5, 3 5, 2 7, 1 5))",
    # a star with ten edges (geo_sf10's AIR polygon)
    "POLYGON ((25 2, 30 18, 48 20, 34 30, 40 48, 25 37, 10 48, 16 30, "
    "2 20, 20 18, 25 2))",
    # a frame with two holes (geo_sf10's MAIL polygon, two holes)
    "POLYGON ((5 5, 45 5, 45 45, 5 45, 5 5), (15 15, 35 15, 35 35, 15 35, "
    "15 15), (38 38, 42 38, 42 42, 38 42, 38 38))",
]
NPTS = 20_000


def _points(seed: int = 17):
    """Random points, a quarter of them on the polygons' vertices, a
    quarter exactly on their edges (integer grids on the axis-parallel
    edges, (2t, t) on the slanted ones), the rest anywhere."""
    rng = np.random.default_rng(seed)
    q = NPTS // 4
    xs = rng.uniform(-5, 50, NPTS)
    ys = rng.uniform(-5, 50, NPTS)
    verts = []
    for wkt in POLYGONS:
        body = wkt[wkt.index("(") + 1:wkt.rindex(")")]
        for ring in body.replace("(", "").split(")"):
            for pair in ring.strip(", ").split(","):
                if pair.strip():
                    verts.append([float(v) for v in pair.split()])
    verts = np.asarray(verts)
    pick = rng.integers(0, len(verts), q)
    xs[:q], ys[:q] = verts[pick, 0], verts[pick, 1]
    t = rng.integers(0, 6, q).astype(np.float64)
    edge = rng.integers(0, 4, q)
    xs[q:2 * q] = np.select([edge == 0, edge == 1, edge == 2],
                            [2 * t, rng.integers(0, 11, q), 4 + t % 3],
                            15 + rng.integers(0, 21, q))
    ys[q:2 * q] = np.select([edge == 0, edge == 1, edge == 2],
                            [t, 0.0 + 10 * (t > 2), 4 + t % 3],
                            15.0 + 20 * (t > 2))
    return xs, ys


def _ray_cast_np(px, py, wkt):
    """chip_smoke.py's numpy ray cast: each step one IEEE operation."""
    import chip_smoke
    return chip_smoke.ray_cast_np(px, py, wkt)


@pytest.fixture(scope="module")
def points_tables(jax):
    xs, ys = _points()
    data = {"id": list(range(NPTS)), "x": xs.tolist(), "y": ys.tolist()}
    conn = TestingConnector(device=CPU)
    conn.add_table("pts", {"id": BIGINT, "x": DOUBLE, "y": DOUBLE},
                   [dict(zip(data, r)) for r in zip(*data.values())])
    port = LocalQueryRunner(device=CPU)
    port.catalogs.register("g", conn)
    from trino_tpu import types as jt
    from trino_tpu.testing import TestingConnector as JaxTesting
    jconn = JaxTesting()
    jconn.add_table("pts", {"id": jt.BIGINT, "x": jt.DOUBLE,
                            "y": jt.DOUBLE},
                    [dict(zip(data, r)) for r in zip(*data.values())])
    jax.catalogs.register("g", jconn)
    return port, jax, xs, ys


@pytest.mark.parametrize("i", range(len(POLYGONS)))
def test_contains_exact_on_edges_and_vertices(points_tables, i):
    port, jax, xs, ys = points_tables
    sql = (f"SELECT id, ST_Contains(ST_GeometryFromText('{POLYGONS[i]}'), "
           "ST_Point(x, y)) FROM g.default.pts ORDER BY id")
    got = [c for _, c in port.execute(sql).rows]
    assert got == [c for _, c in jax.execute(sql).rows]
    assert got == _ray_cast_np(xs, ys, POLYGONS[i]).tolist()


def test_contains_picks_each_rows_polygon(points_tables):
    """One dictionary of polygons chosen per row by CASE: every row gets
    its own polygon's verdict."""
    port, jax, xs, ys = points_tables
    case = " ".join(f"WHEN {k} THEN '{p}'" for k, p in enumerate(POLYGONS))
    sql = (f"SELECT id, ST_Contains(ST_GeometryFromText(CASE id % "
           f"{len(POLYGONS)} {case} END), ST_Point(x, y)) "
           "FROM g.default.pts ORDER BY id")
    got = [c for _, c in port.execute(sql).rows]
    assert got == [c for _, c in jax.execute(sql).rows]
    want = np.zeros(NPTS, bool)
    ids = np.arange(NPTS)
    for k, p in enumerate(POLYGONS):
        sel = ids % len(POLYGONS) == k
        want[sel] = _ray_cast_np(xs, ys, p)[sel]
    assert got == want.tolist()


def test_distances_within_rel(points_tables):
    port, jax, xs, ys = points_tables
    sql = ("SELECT id, ST_Distance(ST_Point(x, y), ST_Point(3.5, 2.25)), "
           "great_circle_distance(y, x, 40.64, -73.78), "
           "ST_X(ST_Point(x, y)), ST_Y(ST_Point(x, y)) "
           "FROM g.default.pts ORDER BY id")
    got = port.execute(sql).rows
    _same(got, jax.execute(sql).rows)
    d = np.sqrt((xs - 3.5) ** 2 + (ys - 2.25) ** 2)
    assert [r[1] for r in got] == pytest.approx(d.tolist(), rel=REL)
    assert [r[3] for r in got] == xs.tolist()


def test_geo_grouped_query_equals_the_jax_engine(port, jax):
    """geo_sf10's query at tpch.tiny (chip_smoke.py) through both
    engines."""
    import chip_smoke
    sql = chip_smoke.GEO_SQL.replace("FROM lineitem",
                                     "FROM tpch.tiny.lineitem")
    got = port.execute(sql + " ORDER BY 1, 2").rows
    want = jax.execute(sql + " ORDER BY 1, 2").rows
    _same(got, want)
    assert sum(r[2] for r in got) == 19_676


def test_geo_sf10_reference_at_tiny(port):
    """chip_smoke.py's numpy reference of geo_sf10 equals the port's rows
    at tpch.tiny: the count exactly, the sums within rel 1e-9."""
    import torch

    import chip_smoke
    from trino_tpu_torch.connectors import tpch as tpch_mod
    from trino_tpu_torch.connectors import tpch_device as device_mod
    lanes, dicts, n = chip_smoke.geo_lanes(tpch_mod, device_mod, "tiny",
                                           torch.device("cpu"))
    want = chip_smoke.geo_reference(lanes, dicts)
    sql = chip_smoke.GEO_SQL.replace("FROM lineitem",
                                     "FROM tpch.tiny.lineitem")
    got = port.execute(sql + " ORDER BY 1, 2").rows
    assert chip_smoke.geo_rows_errors(got, want) == []
    assert not any(math.isnan(r[3]) for r in got)


@pytest.mark.parametrize("form", ["points", "wkt"])
def test_geometry_columns_through_filter_join_and_spill(port, jax, form,
                                                        monkeypatch):
    """A geometry column of either form made below a join goes through
    the filter's compaction, the join's gather and, with
    ``max_batch_rows`` lowered, the join's host spill: the rows equal the
    unspilled run's and the JAX engine's."""
    from trino_tpu_torch.config import CONFIG
    shape = ("ST_Point(o_totalprice / 1000, o_custkey % 100)"
             if form == "points" else
             "ST_GeometryFromText(CASE WHEN o_orderkey % 2 = 0 THEN "
             "'POLYGON ((0 0, 50 0, 50 50, 0 50, 0 0))' ELSE "
             "'POLYGON ((0 0, 200 0, 200 200, 0 200, 0 0))' END)")
    probe = ("ST_Contains(g, ST_Point(l_quantity, l_discount * 100))"
             if form == "wkt" else
             "ST_Distance(g, ST_Point(l_quantity, l_discount * 100)) < 60")
    sql = (f"SELECT count(*), count_if({probe}), "
           "min(ST_AsText(g)), max(ST_AsText(g)) FROM (SELECT o_orderkey, "
           f"{shape} AS g FROM orders WHERE o_orderkey < 3000) o "
           "JOIN lineitem ON l_orderkey = o_orderkey")
    whole = port.execute(sql)
    assert whole.spill_bytes == 0
    monkeypatch.setattr(CONFIG, "max_batch_rows", 1024)
    spilled = port.execute(sql)
    assert spilled.spill_bytes > 0
    assert spilled.rows == whole.rows
    _same(whole.rows, jax.execute(sql).rows)
