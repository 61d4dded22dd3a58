"""Geospatial functions over geometry columns on the device.

Counterpart of ``trino_tpu/ops/geo.py`` (ST_Point, ST_X/ST_Y,
ST_Distance, ST_Contains, ST_GeometryFromText/ST_AsText,
great_circle_distance), with the same two forms of a GEOMETRY column:

- a POINT column is two float64 lanes, x in ``data`` and y in ``data2``;
- any other shape is dictionary-coded WKT text (int32 codes), parsed
  once per distinct dictionary value on the host.

Every per-row step is torch ops over whole lanes. The ray cast of
``st_contains`` keeps each arithmetic step a separate op, and divides by
a 0-d tensor (a division by a python float may be a reciprocal multiply
on the card), so its verdicts equal numpy's IEEE steps bit for bit,
points on edges and vertices included. ``as_text`` formats each
distinct point once (``torch.unique`` over the pair).
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..columnar import Column, StringDictionary, take_clamped
from ..types import BOOLEAN, DOUBLE, GEOMETRY, VARCHAR, is_string

EARTH_RADIUS_KM = 6371.01
_F64 = torch.float64


def _merge_valid(*cols: Column) -> Optional[torch.Tensor]:
    valid = None
    for c in cols:
        if c.valid is not None:
            valid = c.valid if valid is None else (valid & c.valid)
    return valid


def point_column(x: Column, y: Column) -> Column:
    return Column(GEOMETRY, x.data.to(_F64), _merge_valid(x, y),
                  data2=y.data.to(_F64))


def _require_points(c: Column, what: str):
    if c.data2 is None or c.dictionary is not None:
        raise ValueError(
            f"{what} supports POINT geometries on this path "
            "(non-point shapes are WKT-backed)")


def _table(values, device, dtype=_F64) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values), dtype=dtype, device=device)


def _wkt_point_lanes(c: Column):
    """(x, y, ok) lanes for a WKT-backed geometry column: each distinct
    dictionary value parses once; rows referencing non-POINT values get
    ok=False (NULL downstream) instead of poisoning the whole column —
    a filtered column legitimately keeps dead dictionary values."""
    vals = c.dictionary.values
    xs = np.zeros(max(len(vals), 1))
    ys = np.zeros(max(len(vals), 1))
    ok = np.zeros(max(len(vals), 1), bool)
    for i, v in enumerate(vals):
        m = _POINT_RE.match(str(v))
        if m is not None:
            xs[i], ys[i], ok[i] = (float(m.group(1)),
                                   float(m.group(2)), True)
    dev = c.device
    return (take_clamped(_table(xs, dev), c.data),
            take_clamped(_table(ys, dev), c.data),
            take_clamped(_table(ok, dev, torch.bool), c.data))


def _xy(c: Column, what: str):
    """(x, y, valid) from either representation."""
    if c.dictionary is not None:
        x, y, ok = _wkt_point_lanes(c)
        valid = ok if c.valid is None else (c.valid & ok)
        return x, y, valid
    _require_points(c, what)
    return c.data, c.data2, c.valid


def st_x(c: Column) -> Column:
    x, _y, valid = _xy(c, "ST_X")
    return Column(DOUBLE, x, valid)


def st_y(c: Column) -> Column:
    _x, y, valid = _xy(c, "ST_Y")
    return Column(DOUBLE, y, valid)


def st_distance(a: Column, b: Column) -> Column:
    """Euclidean point distance (the reference's planar ST_Distance)."""
    ax, ay, av = _xy(a, "ST_Distance")
    bx, by, bv = _xy(b, "ST_Distance")
    dx = ax - bx
    dy = ay - by
    valid = av if bv is None else (bv if av is None else av & bv)
    return Column(DOUBLE, torch.sqrt(dx * dx + dy * dy), valid)


def great_circle_distance(lat1: Column, lon1: Column, lat2: Column,
                          lon2: Column) -> Column:
    """Haversine distance in km (reference GeoFunctions
    great_circle_distance)."""
    rad = math.pi / 180
    p1, l1, p2, l2 = [c.data.to(_F64) * rad
                      for c in (lat1, lon1, lat2, lon2)]
    dphi = p2 - p1
    dlmb = l2 - l1
    h = (torch.sin(dphi / 2) ** 2
         + torch.cos(p1) * torch.cos(p2) * torch.sin(dlmb / 2) ** 2)
    d = 2 * EARTH_RADIUS_KM * torch.asin(torch.sqrt(torch.clamp(h, 0.0,
                                                                1.0)))
    return Column(DOUBLE, d, _merge_valid(lat1, lon1, lat2, lon2))


# --------------------------------------------------------------------------
# WKT in/out
# --------------------------------------------------------------------------

_POINT_RE = re.compile(
    r"\s*POINT\s*\(\s*([-+0-9.eE]+)\s+([-+0-9.eE]+)\s*\)\s*\Z",
    re.IGNORECASE)


def geometry_from_text(c: Column) -> Column:
    """WKT varchar -> geometry. POINT text becomes (x, y) lanes;
    any other shape stays dictionary-coded WKT (parsed lazily by the
    consuming function)."""
    if not is_string(c.type) or c.dictionary is None:
        raise ValueError("ST_GeometryFromText expects varchar WKT")
    vals = c.dictionary.values
    xs, ys, all_points = [], [], True
    for v in vals:
        m = _POINT_RE.match(str(v))
        if m is None:
            all_points = False
            break
        xs.append(float(m.group(1)))
        ys.append(float(m.group(2)))
    if all_points and len(vals):
        return Column(GEOMETRY, take_clamped(_table(xs, c.device), c.data),
                      c.valid,
                      data2=take_clamped(_table(ys, c.device), c.data))
    return Column(GEOMETRY, c.data, c.valid, c.dictionary)


def as_text(c: Column) -> Column:
    if c.dictionary is not None:      # WKT-backed shape: passthrough
        return Column(VARCHAR, c.data, c.valid, c.dictionary)
    _require_points(c, "ST_AsText")
    from ..formats.lanes import first_appearance
    pairs, inv = torch.unique(torch.stack([c.data, c.data2], dim=1),
                              dim=0, return_inverse=True)
    codes, first = first_appearance(inv)
    xy = pairs[inv[first]].cpu().numpy()
    texts = [point_text(x, y) for x, y in xy]
    # -0.0 and 0.0 format alike: one dictionary value for both
    d, remap = StringDictionary.from_strings(texts)
    codes = take_clamped(torch.from_numpy(remap).to(c.device), codes)
    return Column(VARCHAR, codes.to(torch.int32), c.valid, d)


def point_text(x: float, y: float) -> str:
    return f"POINT ({_fmt(x)} {_fmt(y)})"


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def as_wkt(c: Column) -> Column:
    """A GEOMETRY column in the WKT form (a POINT column formatted), to
    concatenate with WKT-backed parts."""
    if c.dictionary is not None:
        return c
    t = as_text(c)
    return Column(GEOMETRY, t.data, t.valid, t.dictionary)


# --------------------------------------------------------------------------
# polygon containment
# --------------------------------------------------------------------------

_POLY_RE = re.compile(
    r"\s*POLYGON\s*\((?P<rings>.*)\)\s*\Z", re.IGNORECASE | re.DOTALL)
_RING_RE = re.compile(r"\(([^()]*)\)")


def parse_polygon(wkt: str) -> List[Tuple[np.ndarray, np.ndarray]]:
    """ALL rings of a POLYGON — shell first, then interior rings
    (holes). The even-odd rule over the union of every ring's edges
    makes holes fall out: a point inside a hole crosses both the shell
    and the hole boundary an odd number of times each, XORing back to
    outside."""
    m = _POLY_RE.match(wkt)
    if m is None:
        raise ValueError(f"unsupported geometry for ST_Contains: "
                         f"{wkt[:40]!r}")
    rings: List[Tuple[np.ndarray, np.ndarray]] = []
    for ring in _RING_RE.findall(m.group("rings")):
        pts = []
        for pair in ring.split(","):
            xy = pair.split()
            pts.append((float(xy[0]), float(xy[1])))
        if len(pts) < 3:
            raise ValueError(
                f"degenerate polygon ring in: {wkt[:40]!r}")
        arr = np.asarray(pts, dtype=np.float64)
        rings.append((arr[:, 0], arr[:, 1]))
    if not rings:
        raise ValueError(f"unsupported geometry for ST_Contains: "
                         f"{wkt[:40]!r}")
    return rings


def _ray_cast(px: torch.Tensor, py: torch.Tensor, xs: np.ndarray,
              ys: np.ndarray) -> torch.Tensor:
    """Even-odd rule, one pass per polygon edge over all rows at once:
    ``px < (xj - xi) * (py - yi) / (yj - yi) + xi``, each step its own
    IEEE operation."""
    inside = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
    for i in range(len(xs) - 1):
        xi, yi, xj, yj = (float(xs[i]), float(ys[i]), float(xs[i + 1]),
                          float(ys[i + 1]))
        if yi == yj:
            continue
        run = torch.tensor(yj - yi, dtype=_F64, device=px.device)
        edge_x = (py - yi).mul_(xj - xi).div_(run).add_(xi)
        crosses = ((py < yi) != (py < yj)) & (px < edge_x)
        inside ^= crosses
    return inside


def st_contains(shape: Column, points: Column) -> Column:
    """Polygon-contains-point, polygons dictionary-coded WKT: each
    DISTINCT polygon parses once and masks every row; rows pick their
    polygon's verdict by dictionary code."""
    _require_points(points, "ST_Contains (point argument)")
    if shape.dictionary is None:
        raise ValueError(
            "ST_Contains expects a WKT-backed shape (POLYGON) as the "
            "first argument")
    px, py = points.data, points.data2
    dev = px.device
    masks = []
    parse_ok = []
    for wkt in shape.dictionary.values:
        # an unparseable dictionary value NULLs only the rows that
        # reference it — a filter legitimately strands dead values in
        # the dictionary
        try:
            rings = parse_polygon(str(wkt))
        except ValueError:
            masks.append(torch.zeros(px.shape, dtype=torch.bool,
                                     device=dev))
            parse_ok.append(False)
            continue
        mask = torch.zeros(px.shape, dtype=torch.bool, device=dev)
        for xs, ys in rings:
            mask ^= _ray_cast(px, py, xs, ys)
        masks.append(mask)
        parse_ok.append(True)
    codes = shape.data.to(torch.int64).clamp(0, max(len(masks) - 1, 0))
    if len(masks) == 1:
        data = masks[0]
    else:
        data = torch.gather(torch.stack(masks), 0, codes[None, :])[0]
    valid = _merge_valid(shape, points)
    if not all(parse_ok):
        ok = take_clamped(_table(parse_ok, dev, torch.bool), codes)
        valid = ok if valid is None else valid & ok
    return Column(BOOLEAN, data, valid)
