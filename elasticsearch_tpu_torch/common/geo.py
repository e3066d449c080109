"""Geo primitives (the port's copy of elasticsearch_tpu/common/geo.py):
point parsing, distances and their units, the geohash codec, shape
bounding boxes, and the elementwise predicates the geo queries and the
``_geo_distance`` sort compute.

The predicates (``haversine_meters``, ``bbox_contains``,
``points_in_polygon``) take ``xp``: ``numpy`` on the host (float64, as
the reference's host sort values), ``torch`` over the float32
``{field}.lat`` / ``{field}.lon`` doc-value columns on the device. The
torch branch keeps the reference's float32 arithmetic: the reference
runs them with ``xp=jax.numpy``, where a Python origin becomes a weakly
typed float32 array, so the origin's radians and cosine are float32 as
well (``_f32_scalar``), and a Python bound or polygon vertex meets a
float32 column rounded to float32. The geohash and geotile cells of the
grid aggregations are host numpy over the point columns, as integer
codes (``geohash_codes``, ``geotile_codes``) spelled as keys only for
the distinct cells.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import (IllegalArgumentException,
                                                   ParsingException)

EARTH_RADIUS_METERS = 6371008.7714  # mean earth radius

# distance units -> meters
_UNITS = {
    "mm": 0.001, "millimeters": 0.001,
    "cm": 0.01, "centimeters": 0.01,
    "m": 1.0, "meters": 1.0,
    "km": 1000.0, "kilometers": 1000.0,
    "in": 0.0254, "inch": 0.0254,
    "ft": 0.3048, "feet": 0.3048,
    "yd": 0.9144, "yards": 0.9144,
    "mi": 1609.344, "miles": 1609.344,
    "nmi": 1852.0, "NM": 1852.0, "nauticalmiles": 1852.0,
}

_DIST_RE = re.compile(
    r"^\s*([+-]?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)\s*([a-zA-Z]*)\s*$")


def parse_distance(value: Any) -> float:
    """"10km" / "5mi" / 1000 (meters by default) -> meters."""
    if isinstance(value, (int, float)):
        return float(value)
    m = _DIST_RE.match(str(value))
    if not m:
        raise ParsingException(f"failed to parse distance [{value}]")
    num, unit = float(m.group(1)), m.group(2) or "m"
    scale = _UNITS.get(unit)
    if scale is None:
        raise ParsingException(f"unknown distance unit [{unit}]")
    return num * scale


def meters_to_unit(meters: float, unit: str) -> float:
    scale = _UNITS.get(unit or "m")
    if scale is None:
        raise ParsingException(f"unknown distance unit [{unit}]")
    return meters / scale


# ---------------------------------------------------------------------------
# geohash (base32)
# ---------------------------------------------------------------------------

_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"
_BASE32_INV = {c: i for i, c in enumerate(_BASE32)}


def geohash_encode(lat: float, lon: float, precision: int = 12) -> str:
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    bits = []
    even = True
    while len(bits) < precision * 5:
        if even:
            mid = (lon_lo + lon_hi) / 2
            if lon >= mid:
                bits.append(1)
                lon_lo = mid
            else:
                bits.append(0)
                lon_hi = mid
        else:
            mid = (lat_lo + lat_hi) / 2
            if lat >= mid:
                bits.append(1)
                lat_lo = mid
            else:
                bits.append(0)
                lat_hi = mid
        even = not even
    out = []
    for i in range(precision):
        v = 0
        for b in bits[i * 5:(i + 1) * 5]:
            v = (v << 1) | b
        out.append(_BASE32[v])
    return "".join(out)


def geohash_decode(hash_: str) -> Tuple[float, float]:
    """Geohash -> (lat, lon) of the cell's center."""
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    even = True
    for c in hash_:
        v = _BASE32_INV.get(c)
        if v is None:
            raise ParsingException(
                f"unsupported symbol [{c}] in geohash [{hash_}]")
        for shift in range(4, -1, -1):
            bit = (v >> shift) & 1
            if even:
                mid = (lon_lo + lon_hi) / 2
                if bit:
                    lon_lo = mid
                else:
                    lon_hi = mid
            else:
                mid = (lat_lo + lat_hi) / 2
                if bit:
                    lat_lo = mid
                else:
                    lat_hi = mid
            even = not even
    return (lat_lo + lat_hi) / 2, (lon_lo + lon_hi) / 2


# ---------------------------------------------------------------------------
# grid cells of the geo aggregations (host numpy over the point columns)
# ---------------------------------------------------------------------------

def geohash_codes(lats: np.ndarray, lons: np.ndarray,
                  precision: int) -> np.ndarray:
    """int64 [n]: each point's geohash as its interleaved bits (lon
    first, 5 bits a character), the reference's quantization."""
    nbits = precision * 5
    lon_bits = (nbits + 1) // 2
    lat_bits = nbits // 2
    qlon = np.clip(((lons + 180.0) / 360.0 * (1 << lon_bits)).astype(np.int64),
                   0, (1 << lon_bits) - 1)
    qlat = np.clip(((lats + 90.0) / 180.0 * (1 << lat_bits)).astype(np.int64),
                   0, (1 << lat_bits) - 1)
    inter = np.zeros(len(lats), np.int64)
    for i in range(nbits):
        if i % 2 == 0:  # even global bit = lon
            src = (qlon >> (lon_bits - 1 - i // 2)) & 1
        else:
            src = (qlat >> (lat_bits - 1 - i // 2)) & 1
        inter = (inter << 1) | src
    return inter


def geohash_strings(codes: np.ndarray, precision: int) -> np.ndarray:
    """``U{precision}`` [n]: the base32 spelling of ``geohash_codes``."""
    shifts = (precision - 1 - np.arange(precision)) * 5
    idx = (np.asarray(codes, np.int64)[:, None] >> shifts[None, :]) & 31
    chars = np.ascontiguousarray(np.array(list(_BASE32))[idx])
    return chars.view(f"U{precision}").reshape(-1)


def geohash_cells(lats: np.ndarray, lons: np.ndarray,
                  precision: int) -> np.ndarray:
    """Each point's geohash cell, ``U{precision}`` [n]."""
    return geohash_strings(geohash_codes(lats, lons, precision), precision)


def geotile_codes(lats: np.ndarray, lons: np.ndarray,
                  zoom: int) -> np.ndarray:
    """int64 [n]: each point's web-mercator tile at ``zoom`` as
    ``x * 2^zoom + y``."""
    n = 1 << zoom
    x = np.clip(((lons + 180.0) / 360.0 * n).astype(np.int64), 0, n - 1)
    lat_r = np.radians(np.clip(lats, -85.05112878, 85.05112878))
    y = np.clip(((1.0 - np.log(np.tan(lat_r) + 1.0 / np.cos(lat_r)) / np.pi)
                 / 2.0 * n).astype(np.int64), 0, n - 1)
    return x * n + y


def geotile_strings(codes: np.ndarray, zoom: int) -> np.ndarray:
    """The ``"z/x/y"`` keys of ``geotile_codes``."""
    n = 1 << zoom
    return np.array([f"{zoom}/{int(c) // n}/{int(c) % n}" for c in codes])


def geotile_cells(lats: np.ndarray, lons: np.ndarray, zoom: int) -> np.ndarray:
    """Each point's web-mercator tile key ``"z/x/y"``."""
    return geotile_strings(geotile_codes(lats, lons, zoom), zoom)


# ---------------------------------------------------------------------------
# point parsing: an object, "lat,lon", [lon, lat], a geohash or WKT POINT
# ---------------------------------------------------------------------------

_WKT_POINT_RE = re.compile(
    r"^\s*POINT\s*\(\s*([+-]?\d+(?:\.\d+)?)\s+([+-]?\d+(?:\.\d+)?)\s*\)\s*$",
    re.IGNORECASE)


def parse_geo_point(value: Any) -> Tuple[float, float]:
    """Any accepted geo_point form -> (lat, lon)."""
    if isinstance(value, dict):
        if "lat" in value and "lon" in value:
            return _check(float(value["lat"]), float(value["lon"]))
        raise ParsingException(f"field [{value}] missing lat/lon")
    if isinstance(value, (list, tuple)):
        if len(value) != 2:
            raise ParsingException(
                f"geo_point array must have 2 values [lon, lat], got {value}")
        lon, lat = float(value[0]), float(value[1])   # GeoJSON order
        return _check(lat, lon)
    if isinstance(value, str):
        m = _WKT_POINT_RE.match(value)
        if m:
            return _check(float(m.group(2)), float(m.group(1)))
        if "," in value:
            parts = value.split(",")
            if len(parts) != 2:
                raise ParsingException(f"failed to parse geo_point [{value}]")
            return _check(float(parts[0]), float(parts[1]))
        return _check(*geohash_decode(value.strip()))
    raise ParsingException(f"failed to parse geo_point [{value!r}]")


def _check(lat: float, lon: float) -> Tuple[float, float]:
    if not (-90.0 <= lat <= 90.0):
        raise IllegalArgumentException(f"illegal latitude value [{lat}]")
    if not (-180.0 <= lon <= 180.0):
        raise IllegalArgumentException(f"illegal longitude value [{lon}]")
    return lat, lon


def is_point_value(value: Any) -> bool:
    """One point, not an array of points (an array of two numbers is one
    [lon, lat] point)."""
    if isinstance(value, (dict, str)):
        return True
    if isinstance(value, (list, tuple)):
        return (len(value) == 2
                and all(isinstance(v, (int, float))
                        and not isinstance(v, bool) for v in value))
    return False


# ---------------------------------------------------------------------------
# elementwise predicates: xp = numpy (host) or torch (device columns)
# ---------------------------------------------------------------------------

def _f32_scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a float32 0-d tensor on ``like``'s device (the
    reference's weakly typed float32 jnp scalar); a tensor as itself."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def haversine_meters(lat1, lon1, lat2, lon2, xp=np):
    """Great-circle distance in meters, elementwise. With ``xp=torch``
    ``lat1``/``lon1`` are float32 tensors and the origin is computed in
    float32 on their device, as the reference's jnp program computes
    it."""
    if xp is torch:
        lat2 = _f32_scalar(lat2, lat1)
        lon2 = _f32_scalar(lon2, lat1)
        p1 = torch.deg2rad(lat1)
        p2 = torch.deg2rad(lat2)
        dp = p2 - p1
        dl = torch.deg2rad(lon2) - torch.deg2rad(lon1)
        a = (torch.sin(dp / 2.0) ** 2
             + torch.cos(p1) * torch.cos(p2) * torch.sin(dl / 2.0) ** 2)
        return 2.0 * EARTH_RADIUS_METERS * torch.arcsin(
            torch.sqrt(torch.clamp(a, 0.0, 1.0)))
    p1 = np.radians(lat1)
    p2 = np.radians(lat2)
    dp = p2 - p1
    dl = np.radians(lon2) - np.radians(lon1)
    a = np.sin(dp / 2.0) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2.0) ** 2
    return 2.0 * EARTH_RADIUS_METERS * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def bbox_contains(lats, lons, top: float, left: float, bottom: float,
                  right: float, xp=np):
    """Mask of the points inside the box; a box with left > right
    crosses the antimeridian. The bounds compare with the columns in the
    columns' dtype (float32 on the device)."""
    lat_ok = (lats <= top) & (lats >= bottom)
    if left <= right:
        lon_ok = (lons >= left) & (lons <= right)
    else:   # crosses the antimeridian
        lon_ok = (lons >= left) | (lons <= right)
    return lat_ok & lon_ok


def points_in_polygon(lats, lons, poly_lats: Sequence[float],
                      poly_lons: Sequence[float], xp=np):
    """Even-odd point-in-polygon, elementwise over the points: a few
    elementwise passes per edge. On a horizontal edge the reference's
    guard ``denom = 1e-300`` is 0.0 in float32, so ``x_int`` is inf or
    NaN there; ``crosses`` is false on such an edge and the ``where``
    keeps ``inside``. The torch branch divides by a float32 0-d tensor
    (a CUDA division by a host scalar would multiply by its
    reciprocal)."""
    n = len(poly_lats)
    if xp is torch:
        inside = torch.zeros(lats.shape, dtype=torch.bool,
                             device=lats.device)
    else:
        inside = np.zeros(lats.shape, bool)
    j = n - 1
    for i in range(n):
        yi, xi = poly_lats[i], poly_lons[i]
        yj, xj = poly_lats[j], poly_lons[j]
        crosses = (yi > lats) != (yj > lats)
        denom = yj - yi
        denom = denom if denom != 0 else 1e-300
        if xp is torch:
            denom = _f32_scalar(denom, lats)
        x_int = (xj - xi) * (lats - yi) / denom + xi
        inside = xp.where(crosses & (lons < x_int), ~inside, inside)
        j = i
    return inside


# ---------------------------------------------------------------------------
# geo_shape geometry: bounding boxes and their relations
# ---------------------------------------------------------------------------

def shape_bbox(shape: Dict[str, Any]) -> Tuple[float, float, float, float]:
    """A GeoJSON shape (or an envelope) -> (min_lat, min_lon, max_lat,
    max_lon)."""
    typ = str(shape.get("type", "")).lower()
    coords = shape.get("coordinates")
    if typ == "point":
        lon, lat = float(coords[0]), float(coords[1])
        return lat, lon, lat, lon
    if typ == "envelope":
        # [[minLon, maxLat], [maxLon, minLat]]
        (l, t), (r, b) = coords
        return float(b), float(l), float(t), float(r)
    if typ in ("linestring", "multipoint"):
        pts = coords
    elif typ in ("polygon", "multilinestring"):
        pts = [p for ring in coords for p in ring]
    elif typ == "multipolygon":
        pts = [p for poly in coords for ring in poly for p in ring]
    elif typ == "geometrycollection":
        boxes = [shape_bbox(g) for g in shape.get("geometries", [])]
        return (min(b[0] for b in boxes), min(b[1] for b in boxes),
                max(b[2] for b in boxes), max(b[3] for b in boxes))
    else:
        raise ParsingException(f"unknown geo_shape type [{typ}]")
    lons = [float(p[0]) for p in pts]
    lats = [float(p[1]) for p in pts]
    return min(lats), min(lons), max(lats), max(lons)


def bbox_relate(a: Tuple[float, float, float, float],
                b: Tuple[float, float, float, float]) -> str:
    """Relation of box a to box b: 'disjoint', 'within' (a inside b),
    'contains' or 'intersects'."""
    a_minlat, a_minlon, a_maxlat, a_maxlon = a
    b_minlat, b_minlon, b_maxlat, b_maxlon = b
    if (a_maxlat < b_minlat or a_minlat > b_maxlat
            or a_maxlon < b_minlon or a_minlon > b_maxlon):
        return "disjoint"
    if (a_minlat >= b_minlat and a_maxlat <= b_maxlat
            and a_minlon >= b_minlon and a_maxlon <= b_maxlon):
        return "within"
    if (b_minlat >= a_minlat and b_maxlat <= a_maxlat
            and b_minlon >= a_minlon and b_maxlon <= a_maxlon):
        return "contains"
    return "intersects"

