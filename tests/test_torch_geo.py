"""The port's geo layer against the reference's, on the CPU.

- ``common/geo.py`` (the port's copy): the point forms, distance units,
  the geohash codec, shape boxes and their relations equal the
  reference's; the float32 masks (``haversine_meters``,
  ``bbox_contains``, ``points_in_polygon`` with ``xp=torch``) against
  the reference's ``xp=jax.numpy`` on seeded points.
- The reference's tests/test_geo.py, its 19 non-aggregation cases: the
  same documents through both packages' mappers and SegmentWriters, the
  same query bodies through both (``SegmentContext`` level), and the
  ``_geo_distance`` sort and its ``search_after`` through both
  ``ShardSearcher``s.
- A seeded cloud of clustered points, built by the reference and carried
  into the port through ``segment_from_numpy`` (tests/test_torch_plan.py
  ``carry``): geo_distance at three radii, the distanceRange bool, boxes
  (one across the dateline), polygons of 5 and 64 vertices, geo_shape
  under each relation, and ``_geo_distance`` sorts with a 3-page
  ``search_after`` walk; then ``_search`` over REST on both nodes.

Tolerance: ids, order, totals and sort values exact; scores rtol 1e-6.
The geo boundary rule: the reference computes its float32 haversine
with XLA's sin, cos, arcsin and sqrt, the port with torch's, which
differ by an ulp on some inputs (below 2.3e-7 relative at distances
under 2000 km on the CPU). A doc whose float64 distance lies within
1e-6 relative of a radius may fall on either side; each case counts the
docs in that band and exempts them, and the count is asserted small.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.common import errors as jax_errors
from elasticsearch_tpu.common import geo as jgeo
from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.index.segment import SegmentWriter as JaxWriter
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.ops.device import DeviceSegment as JaxDeviceSegment
from elasticsearch_tpu.search.context import \
    DeviceSegmentCache as JaxSegmentCache
from elasticsearch_tpu.search.context import SegmentContext as JaxContext
from elasticsearch_tpu.search.context import ShardStats as JaxStats
from elasticsearch_tpu.search.queries import parse_query as jax_parse
from elasticsearch_tpu.search.searcher import ShardSearcher as JaxSearcher
from elasticsearch_tpu_torch.common import geo
from elasticsearch_tpu_torch.common.errors import (IllegalArgumentException,
                                                   ParsingException)
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops.device import DeviceSegment
from elasticsearch_tpu_torch.search.context import (DeviceSegmentCache,
                                                    SegmentContext,
                                                    ShardStats)
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.search.searcher import (ShardSearcher,
                                                     _parse_sort)
from test_torch_dense import assert_same_page
from test_torch_plan import carry

RTOL = 1e-6
BAND = 1e-6          # the geo boundary rule's relative band
MAX_EXEMPT = 3       # docs a case may exempt

# the reference's tests/test_geo.py documents
MAPPINGS = {"properties": {"name": {"type": "keyword"},
                           "location": {"type": "geo_point"},
                           "area": {"type": "geo_shape"}}}
CITIES = [
    {"name": "london", "location": {"lat": 51.5074, "lon": -0.1278}},
    {"name": "paris", "location": "48.8566,2.3522"},
    {"name": "berlin", "location": [13.4050, 52.5200]},        # [lon, lat]
    {"name": "sf", "location": {"lat": 37.7749, "lon": -122.4194}},
    {"name": "noloc"},
    {"name": "poly", "area": {"type": "polygon", "coordinates": [
        [[0.0, 0.0], [10.0, 0.0], [10.0, 10.0], [0.0, 10.0], [0.0, 0.0]]]}},
]


def ctx_pair(mappings, docs):
    """The same docs through both packages' mappers and writers: (the
    reference's SegmentContext, the port's on the CPU)."""
    jm, pm = MapperService(mappings=mappings), DocumentMapper(mappings)
    jw, pw = JaxWriter(), SegmentWriter()
    for i, d in enumerate(docs):
        jw.add(jm.parse(str(i), d))
        pw.add(pm.parse(str(i), d))
    js, ps = jw.build("s0"), pw.build("s0")
    return (JaxContext(js, JaxDeviceSegment(js), jm, JaxStats([js])),
            SegmentContext(ps, DeviceSegment(ps, "cpu"), pm,
                           ShardStats([ps])))


def matching(pair, body):
    """The matched docids, equal on both sides (scores rtol 1e-6)."""
    jctx, pctx = pair
    js, jm = jax_parse(body).execute(jctx)
    ps, pm = parse_query(body).execute(pctx)
    n = jctx.segment.n_docs
    jm, pm = np.asarray(jm)[:n], pm[:n].numpy()
    assert (jm == pm).all(), body
    np.testing.assert_allclose(ps[:n].numpy(), np.asarray(js)[:n],
                               rtol=RTOL)
    return set(np.nonzero(pm)[0].tolist())


@pytest.fixture(scope="module")
def cities():
    return ctx_pair(MAPPINGS, CITIES)


# ---------------------------------------------------------------------------
# common/geo.py against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", [
    {"lat": 1.0, "lon": 2.0}, "1.0,2.0", [2.0, 1.0], "POINT (2.0 1.0)",
    jgeo.geohash_encode(1.0, 2.0, 9), "u4pruydqqvj", {"lat": "3", "lon": 4}])
def test_parse_geo_point_formats(value):
    assert geo.parse_geo_point(value) == jgeo.parse_geo_point(value)
    assert geo.is_point_value(value) == jgeo.is_point_value(value)


@pytest.mark.parametrize("value,port_exc,ref_exc", [
    ({"lat": 91.0, "lon": 0.0}, IllegalArgumentException,
     jax_errors.IllegalArgumentException),
    ({"lat": 0.0, "lon": 181.0}, IllegalArgumentException,
     jax_errors.IllegalArgumentException),
    ({"lat": 1.0}, ParsingException, jax_errors.ParsingException),
    ([1.0, 2.0, 3.0], ParsingException, jax_errors.ParsingException),
    ("1,2,3", ParsingException, jax_errors.ParsingException),
    ("!!", ParsingException, jax_errors.ParsingException)])
def test_parse_geo_point_errors(value, port_exc, ref_exc):
    with pytest.raises(ref_exc):
        jgeo.parse_geo_point(value)
    with pytest.raises(port_exc):
        geo.parse_geo_point(value)


@pytest.mark.parametrize("value", ["1km", "1mi", 500, "2.5m", "3 nmi",
                                   "1e3ft", "7yd", "-2cm"])
def test_parse_distance_units(value):
    assert geo.parse_distance(value) == jgeo.parse_distance(value)
    assert geo.meters_to_unit(1234.5, "km") == \
        jgeo.meters_to_unit(1234.5, "km")


def test_parse_distance_errors():
    for bad in ("10lightyears", "km"):
        with pytest.raises(ParsingException):
            geo.parse_distance(bad)
        with pytest.raises(jax_errors.ParsingException):
            jgeo.parse_distance(bad)


def test_geohash_roundtrip():
    for lat, lon in [(51.5, -0.12), (-33.86, 151.2), (0.0, 0.0)]:
        for precision in (1, 5, 12):
            h = geo.geohash_encode(lat, lon, precision)
            assert h == jgeo.geohash_encode(lat, lon, precision)
            assert geo.geohash_decode(h) == jgeo.geohash_decode(h)
        dlat, dlon = geo.geohash_decode(geo.geohash_encode(lat, lon, 12))
        assert abs(dlat - lat) < 1e-5 and abs(dlon - lon) < 1e-5


@pytest.mark.parametrize("kind,precision", [
    ("geohash", p) for p in (1, 3, 5, 7, 12)] + [
    ("geotile", z) for z in (0, 4, 7, 14, 20, 29)])
def test_grid_cells_equal_the_reference(kind, precision):
    """The grid aggregations' cells (the integer codes spelled as keys)
    equal the reference's strings, dtype and all, on seeded points, the
    poles, the antimeridian and the cell edges of the precision."""
    rng = np.random.default_rng(precision)
    lat = rng.uniform(-90, 90, 3000)
    lon = rng.uniform(-180, 180, 3000)
    n = 1 << (precision if kind == "geotile" else (5 * precision + 1) // 2)
    edges = np.arange(-180.0, 180.0, 360.0 / min(n, 512))
    lat = np.concatenate([lat, [90.0, -90.0, 0.0, 85.06, -85.06],
                          np.zeros(len(edges))])
    lon = np.concatenate([lon, [180.0, -180.0, 0.0, 179.999999, -180.0],
                          edges])
    port = getattr(geo, f"{kind}_cells")(lat, lon, precision)
    ref = getattr(jgeo, f"{kind}_cells")(lat, lon, precision)
    assert port.dtype == ref.dtype
    assert port.tolist() == ref.tolist()


def test_haversine_known_distance():
    d = geo.haversine_meters(51.5074, -0.1278, 48.8566, 2.3522)
    assert d == jgeo.haversine_meters(51.5074, -0.1278, 48.8566, 2.3522)
    assert 330_000 < d < 360_000


def test_points_in_polygon():
    lats = np.array([5.0, 15.0, -1.0, 9.9])
    lons = np.array([5.0, 5.0, 5.0, 9.9])
    poly_lats, poly_lons = [0.0, 0.0, 10.0, 10.0], [0.0, 10.0, 10.0, 0.0]
    inside = geo.points_in_polygon(lats, lons, poly_lats, poly_lons)
    assert inside.tolist() == [True, False, False, True]
    got = geo.points_in_polygon(torch.from_numpy(lats.astype(np.float32)),
                                torch.from_numpy(lons.astype(np.float32)),
                                poly_lats, poly_lons, xp=torch)
    assert got.tolist() == inside.tolist()


@pytest.mark.parametrize("shape", [
    {"type": "point", "coordinates": [2.0, 1.0]},
    {"type": "envelope", "coordinates": [[-1.0, 5.0], [3.0, -2.0]]},
    {"type": "polygon", "coordinates": [
        [[0.0, 0.0], [10.0, 0.0], [10.0, 10.0], [0.0, 0.0]]]},
    {"type": "linestring", "coordinates": [[1, 2], [3, 4], [-1, 0]]},
    {"type": "multipolygon", "coordinates": [
        [[[0, 0], [1, 0], [1, 1], [0, 0]]], [[[5, 5], [6, 5], [6, 7]]]]},
    {"type": "geometrycollection", "geometries": [
        {"type": "point", "coordinates": [9, 9]},
        {"type": "envelope", "coordinates": [[-1, 2], [0, 1]]}]}])
def test_shape_bbox(shape):
    assert geo.shape_bbox(shape) == jgeo.shape_bbox(shape)


def test_shape_bbox_unknown_type():
    with pytest.raises(ParsingException):
        geo.shape_bbox({"type": "circle", "coordinates": [0, 0]})


@pytest.mark.parametrize("a,b", [
    ((0, 0, 1, 1), (2, 2, 3, 3)), ((0, 0, 1, 1), (-1, -1, 2, 2)),
    ((-1, -1, 2, 2), (0, 0, 1, 1)), ((0, 0, 2, 2), (1, 1, 3, 3))])
def test_bbox_relate(a, b):
    assert geo.bbox_relate(a, b) == jgeo.bbox_relate(a, b)


def _seeded_points(n, seed):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-80, 80, n).astype(np.float32)
    lon = rng.uniform(-180, 180, n).astype(np.float32)
    return lat, lon


@pytest.fixture
def one_intra_op_thread():
    """torch's elementwise ops on the calling thread alone: a reference
    ``Node`` built earlier in the same process (test_torch_rest_params.py's
    module fixture builds one) leaves torch's intra-op worker threads
    computing ``sin``/``arcsin`` a little apart from the caller's; the
    chunk ``at::parallel_for`` hands to a worker then moves a distance
    near the origin by 1e-4 (xdist runs both files in one worker)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("origin", [(51.5074, -0.1278), (0.0, 0.0),
                                    (-33.9, 151.2), (89.0, 179.0)])
def test_haversine_float32_against_the_reference(origin,
                                                 one_intra_op_thread):
    """Within the boundary rule's band (1e-6 relative) of the
    reference's float32 distances under 2000 km: an ulp of XLA's
    transcendentals against torch's (2.2e-7 at most measured here), and
    the origin float32 on both sides. Near the origin the float32
    distance is ill-conditioned (2.6e-6 from the float64 one), so both
    sides must run the same float32 ops: torch's on the caller's thread
    (``one_intra_op_thread``)."""
    lat, lon = _seeded_points(50000, 3)
    ref = np.asarray(jgeo.haversine_meters(
        jnp.asarray(lat), jnp.asarray(lon), *origin, xp=jnp))
    got = geo.haversine_meters(torch.from_numpy(lat), torch.from_numpy(lon),
                               *origin, xp=torch)
    assert got.dtype == torch.float32
    got = got.numpy()
    d64 = jgeo.haversine_meters(lat.astype(np.float64),
                                lon.astype(np.float64), *origin)
    near = d64 < 2e6
    rel = np.abs(got.astype(np.float64) - ref) / np.maximum(d64, 1.0)
    assert rel[near].max() <= BAND, rel[near].max()


@pytest.mark.parametrize("box", [(60.0, -10.0, 30.0, 40.0),
                                 (60.0, 150.0, -30.0, -110.0)])
def test_bbox_mask_against_the_reference(box):
    lat, lon = _seeded_points(20000, 4)
    ref = np.asarray(jgeo.bbox_contains(jnp.asarray(lat), jnp.asarray(lon),
                                        *box, xp=jnp))
    got = geo.bbox_contains(torch.from_numpy(lat), torch.from_numpy(lon),
                            *box, xp=torch).numpy()
    assert (got == ref).all() and got.any()


@pytest.mark.parametrize("n_vertices", [3, 5, 64])
def test_polygon_mask_against_the_reference(n_vertices):
    """The even-odd rule over float32 columns, with a horizontal edge
    (its guard is 0.0 in float32 on both sides)."""
    lat, lon = _seeded_points(20000, 5)
    t = np.linspace(0, 2 * np.pi, n_vertices, endpoint=False)
    r = 30 + 10 * np.cos(3 * t)
    plats = list(r * np.sin(t) * 0.8)
    plons = list(r * np.cos(t) * 2)
    plats[1] = plats[0]          # a horizontal edge
    ref = np.asarray(jgeo.points_in_polygon(jnp.asarray(lat),
                                            jnp.asarray(lon), plats, plons,
                                            xp=jnp))
    got = geo.points_in_polygon(torch.from_numpy(lat), torch.from_numpy(lon),
                                plats, plons, xp=torch).numpy()
    assert (got == ref).all() and got.any()


# ---------------------------------------------------------------------------
# the reference's query cases (tests/test_geo.py)
# ---------------------------------------------------------------------------

def test_geo_distance_query(cities):
    assert matching(cities, {"geo_distance": {
        "distance": "500km",
        "location": {"lat": 51.5074, "lon": -0.1278}}}) == {0, 1}


def test_geo_distance_query_excludes_missing(cities):
    hits = matching(cities, {"geo_distance": {
        "distance": "25000km", "location": {"lat": 0, "lon": 0}}})
    assert 4 not in hits and {0, 1, 2, 3} <= hits


def test_geo_bounding_box_query(cities):
    assert matching(cities, {"geo_bounding_box": {"location": {
        "top_left": {"lat": 55.0, "lon": 0.0},
        "bottom_right": {"lat": 45.0, "lon": 15.0}}}}) == {1, 2}


def test_geo_bounding_box_dateline(cities):
    assert matching(cities, {"geo_bounding_box": {"location": {
        "top": 60.0, "left": 150.0, "bottom": 30.0,
        "right": -110.0}}}) == {3}


def test_geo_polygon_query(cities):
    assert matching(cities, {"geo_polygon": {"location": {"points": [
        {"lat": 50.0, "lon": 0.0}, {"lat": 50.0, "lon": 5.0},
        {"lat": 47.0, "lon": 2.0}]}}}) == {1}


def test_geo_shape_query_intersects(cities):
    assert matching(cities, {"geo_shape": {"area": {
        "shape": {"type": "envelope",
                  "coordinates": [[5.0, 8.0], [15.0, 2.0]]},
        "relation": "intersects"}}}) == {5}


def test_geo_shape_query_disjoint(cities):
    assert matching(cities, {"geo_shape": {"area": {
        "shape": {"type": "envelope",
                  "coordinates": [[20.0, 30.0], [25.0, 25.0]]},
        "relation": "disjoint"}}}) == {5}


def test_geo_shape_query_within(cities):
    assert matching(cities, {"geo_shape": {"area": {
        "shape": {"type": "envelope",
                  "coordinates": [[-5.0, 15.0], [15.0, -5.0]]},
        "relation": "within"}}}) == {5}


def test_geo_shape_query_contains_and_bad_relation(cities):
    assert matching(cities, {"geo_shape": {"area": {
        "shape": {"type": "point", "coordinates": [5.0, 5.0]},
        "relation": "contains"}}}) == {5}
    with pytest.raises(ParsingException):
        parse_query({"geo_shape": {"area": {
            "shape": {"type": "point", "coordinates": [5.0, 5.0]},
            "relation": "overlaps"}}})


def test_geo_exists(cities):
    assert matching(cities, {"exists": {"field": "location"}}) == \
        {0, 1, 2, 3}


def _city_searchers(cache_ref=None):
    jm, pm = MapperService(mappings=MAPPINGS), DocumentMapper(MAPPINGS)
    jw, pw = JaxWriter(), SegmentWriter()
    for i, d in enumerate(CITIES[:4]):
        jw.add(jm.parse(str(i), d))
        pw.add(pm.parse(str(i), d))
    return (JaxSearcher([jw.build("s0")], jm, JaxSegmentCache()),
            ShardSearcher([pw.build("s0")], pm, DeviceSegmentCache("cpu")))


def _page(res):
    return [(d.docid, list(d.sort_values)) for d in res.docs]


def test_geo_distance_sort():
    ref, port = _city_searchers()
    sort = [{"_geo_distance": {"location": {"lat": 51.5, "lon": -0.12},
                               "order": "asc", "unit": "km"}}]
    r = ref.query_phase(jax_parse({"match_all": {}}), 4, sort=sort)
    p = port.query_phase(parse_query({"match_all": {}}), 4, sort=sort)
    assert _page(p) == _page(r)
    assert [d.docid for d in p.docs] == [0, 1, 2, 3]
    dists = [d.sort_values[0] for d in p.docs]
    assert dists[0] < 5 and 300 < dists[1] < 400 and dists == sorted(dists)


def test_geo_distance_sort_search_after():
    ref, port = _city_searchers()
    sort = [{"_geo_distance": {"location": "51.5,-0.12", "order": "asc",
                               "unit": "km"}}]
    q = {"match_all": {}}
    p1 = port.query_phase(parse_query(q), 2, sort=sort)
    assert _page(p1) == _page(ref.query_phase(jax_parse(q), 2, sort=sort))
    assert [d.docid for d in p1.docs] == [0, 1]
    after = list(p1.docs[-1].sort_values)
    p2 = port.query_phase(parse_query(q), 2, sort=sort, search_after=after)
    r2 = ref.query_phase(jax_parse(q), 2, sort=sort, search_after=after)
    assert _page(p2) == _page(r2)
    assert [d.docid for d in p2.docs] == [2, 3]


def test_geo_distance_sort_missing_field_is_parse_error():
    with pytest.raises(ParsingException):
        _parse_sort([{"_geo_distance": {"order": "asc"}}])


def test_geo_point_multi_value():
    jm, pm = MapperService(mappings=MAPPINGS), DocumentMapper(MAPPINGS)
    doc = {"location": [[2.0, 1.0], [4.0, 3.0]]}
    parsed = pm.parse("0", doc)
    assert parsed.numeric_values == jm.parse("0", doc).numeric_values
    assert parsed.numeric_values["location.lat"] == [1.0, 3.0]
    assert parsed.numeric_values["location.lon"] == [2.0, 4.0]


# ---------------------------------------------------------------------------
# a seeded cloud of clustered points, carried from the reference
# ---------------------------------------------------------------------------

N_CLOUD = 6000
CENTERS = [(51.5, -0.12), (48.86, 2.35), (40.7, -74.0), (35.7, 139.7),
           (-33.9, 151.2), (0.5, 179.5), (64.1, -21.9)]


def cloud_docs(n=N_CLOUD, seed=21):
    """Points clustered like populated places (most near a center,
    a tail anywhere), some docs without a point, envelopes as areas."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, len(CENTERS), n)
    spread = rng.exponential(0.6, n)
    lat = np.array([CENTERS[i][0] for i in c]) + rng.normal(0, 1, n) * spread
    lon = np.array([CENTERS[i][1] for i in c]) + rng.normal(0, 1, n) * spread
    tail = rng.random(n) < 0.1
    lat[tail] = rng.uniform(-70, 70, tail.sum())
    lon[tail] = rng.uniform(-180, 180, tail.sum())
    lat = np.clip(lat, -89.9, 89.9)
    lon = (lon + 180.0) % 360.0 - 180.0
    docs = []
    for i in range(n):
        d = {"name": f"p{i % 97}", "pop": int(rng.integers(0, 10**6))}
        if i % 41:
            d["location"] = {"lat": round(float(lat[i]), 6),
                             "lon": round(float(lon[i]), 6)}
            h = float(rng.uniform(0.01, 0.5))
            d["area"] = {"type": "envelope", "coordinates": [
                [round(float(lon[i]) - h, 6), round(float(lat[i]) + h, 6)],
                [round(float(lon[i]) + h, 6), round(float(lat[i]) - h, 6)]]}
        docs.append(d)
    return docs


CLOUD_MAPPINGS = {"properties": {"name": {"type": "keyword"},
                                 "pop": {"type": "long"},
                                 "location": {"type": "geo_point"},
                                 "area": {"type": "geo_shape"}}}


def _polygon(center, radius, n):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = radius * (1 + 0.3 * np.cos(5 * t))
    return [{"lat": float(center[0] + r[i] * np.sin(t[i])),
             "lon": float(center[1] + 1.5 * r[i] * np.cos(t[i]))}
            for i in range(n)]


def _dist(origin, radius):
    return {"geo_distance": {"distance": radius, "location": origin}}


CLOUD_BODIES = [
    {"query": _dist({"lat": 51.5, "lon": -0.12}, "1km")},
    {"query": _dist({"lat": 51.5, "lon": -0.12}, "50km")},
    {"query": _dist("48.86,2.35", "1000km")},
    {"query": _dist([151.2, -33.9], "120km")},
    # Rally geopoint's distanceRange: within 500 km and not within 200 km
    {"query": {"bool": {"must": [_dist({"lat": 40.7, "lon": -74.0},
                                       "500km")],
                        "must_not": [_dist({"lat": 40.7, "lon": -74.0},
                                           "200km")]}}},
    {"query": {"geo_bounding_box": {"location": {
        "top_left": {"lat": 53.0, "lon": -2.0},
        "bottom_right": {"lat": 47.0, "lon": 4.0}}}}},
    {"query": {"geo_bounding_box": {"location": {
        "top": 5.0, "left": 178.0, "bottom": -5.0, "right": -178.5}}}},
    {"query": {"geo_polygon": {"location": {
        "points": _polygon((35.7, 139.7), 1.5, 5)}}}},
    {"query": {"geo_polygon": {"location": {
        "points": _polygon((51.0, 1.0), 2.5, 64)}}}},
    {"query": {"geo_shape": {"area": {"shape": {
        "type": "envelope", "coordinates": [[-1.0, 52.0], [1.0, 51.0]]},
        "relation": "intersects"}}}},
    {"query": {"geo_shape": {"area": {"shape": {
        "type": "envelope", "coordinates": [[-1.0, 52.0], [1.0, 51.0]]},
        "relation": "within"}}}},
    {"query": {"geo_shape": {"area": {"shape": {
        "type": "point", "coordinates": [-0.12, 51.5]},
        "relation": "contains"}}}},
    {"query": {"geo_shape": {"area": {"shape": {
        "type": "polygon", "coordinates": [[[-10, 30], [30, 30],
                                            [30, 60], [-10, 30]]]},
        "relation": "disjoint"}}}},
    {"query": {"bool": {"must": [{"term": {"name": "p3"}}],
                        "filter": [_dist({"lat": 48.86, "lon": 2.35},
                                         "800km")]}}},
]

CLOUD_SORTS = [
    ({"lat": 51.5, "lon": -0.12}, "asc", "km", 10),
    ({"lat": 35.7, "lon": 139.7}, "asc", "m", 100),
    ("-33.9,151.2", "desc", "mi", 10),
]


def _radius_band(lat, lon, body) -> set:
    """The docs whose float64 distance lies within BAND (relative) of a
    geo_distance radius of ``body``."""
    out = set()

    def visit(node):
        if isinstance(node, dict):
            if "geo_distance" in node:
                spec = dict(node["geo_distance"])
                radius = geo.parse_distance(spec.pop("distance"))
                (_f, origin), = spec.items()
                olat, olon = geo.parse_geo_point(origin)
                d = geo.haversine_meters(lat, lon, olat, olon)
                out.update(np.nonzero(np.abs(d - radius)
                                      <= BAND * radius)[0].tolist())
            for v in node.values():
                visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)
    visit(body)
    return out


@pytest.fixture(scope="module")
def cloud():
    """The reference's searcher over the cloud (two segments) and the
    port's over the carried segments, and the float32 columns."""
    jm = MapperService(mappings=CLOUD_MAPPINGS)
    docs = cloud_docs()
    segments = []
    for lo, hi in ((0, 3500), (3500, N_CLOUD)):
        w = JaxWriter()
        for i in range(lo, hi):
            w.add(jm.parse(str(i), docs[i]))
        segments.append(w.build(f"c{lo}"))
    ref = JaxSearcher(segments, jm, JaxSegmentCache())
    port = ShardSearcher([carry(s, fields=("name",)) for s in segments],
                         DocumentMapper(CLOUD_MAPPINGS),
                         DeviceSegmentCache("cpu"))
    lat = np.concatenate([s.numerics["location.lat"].values
                          for s in segments]).astype(np.float32)
    lon = np.concatenate([s.numerics["location.lon"].values
                          for s in segments]).astype(np.float32)
    return ref, port, lat.astype(np.float64), lon.astype(np.float64)


def _addresses(res, searcher):
    return [(searcher.segments[d.segment_idx].stored.ids[d.docid],
             tuple(d.sort_values)) for d in res.docs]


@pytest.mark.parametrize("bi", range(len(CLOUD_BODIES)))
def test_cloud_queries_match_the_reference(cloud, bi):
    ref, port, lat, lon = cloud
    body = CLOUD_BODIES[bi]["query"]
    r = ref.query_phase(jax_parse(body), N_CLOUD)
    p = port.query_phase(parse_query(body), N_CLOUD)
    band = {str(i) for i in _radius_band(lat, lon, body)}
    assert len(band) <= MAX_EXEMPT
    got = {i for i, _ in _addresses(p, port)}
    want = {i for i, _ in _addresses(r, ref)}
    assert (got ^ want) <= band, body
    if not band:
        assert p.total_hits == r.total_hits
        assert [i for i, _ in _addresses(p, port)] == \
            [i for i, _ in _addresses(r, ref)]
        np.testing.assert_allclose([d.score for d in p.docs],
                                   [d.score for d in r.docs], rtol=RTOL)
    assert got, body


@pytest.mark.parametrize("si", range(len(CLOUD_SORTS)))
def test_cloud_geo_sort_and_search_after_walk(cloud, si):
    """Three pages of a ``_geo_distance`` sort, each after the last hit
    of the one before, equal the reference's: ids, order and the float64
    sort values in the unit."""
    ref, port, _lat, _lon = cloud
    origin, order, unit, size = CLOUD_SORTS[si]
    sort = [{"_geo_distance": {"location": origin, "order": order,
                               "unit": unit}}]
    query = {"bool": {"filter": [{"exists": {"field": "location"}}]}}
    after = None
    for _page_no in range(3):
        r = ref.query_phase(jax_parse(query), size, sort=sort,
                            search_after=after)
        p = port.query_phase(parse_query(query), size, sort=sort,
                             search_after=after)
        assert _addresses(p, port) == _addresses(r, ref)
        assert p.total_hits == r.total_hits
        assert len(p.docs) == size
        after = list(p.docs[-1].sort_values)


def test_cloud_sort_with_a_tiebreak_and_missing_points(cloud):
    """Docs without a point sort last in either order; ``_doc`` breaks
    ties; a desc walk reaches the missing docs."""
    ref, port, _lat, _lon = cloud
    sort = [{"_geo_distance": {"location": [2.35, 48.86], "order": "desc"}},
            "_doc"]
    q = {"match_all": {}}
    r = ref.query_phase(jax_parse(q), 200, sort=sort)
    p = port.query_phase(parse_query(q), 200, sort=sort)
    assert _addresses(p, port) == _addresses(r, ref)


# ---------------------------------------------------------------------------
# _search over REST on both nodes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """Both nodes with "places": the first 1500 cloud docs in two bulks
    (two segments) and three deletes."""
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("geo")))
    node = Node(device="cpu")
    docs = cloud_docs(1500, seed=22)
    for c in (jax_node.rest_controller, node.rest_controller):
        assert c.dispatch("PUT", "/places", {}, {
            "mappings": CLOUD_MAPPINGS,
            "settings": {"index": {"number_of_shards": 1}}})[0] == 200
        for lo, hi in ((0, 900), (900, 1500)):
            bulk = "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                           + json.dumps(docs[i]) + "\n"
                           for i in range(lo, hi))
            st, r = c.dispatch("POST", "/places/_bulk", {"refresh": "true"},
                               bulk)
            assert st == 200 and not r["errors"], r
        st, r = c.dispatch("POST", "/places/_bulk", {"refresh": "true"},
                           "".join(json.dumps({"delete": {"_id": i}}) + "\n"
                                   for i in ("5", "901", "1200")))
        assert st == 200 and not r["errors"], r
    yield jax_node, node
    node.close()
    jax_node.close()


REST_BODIES = [dict(b, size=25) for b in CLOUD_BODIES] + [
    {"query": {"match_all": {}}, "size": 20,
     "sort": [{"_geo_distance": {"location": "51.5,-0.12", "unit": "km"}}]},
    {"query": {"term": {"name": "p7"}}, "size": 10,
     "sort": [{"_geo_distance": {"location": {"lat": 35.7, "lon": 139.7},
                                 "order": "desc"}}, {"pop": "asc"}]},
    {"query": {"match_all": {}}, "size": 15,
     "sort": [{"_geo_distance": {"location": "51.5,-0.12", "unit": "km"}}],
     "search_after": [500.0]},
    {"query": {"exists": {"field": "location"}}, "size": 5},
    {"query": {"geo_distance": {"distance": "300km",
                                "location": "48.86,2.35"}},
     "post_filter": {"range": {"pop": {"lt": 500000}}}, "size": 30},
]


@pytest.mark.parametrize("bi", range(len(REST_BODIES)))
def test_rest_geo_bodies_match_the_reference(nodes, bi):
    jax_node, node = nodes
    body = REST_BODIES[bi]
    st, got = node.rest_controller.dispatch("POST", "/places/_search", {},
                                            body)
    st2, ref = jax_node.rest_controller.dispatch("POST", "/places/_search",
                                                 {}, body)
    assert st == st2 == 200, (got, ref)
    assert_same_page(got, ref)
    assert got["hits"]["total"]["value"] > 0


def test_rest_exists_on_a_geo_shape_matches_nothing(nodes):
    """The reference's exists has no geo_shape branch (it looks for a
    column named after the field): no doc matches, on both nodes."""
    jax_node, node = nodes
    body = {"query": {"exists": {"field": "area"}}}
    st, got = node.rest_controller.dispatch("POST", "/places/_search", {},
                                            body)
    st2, ref = jax_node.rest_controller.dispatch("POST", "/places/_search",
                                                 {}, body)
    assert st == st2 == 200
    assert_same_page(got, ref)
    assert got["hits"]["total"]["value"] == 0


def test_rest_geo_errors_match_the_reference(nodes):
    jax_node, node = nodes
    for body in ({"query": {"geo_polygon": {"location": {"points": [
                     {"lat": 1, "lon": 2}, {"lat": 3, "lon": 4}]}}}},
                 {"query": {"geo_distance": {"distance": "1lightyear",
                                             "location": [0, 0]}}},
                 {"query": {"match_all": {}},
                  "sort": [{"_geo_distance": {"order": "asc"}}]}):
        st, got = node.rest_controller.dispatch("POST", "/places/_search",
                                                {}, body)
        st2, _ = jax_node.rest_controller.dispatch(
            "POST", "/places/_search", {}, body)
        assert st == st2 == 400, (body, got)
        assert got["error"]["type"] == "parsing_exception"
