"""The field-type slice on the card against the same calls on the CPU.

- The geo masks (``haversine_meters``, ``bbox_contains`` across the
  dateline too, ``points_in_polygon`` of 5 and 64 vertices with a
  horizontal edge) on CUDA float32 columns against the CPU: the box and
  polygon masks exact, the distances within 1e-6 relative under
  2000 km (CUDA's and the CPU's transcendentals differ by an ulp), and a
  distance mask equal outside that band of its radius.
- The range-field relations (intersects, within, contains, term
  containment) and the ip CIDR term through both ``SegmentContext``s.
- ``_geo_distance`` sorts with a ``search_after`` walk through both
  ``ShardSearcher``s: each page's float64 sort values in order, its ids
  and total the CPU's but for docs within 1e-6 relative of the page's
  last value or of the filter's radius (the geo boundary rule).
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.common import geo
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.index.segment import segment_from_numpy
from elasticsearch_tpu_torch.ops.device import DeviceSegment
from elasticsearch_tpu_torch.search.context import (DeviceSegmentCache,
                                                    SegmentContext,
                                                    ShardStats)
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.search.searcher import ShardSearcher

pytestmark = pytest.mark.cuda

N = 200_000


def _points(seed=7):
    rng = np.random.default_rng(seed)
    lat = np.clip(rng.normal(45, 12, N), -89, 89)
    lon = (rng.normal(0, 40, N) + 180.0) % 360.0 - 180.0
    lat[::53] = np.nan
    lon[::53] = np.nan
    return lat, lon


def _segment():
    lat, lon = _points()
    rng = np.random.default_rng(8)
    lo = rng.integers(0, 1000, N).astype(np.float64)
    hi = lo + rng.integers(0, 50, N)
    ip = rng.integers(167772160, 167903232, N).astype(np.float64)  # 10.0/14
    return segment_from_numpy({"numerics": {
        "loc.lat": {"values": lat}, "loc.lon": {"values": lon},
        "r.lo": {"values": lo}, "r.hi": {"values": hi},
        "ip": {"values": ip}}}, name="fields0")


MAPPINGS = {"properties": {"loc": {"type": "geo_point"},
                           "r": {"type": "long_range"},
                           "ip": {"type": "ip"}}}


@pytest.fixture
def contexts(cuda_device):
    seg = _segment()
    mapper = DocumentMapper(MAPPINGS)
    return [SegmentContext(seg, DeviceSegment(seg, dev), mapper,
                           ShardStats([seg]))
            for dev in ("cpu", cuda_device)]


def _cols(ctx):
    lat, miss = ctx.numeric_column("loc.lat")
    lon, _ = ctx.numeric_column("loc.lon")
    return lat, lon, miss


@pytest.mark.parametrize("origin", [(51.5, -0.12), (0.0, 0.0),
                                    (-33.9, 151.2)])
def test_haversine_on_the_card(contexts, origin):
    (clat, clon, cmiss), (glat, glon, _) = map(_cols, contexts)
    c = geo.haversine_meters(clat, clon, *origin, xp=torch)
    g = geo.haversine_meters(glat, glon, *origin, xp=torch)
    assert g.dtype == torch.float32 and g.is_cuda
    c, g = c.numpy().astype(np.float64), g.cpu().numpy().astype(np.float64)
    near = (~cmiss.numpy()) & (c < 2e6)
    assert np.all(np.abs(c - g)[near] <= 1e-6 * np.maximum(c[near], 1.0))
    for radius in (1e3, 5e4, 1e6):
        band = np.abs(c - radius) <= 1e-6 * radius
        assert np.array_equal((c <= radius) & ~band, (g <= radius) & ~band)


@pytest.mark.parametrize("box", [(60.0, -10.0, 30.0, 40.0),
                                 (60.0, 150.0, -30.0, -110.0)])
def test_bbox_on_the_card(contexts, box):
    (clat, clon, _), (glat, glon, _) = map(_cols, contexts)
    c = geo.bbox_contains(clat, clon, *box, xp=torch)
    g = geo.bbox_contains(glat, glon, *box, xp=torch)
    assert torch.equal(c, g.cpu()) and bool(c.any())


@pytest.mark.parametrize("n_vertices", [5, 64])
def test_polygon_on_the_card(contexts, n_vertices):
    (clat, clon, _), (glat, glon, _) = map(_cols, contexts)
    t = np.linspace(0, 2 * np.pi, n_vertices, endpoint=False)
    r = 15 * (1 + 0.3 * np.cos(5 * t))
    plats = list(45 + r * np.sin(t))
    plons = list(1.5 * r * np.cos(t))
    plats[1] = plats[0]
    c = geo.points_in_polygon(clat, clon, plats, plons, xp=torch)
    g = geo.points_in_polygon(glat, glon, plats, plons, xp=torch)
    assert torch.equal(c, g.cpu()) and bool(c.any())


@pytest.mark.parametrize("body", [
    {"range": {"r": {"gte": 100, "lte": 120}}},
    {"range": {"r": {"gt": 100, "lt": 400, "relation": "within"}}},
    {"range": {"r": {"gte": 500, "lte": 505, "relation": "contains"}}},
    {"term": {"r": 777}},
    {"term": {"ip": "10.1.7.0/24"}},
    {"range": {"ip": {"gte": "10.0.0.0", "lt": "10.0.128.0"}}},
    {"geo_bounding_box": {"loc": {"top": 50, "left": 170, "bottom": 20,
                                  "right": -170}}},
    {"exists": {"field": "loc"}}])
def test_field_queries_on_the_card(contexts, body):
    c, g = (parse_query(body).execute(ctx) for ctx in contexts)
    assert torch.equal(c[1], g[1].cpu()) and bool(c[1].any())
    assert torch.equal(c[0], g[0].cpu())


@pytest.mark.parametrize("order,unit", [("asc", "km"), ("desc", "m")])
def test_geo_sort_walk_on_the_card(cuda_device, order, unit):
    """Three pages of 100 after one another on the card, each against
    the CPU's page after the same cursor: the float64 sort values of a
    page run in order (within float32 rounding of the keys) and the ids
    agree but for docs within 1e-6 relative of the page's last value."""
    seg = _segment()
    mapper = DocumentMapper(MAPPINGS)
    searchers = [ShardSearcher([seg], mapper, DeviceSegmentCache(dev))
                 for dev in ("cpu", cuda_device)]
    sort = [{"_geo_distance": {"loc": {"lat": 48.0, "lon": 2.0},
                               "order": order, "unit": unit}}]
    q = {"bool": {"filter": [{"geo_distance": {
        "distance": "400km", "loc": {"lat": 48.0, "lon": 2.0}}}]}}
    lat, lon = (seg.numerics[f].values.astype(np.float32).astype(np.float64)
                for f in ("loc.lat", "loc.lon"))
    d = geo.haversine_meters(lat, lon, 48.0, 2.0)
    band = int(np.sum(np.abs(d - 4e5) <= 1e-6 * 4e5))
    after = None
    sign = 1.0 if order == "asc" else -1.0
    for _ in range(3):
        cpu, gpu = (s.query_phase(parse_query(q), 100, sort=sort,
                                  search_after=after) for s in searchers)
        assert abs(cpu.total_hits - gpu.total_hits) <= band
        assert gpu.total_hits > 300
        vals = np.array([d.sort_values[0] for d in gpu.docs]) * sign
        assert np.all(np.diff(vals) >= -1e-6 * np.abs(vals[1:]))
        last = abs(vals[-1])
        differ = {d.docid for d in cpu.docs} ^ {d.docid for d in gpu.docs}
        by_id = {d.docid: d.sort_values[0] for d in cpu.docs + gpu.docs}
        assert all(abs(by_id[i] - last) <= 1e-6 * last for i in differ)
        after = list(gpu.docs[-1].sort_values)
