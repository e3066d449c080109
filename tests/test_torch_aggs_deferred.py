"""The port's aggregation types of the geo, ip, nested and join buckets,
composite and the rest of the bucket family, the remaining metrics with
scripted_metric, and the remaining parent pipelines, against the
reference's, on the CPU.

Every body goes through both packages' ``Node`` (``rest_controller.
dispatch``), each with ``"request_cache": false``, and the answers are
held equal: the status, then the aggregations, or the error's type and
reason. The reference runs its per-shard loop (``ESTPU_MESH_SERVING=0``),
as on one device. The corpora:

- tests/test_aggregations.py's "shop" documents on 2 shards (as that
  file indexes them) and on 3, with its cases of these types, and its
  own small indices (nested orders, crimes, ip addresses, clustered
  values, a ten-day date span);
- tests/test_geo.py's cities and tests/test_join_percolate.py's
  question/answer index, with their aggregation cases;
- the seeded ~3k-doc logs corpus of tests/test_torch_aggs.py, two
  segments with deletes, given geo_point, ip, nested and join fields,
  every type under match_all, a ``match`` query and a range;
- parity cases for the steps the port vectorizes (composite's order,
  ties, missing buckets and ``after`` walks; top_hits' tie order across
  segments; the grid cells and their key width) and the reference facts
  the port copies (an unsorted top_hits and the samplers take docs by
  docid, not by score).

Tolerance: everything exact (keys, bucket order, ``doc_count``,
``bg_count``, ``after_key``, hits and every float: both packages run the
same numpy and scipy on the host, and the TDigest is a copy).
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.node import Node
from test_torch_aggs import (MAPPINGS, SHOP_DOCS, SHOP_MAPPINGS, SPLIT,
                             T0_MS, assert_same_aggs, corpus_docs)
from test_torch_dense import iso

SHARDS = (2, 3)


@pytest.fixture(scope="module", autouse=True)
def one_device():
    """The reference's per-shard loop, as on one device."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ESTPU_MESH_SERVING", "0")
    yield
    mp.undo()


def _bulk(docs, ids=None, routing=None):
    lines = []
    for i, d in enumerate(docs):
        meta = {"_id": str(ids[i] if ids is not None else i)}
        if routing is not None and routing[i] is not None:
            meta["routing"] = routing[i]
        lines.append(json.dumps({"index": meta}) + "\n"
                     + json.dumps(d) + "\n")
    return "".join(lines)


def put(c, name, mappings, shards=1):
    st, r = c.dispatch("PUT", f"/{name}", {}, {
        "mappings": mappings,
        "settings": {"index": {"number_of_shards": shards}}})
    assert st == 200, r


def fill(c, name, docs, ids=None, routing=None):
    st, r = c.dispatch("POST", f"/{name}/_bulk", {"refresh": "true"},
                       _bulk(docs, ids, routing))
    assert st == 200 and not r["errors"], r


# ---------------------------------------------------------------------------
# corpora
# ---------------------------------------------------------------------------

CITIES_MAPPINGS = {"properties": {
    "name": {"type": "keyword"}, "location": {"type": "geo_point"},
    "area": {"type": "geo_shape"}}}
# tests/test_geo.py's documents
CITIES = [
    {"name": "london", "location": {"lat": 51.5074, "lon": -0.1278}},
    {"name": "paris", "location": "48.8566,2.3522"},
    {"name": "berlin", "location": [13.4050, 52.5200]},
    {"name": "sf", "location": {"lat": 37.7749, "lon": -122.4194}},
    {"name": "noloc"},
    {"name": "poly", "area": {"type": "polygon", "coordinates": [
        [[0.0, 0.0], [10.0, 0.0], [10.0, 10.0], [0.0, 10.0], [0.0, 0.0]]]}},
]
QA_MAPPINGS = {"properties": {
    "text": {"type": "text"},
    "join": {"type": "join", "relations": {"question": "answer"}}}}
# tests/test_join_percolate.py's documents
QA_DOCS = [
    ("q1", {"text": "how do I use jax", "join": "question"}),
    ("q2", {"text": "what is a tpu", "join": "question"}),
    ("a1", {"text": "with grad and jit",
            "join": {"name": "answer", "parent": "q1"}}),
    ("a2", {"text": "jax uses xla", "join": {"name": "answer",
                                             "parent": "q1"}}),
    ("a3", {"text": "a matrix accelerator",
            "join": {"name": "answer", "parent": "q2"}}),
]
# the small indices of tests/test_aggregations.py
NESTED_MAPPINGS = {"properties": {"items": {"type": "nested", "properties": {
    "product": {"type": "keyword"}, "qty": {"type": "long"}}}}}
NESTED_DOCS = [{"items": [{"product": "w", "qty": 10},
                          {"product": "g", "qty": 1}]},
               {"items": [{"product": "w", "qty": 5}]}]
CRIMES = [{"force": f, "type": t}
          for f, n_bike, n_rob in (("transit", 30, 10), ("city", 3, 50),
                                   ("rural", 2, 40))
          for t, n in (("bike_theft", n_bike), ("robbery", n_rob))
          for _ in range(n)]
ADDRS = [{"addr": ip} for ip in ("10.0.0.5", "10.0.0.200", "10.0.1.7",
                                 "192.168.1.1")]
CLUSTERS = [{"v": v} for v in (1.0, 1.1, 1.2, 50.0, 50.5, 51.0, 200.0)]
DAY = 86_400_000
SPAN = [{"ts": 0}, {"ts": 2 * DAY}, {"ts": 10 * DAY}]

# the logs corpus with geo, ip, nested and join fields
DEFERRED_MAPPINGS = {"properties": dict(
    MAPPINGS["properties"],
    loc={"type": "geo_point"},
    client={"type": "ip"},
    items={"type": "nested", "properties": {
        "sku": {"type": "keyword"}, "n": {"type": "integer"}}},
    rel={"type": "join", "relations": {"question": "answer"}})}
N_QUESTIONS = 300
DELETED = [3, 17, 64, 299, 500, 1599, 1600, 1700, 2222, 2999]
SKUS = ["a1", "b2", "c3", "d4", "e5"]


def deferred_docs(seed=11):
    """tests/test_torch_aggs.py's corpus with a point (in clusters),
    an address, 0-3 nested items and a join role: the first
    ``N_QUESTIONS`` docs are questions, the rest answers to one of them
    (routed to it)."""
    docs = corpus_docs(seed)
    rng = np.random.default_rng(seed + 1)
    centers = [(48.85, 2.35), (40.71, -74.0), (35.68, 139.69), (-33.87, 151.2)]
    routing = []
    for i, d in enumerate(docs):
        if rng.random() < 0.9:
            la, lo = centers[int(rng.integers(0, len(centers)))]
            d["loc"] = {"lat": float(np.round(la + rng.normal(0, 2.0), 5)),
                        "lon": float(np.round(lo + rng.normal(0, 2.0), 5))}
        if rng.random() < 0.95:
            d["client"] = (f"10.{int(rng.integers(0, 4))}."
                           f"{int(rng.integers(0, 256))}."
                           f"{int(rng.integers(0, 256))}")
        n_items = int(rng.integers(0, 4))
        if n_items:
            d["items"] = [{"sku": str(rng.choice(SKUS)),
                           "n": int(rng.integers(1, 9))}
                          for _ in range(n_items)]
        if i < N_QUESTIONS:
            d["rel"] = "question"
            routing.append(None)
        else:
            parent = str(int(rng.integers(0, N_QUESTIONS)))
            d["rel"] = {"name": "answer", "parent": parent}
            routing.append(parent)
    return docs, routing


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("deferred")))
    node = Node(device="cpu")
    docs, routing = deferred_docs()
    deletes = "".join(json.dumps({"delete": {"_id": str(i)}}) + "\n"
                      for i in DELETED)
    for c in (jax_node.rest_controller, node.rest_controller):
        for n in SHARDS:
            put(c, f"shop{n}", SHOP_MAPPINGS, n)
            fill(c, f"shop{n}", SHOP_DOCS)
        put(c, "cities", CITIES_MAPPINGS)
        fill(c, "cities", CITIES)
        put(c, "qa", QA_MAPPINGS)
        fill(c, "qa", [d for _, d in QA_DOCS], [i for i, _ in QA_DOCS],
             ["r"] * len(QA_DOCS))
        put(c, "plain", {"properties": {"t": {"type": "text"}}})
        fill(c, "plain", [{"t": "x"}])
        put(c, "orders", NESTED_MAPPINGS)
        fill(c, "orders", NESTED_DOCS, ["1", "2"])
        put(c, "crimes", {"properties": {"force": {"type": "keyword"},
                                         "type": {"type": "keyword"}}})
        fill(c, "crimes", CRIMES)
        put(c, "addrs", {"properties": {"addr": {"type": "ip"}}})
        fill(c, "addrs", ADDRS)
        put(c, "clusters", {"properties": {"v": {"type": "double"}}})
        fill(c, "clusters", CLUSTERS)
        put(c, "span", {"properties": {"ts": {"type": "date"}}})
        fill(c, "span", SPAN, ["a", "b", "c"])
        put(c, "logs", DEFERRED_MAPPINGS)
        for lo, hi in ((0, SPLIT), (SPLIT, len(docs))):
            fill(c, "logs", docs[lo:hi], list(range(lo, hi)),
                 routing[lo:hi])
        st, r = c.dispatch("POST", "/logs/_bulk", {"refresh": "true"},
                           deletes)
        assert st == 200 and not r["errors"], r
    yield jax_node, node
    node.close()
    jax_node.close()


def ask_both(nodes, index, body):
    """(status, answer) of the reference's and the port's node."""
    jax_node, node = nodes
    body = dict(body, request_cache=False)
    ref = jax_node.rest_controller.dispatch("POST", f"/{index}/_search", {},
                                            dict(body))
    got = node.rest_controller.dispatch("POST", f"/{index}/_search", {},
                                        dict(body))
    return ref, got


def assert_same_answer(nodes, index, body):
    """Equal status; equal aggregations exactly, or equal error type and
    reason. The port's answer."""
    (st_r, ref), (st_g, got) = ask_both(nodes, index, body)
    assert st_g == st_r, (got, ref)
    if st_r == 200:
        assert got["hits"]["total"] == ref["hits"]["total"]
        assert_same_aggs(got.get("aggregations"), ref.get("aggregations"),
                         0.0)
    else:
        assert got["error"]["type"] == ref["error"]["type"], (got, ref)
        if st_r == 400:
            assert got["error"]["reason"] == ref["error"]["reason"], \
                (got, ref)
    return got


def agg_body(aggs, query=None, **kw):
    body = {"size": 0, "aggs": aggs}
    if query is not None:
        body["query"] = query
    body.update(kw)
    return body


# ---------------------------------------------------------------------------
# tests/test_aggregations.py's cases of these types, on 2 and 3 shards
# ---------------------------------------------------------------------------

CAT = {"field": "category"}
DAYS = {"date_histogram": {"field": "sold_at", "calendar_interval": "day"}}
SHOP_CASES = {
    "top_hits": ({"by_cat": {"terms": {"field": "category", "size": 1},
                             "aggs": {"top": {"top_hits": {"size": 2}}}}},),
    "top_hits_sorted": (
        {"t": {"top_hits": {"size": 3, "sort": "price"}}},
        {"t": {"top_hits": {"size": 3, "sort": ["qty"]}}},
        {"t": {"top_hits": {"size": 4, "sort": [{"qty": "desc"}]}}},
        {"t": {"top_hits": {"size": 6, "sort": [
            {"sold_at": {"order": "desc"}}]}}}),
    "composite_basic": ({"comp": {"composite": {
        "size": 10, "sources": [{"cat": {"terms": CAT}}]}}},),
    "composite_after": (
        {"comp": {"composite": {"size": 1,
                                "sources": [{"cat": {"terms": CAT}}]}}},
        {"comp": {"composite": {"size": 2,
                                "sources": [{"cat": {"terms": CAT}}],
                                "after": {"cat": "fruit"}}}}),
    "composite_multi": ({"comp": {
        "composite": {"size": 10, "sources": [
            {"cat": {"terms": {"field": "category", "order": "desc"}}},
            {"day": {"date_histogram": {"field": "sold_at",
                                        "calendar_interval": "day"}}}]},
        "aggs": {"total": {"sum": {"field": "price"}}}}},),
    "composite_missing": ({"comp": {"composite": {
        "size": 10, "sources": [{"q": {"histogram": {
            "field": "qty", "interval": 10, "missing_bucket": True}}}]}}},),
    "boxplot": ({"b": {"boxplot": {"field": "price"}}},),
    "top_metrics": ({"t": {"top_metrics": {
        "metrics": [{"field": "qty"}],
        "sort": [{"price": {"order": "desc"}}], "size": 2}}},),
    "string_stats": (
        {"s": {"string_stats": {"field": "category"}}},
        {"s": {"string_stats": {"field": "category",
                                "show_distribution": True}}}),
    "matrix_stats": ({"m": {"matrix_stats": {"fields": ["price", "qty"]}}},),
    "cumulative_cardinality": ({
        "days": dict(DAYS, aggs={"cats": {"cardinality": CAT}}),
        "total": {"cumulative_cardinality": {"buckets_path": "days>cats"}}},),
    "sampler": ({"s": {"sampler": {"shard_size": 2},
                       "aggs": {"m": {"max": {"field": "price"}}}}},),
    "moving_fn": ({"days": dict(DAYS, aggs={
        "rev": {"sum": {"field": "price"}},
        "avg3": {"moving_fn": {
            "buckets_path": "rev", "window": 3,
            "script": "MovingFunctions.unweightedAvg(values)"}},
        "mx": {"moving_fn": {"buckets_path": "rev", "window": 2,
                             "script": "MovingFunctions.max(values)"}},
        "d1": {"serial_diff": {"buckets_path": "rev", "lag": 1}}})},),
    "moving_avg": ({"days": dict(DAYS, aggs={
        "rev": {"sum": {"field": "price"}},
        "ma": {"moving_avg": {"buckets_path": "rev", "window": 3}}})},),
    "adjacency_matrix": ({"adj": {"adjacency_matrix": {"filters": {
        "cheap": {"range": {"price": {"lte": 3}}},
        "fruit": {"term": {"category": {"value": "fruit"}}}}}}},),
    "diversified_sampler": ({"s": {
        "diversified_sampler": {"field": "category",
                                "max_docs_per_value": 1, "shard_size": 10},
        "aggs": {"cats": {"terms": CAT}}}},),
    "median_absolute_deviation": (
        {"mad": {"median_absolute_deviation": {"field": "price"}}},),
    "auto_date_histogram": (
        {"auto": {"auto_date_histogram": {"field": "sold_at",
                                          "buckets": 10}}},
        {"auto": {"auto_date_histogram": {"field": "sold_at",
                                          "buckets": 1}}}),
    "rare_terms": (
        {"rare": {"rare_terms": CAT}},
        {"rare": {"rare_terms": {"field": "category", "max_doc_count": 2}}},
        {"rare": {"rare_terms": {"field": "category", "max_doc_count": 2},
                  "aggs": {"p": {"avg": {"field": "price"}}}}},
        {"rare": {"rare_terms": {"field": "category",
                                 "max_doc_count": 101}}}),
    "multi_terms": (
        {"mt": {"multi_terms": {"terms": [CAT, {"field": "qty"}]}}},
        {"mt": {"multi_terms": {"terms": [CAT]}}}),
    "significant_text": (
        {"st": {"significant_text": {"field": "name", "min_doc_count": 1,
                                     "size": 5}}},
        {"st": {"significant_text": {"field": "name"},
                "aggs": {"x": {"avg": {"field": "price"}}}}}),
    "t_test": (
        {"t": {"t_test": {"a": {"field": "price"}, "b": {"field": "qty"},
                          "type": "heteroscedastic"}}},
        {"t": {"t_test": {"a": {"field": "price"}, "b": {"field": "qty"},
                          "type": "paired"}}},
        {"t": {"t_test": {
            "a": {"field": "price",
                  "filter": {"term": {"category": "fruit"}}},
            "b": {"field": "price",
                  "filter": {"term": {"category": "veg"}}},
            "type": "homoscedastic"}}},
        {"t": {"t_test": {"a": {"field": "price"}, "b": {"field": "qty"},
                          "type": "homoskedastic"}}}),
    "bucket_script": (
        {"cats": {"terms": {"field": "category", "order": {"_key": "asc"}},
                  "aggs": {
                      "total": {"sum": {"field": "price"}},
                      "n": {"value_count": {"field": "price"}},
                      "avg_calc": {"bucket_script": {
                          "buckets_path": {"t": "total", "c": "n"},
                          "script": "params.t / params.c"}},
                      "big_only": {"bucket_selector": {
                          "buckets_path": {"t": "total"},
                          "script": "params.t > 5"}}}}},
        {"cats": {"terms": CAT, "aggs": {
            "total": {"sum": {"field": "price"}},
            "keep": {"bucket_selector": {"buckets_path": {"t": "total"},
                                         "script": "params.t >= 9"}}}}}),
    "bucket_script_errors": (
        {"cats": {"terms": CAT, "aggs": {
            "t": {"sum": {"field": "price"}},
            "bad": {"bucket_script": {"buckets_path": {"t": "t"},
                                      "script": "params.t.badMethod()"}}}}},
        {"cats": {"terms": {"field": "category", "order": {"_key": "asc"}},
                  "aggs": {"t": {"sum": {"field": "price"}},
                           "z": {"bucket_script": {
                               "buckets_path": {"t": "t"},
                               "script": "params.t / (params.t - params.t)"
                           }}}}},
        {"cats": {"terms": CAT, "aggs": {
            "t": {"sum": {"field": "price"}},
            "s": {"bucket_script": {"buckets_path": {"t": "t"},
                                    "script": "'x' + params.t"}}}}},
        {"cats": {"terms": CAT, "aggs": {
            "t": {"sum": {"field": "price"}},
            "q": {"bucket_selector": {"buckets_path": {"t": "t"},
                                      "script": "params.t >"}}}}},
        {"cats": {"terms": CAT, "aggs": {
            "qty": {"sum": {"field": "qty"}},
            "g": {"bucket_script": {"buckets_path": {"q": "qty"},
                                    "gap_policy": "insert_zeros",
                                    "script": "params.q * 2"}}}}}),
    "moving_percentiles": ({"days": dict(DAYS, aggs={
        "pct": {"percentiles": {"field": "price", "percents": [50, 90]}},
        "mp": {"moving_percentiles": {"buckets_path": "pct",
                                      "window": 2}},
        "mp1": {"moving_percentiles": {"buckets_path": "pct",
                                       "window": 3, "shift": 1}}})},),
    "normalize": tuple(
        {"days": dict(DAYS, aggs={
            "rev": {"sum": {"field": "price"}},
            "nz": {"normalize": {"buckets_path": path, "method": m}}})}
        for m in ("rescale_0_1", "rescale_0_100", "percent_of_sum", "mean",
                  "z-score", "softmax", "bogus")
        for path in ("_count", "rev")),
    "geo_on_shop": ({"g": {"geo_bounds": {"field": "price"}},
                     "c": {"geo_centroid": {"field": "price"}},
                     "gg": {"geotile_grid": {"field": "price"}}},),
    "scripted_metric": (
        {"sm": {"scripted_metric": {
            "init_script": "state.total = 0.0",
            "map_script": "state.total += doc['price'].value",
            "combine_script": "return state.total",
            "reduce_script": "double s = 0; for (def t : states) "
                             "{ s += t } return s"}}},
        {"sm": {"scripted_metric": {
            "init_script": {"source": "state.cats = []"},
            "map_script": {"source": "if (!doc['qty'].empty) "
                                     "{ state.cats.add(doc['category']"
                                     ".value) }"}}}},
        {"sm": {"scripted_metric": {"init_script": "state.x = 1"}}},
        {"sm": {"scripted_metric": {"map_script": "for (t in states) {}"}}},
        {"sm": {"scripted_metric": {
            "map_script": "state.n = doc['qty'].value"}}}),
}
SHOP_QUERIES = [None, {"term": {"category": "fruit"}},
                {"range": {"price": {"lte": 3.0}}}]
SHOP_RUNS = [(kind, i) for kind, cases in SHOP_CASES.items()
             for i in range(len(cases))]


@pytest.mark.parametrize("qi", range(len(SHOP_QUERIES)))
@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("kind,ci", SHOP_RUNS)
def test_shop_cases_equal_the_reference(nodes, kind, ci, shards, qi):
    assert_same_answer(nodes, f"shop{shards}",
                       agg_body(SHOP_CASES[kind][ci], SHOP_QUERIES[qi]))


def test_shop_answers_as_the_reference_tests_assert(nodes):
    """A few of tests/test_aggregations.py's own assertions, on the
    port's node and the 2-shard index."""
    _, node = nodes

    def agg(aggs, **kw):
        st, r = node.rest_controller.dispatch("POST", "/shop2/_search", {},
                                              agg_body(aggs, **kw))
        assert st == 200, r
        return r["aggregations"]

    a = agg(SHOP_CASES["composite_basic"][0])
    assert [b["key"]["cat"] for b in a["comp"]["buckets"]] == \
        ["fruit", "meat", "veg"]
    assert a["comp"]["after_key"] == {"cat": "veg"}
    a = agg(SHOP_CASES["composite_missing"][0])
    keys = [b["key"]["q"] for b in a["comp"]["buckets"]]
    assert keys[0] is None and set(keys[1:]) == {0.0, 10.0, 20.0}
    a = agg(SHOP_CASES["cumulative_cardinality"][0])
    assert [b["cumulative_cardinality"]["value"]
            for b in a["days"]["buckets"]] == [1, 2, 3]
    assert all("_set" not in b["cats"] for b in a["days"]["buckets"])
    a = agg(SHOP_CASES["median_absolute_deviation"][0])
    assert a["mad"]["value"] == pytest.approx(1.5)
    a = agg(SHOP_CASES["moving_avg"][0])
    b = a["days"]["buckets"]
    assert b[1]["ma"]["value"] == pytest.approx(
        (b[0]["rev"]["value"] + b[1]["rev"]["value"]) / 2)
    a = agg(SHOP_CASES["rare_terms"][1])
    assert [(b["key"], b["doc_count"]) for b in a["rare"]["buckets"]] == \
        [("meat", 1), ("veg", 2)]
    a = agg(SHOP_CASES["bucket_script_errors"][1])
    assert all(b["z"]["value"] is None for b in a["cats"]["buckets"])
    a = agg(SHOP_CASES["moving_percentiles"][0])
    assert all("_digest" not in b["pct"] for b in a["days"]["buckets"])


SMALL_CASES = [
    ("orders", None, {"n": {"nested": {"path": "items"}, "aggs": {
        "total": {"sum": {"field": "items.qty"}},
        "products": {"terms": {"field": "items.product"}}}}}),
    ("orders", {"term": {"items.product": "g"}},
     {"n": {"nested": {"path": "items"}}}),
    ("crimes", {"term": {"force": {"value": "transit"}}},
     {"sig": {"significant_terms": {"field": "type"}}}),
    ("crimes", {"term": {"force": "city"}},
     {"sig": {"significant_terms": {"field": "type", "min_doc_count": 1},
              "aggs": {"f": {"terms": {"field": "force"}}}}}),
    ("addrs", None, {"r": {"ip_range": {"field": "addr", "ranges": [
        {"to": "10.0.1.0"}, {"from": "10.0.1.0", "to": "10.0.2.0"},
        {"mask": "192.168.0.0/16"},
        {"mask": "10.0.0.0/24", "key": "net"}]}}}),
    ("clusters", None, {"h": {"variable_width_histogram": {
        "field": "v", "buckets": 3}}}),
    ("clusters", None, {"h": {"variable_width_histogram": {
        "field": "v", "buckets": 20},
        "aggs": {"s": {"sum": {"field": "v"}}}}}),
    ("span", None, {"auto": {"auto_date_histogram": {"field": "ts",
                                                     "buckets": 10}}}),
    ("span", None, {"auto": {"auto_date_histogram": {"field": "ts",
                                                     "buckets": 3}}}),
    # tests/test_geo.py's aggregation cases
    ("cities", None, {"rings": {"geo_distance": {
        "field": "location", "origin": "51.5074,-0.1278", "unit": "km",
        "ranges": [{"to": 100}, {"from": 100, "to": 1000},
                   {"from": 1000}]}}}),
    ("cities", None, {"cells": {"geohash_grid": {"field": "location",
                                                 "precision": 3}}}),
    ("cities", None, {"cells": {"geotile_grid": {"field": "location",
                                                 "precision": 4}}}),
    ("cities", None, {"box": {"geo_bounds": {"field": "location"}}}),
    ("cities", None, {"c": {"geo_centroid": {"field": "location"}}}),
    ("cities", None, {"rings": {"geo_distance": {
        "field": "location", "origin": "0,0", "unit": "lightyears",
        "ranges": [{"to": 1}]}}}),
    ("cities", {"term": {"name": "sf"}},
     {"cells": {"geohash_grid": {"field": "location"},
                "aggs": {"c": {"geo_centroid": {"field": "location"}}}},
      "box": {"geo_bounds": {"field": "area"}}}),
    # tests/test_join_percolate.py's aggregation cases
    ("qa", {"match": {"text": "jax"}},
     {"to_answers": {"children": {"type": "answer"},
                     "aggs": {"words": {"terms": {"field": "join"}}}}}),
    ("qa", {"match": {"text": "accelerator"}},
     {"to_questions": {"parent": {"type": "answer"},
                       "aggs": {"cnt": {"value_count": {"field": "_id"}}}}}),
    ("qa", None, {"c": {"children": {"type": "question"}}}),
    ("qa", None, {"c": {"children": {}}}),
    ("plain", None, {"c": {"children": {"type": "answer"}}}),
]


@pytest.mark.parametrize("ci", range(len(SMALL_CASES)))
def test_small_index_cases_equal_the_reference(nodes, ci):
    index, query, aggs = SMALL_CASES[ci]
    assert_same_answer(nodes, index, agg_body(aggs, query))


def test_small_indices_answer_as_the_reference_tests_assert(nodes):
    _, node = nodes

    def agg(index, aggs, query=None):
        st, r = node.rest_controller.dispatch(
            "POST", f"/{index}/_search", {}, agg_body(aggs, query))
        assert st == 200, r
        return r["aggregations"]

    a = agg(*SMALL_CASES[0][::2])["n"]
    assert a["doc_count"] == 3 and a["total"]["value"] == 16.0
    a = agg("crimes", SMALL_CASES[2][2], SMALL_CASES[2][1])
    assert a["sig"]["buckets"][0]["key"] == "bike_theft"
    a = agg("addrs", SMALL_CASES[4][2])
    assert [x["doc_count"] for x in a["r"]["buckets"]] == [2, 1, 1, 2]
    a = agg("clusters", SMALL_CASES[5][2])
    assert [x["doc_count"] for x in a["h"]["buckets"]] == [3, 3, 1]
    a = agg("cities", SMALL_CASES[9][2])
    assert [b["doc_count"] for b in a["rings"]["buckets"]] == [1, 2, 1]
    a = agg("qa", SMALL_CASES[16][2], SMALL_CASES[16][1])
    assert a["to_answers"]["doc_count"] == 2


# ---------------------------------------------------------------------------
# the logs corpus: two segments with deletes, every type
# ---------------------------------------------------------------------------

TS = {"field": "@timestamp", "fixed_interval": "6h"}
LOGS_CASES = {
    "top_hits": (
        {"lv": {"terms": {"field": "level"},
                "aggs": {"top": {"top_hits": {"size": 3}}}}},
        {"t": {"top_hits": {"size": 7, "sort": [{"status": "desc"}]}},
         "t2": {"top_hits": {"size": 5, "sort": {"bytes": "asc"}}}}),
    "composite": (
        {"c": {"composite": {"size": 15, "sources": [
            {"lv": {"terms": {"field": "level", "missing_bucket": True}}},
            {"h": {"date_histogram": dict(TS, order="desc")}}]}}},
        {"c": {"composite": {"size": 7, "sources": [
            {"st": {"terms": {"field": "status"}}},
            {"tg": {"terms": {"field": "tags", "order": "desc",
                              "missing_bucket": True}}},
            {"b": {"histogram": {"field": "bytes", "interval": 5000,
                                 "missing_bucket": True}}}],
            "after": {"st": 304, "tg": None, "b": 5000.0}},
            "aggs": {"p": {"avg": {"field": "price"}},
                     "cs": {"cumulative_sum": {"buckets_path": "p"}}}}}),
    "significant_terms": (
        {"s": {"significant_terms": {"field": "level"}}},
        {"s": {"significant_terms": {"field": "tags", "size": 3},
               "aggs": {"p": {"max": {"field": "price"}}}}}),
    "significant_text": (
        {"s": {"significant_text": {"field": "msg", "min_doc_count": 2}}},
        {"s": {"significant_text": {"field": "msg", "shard_size": 50,
                                    "filter_duplicate_text": True}}}),
    "rare_terms": (
        {"r": {"rare_terms": {"field": "host.keyword",
                              "max_doc_count": 100}}},
        {"r": {"rare_terms": {"field": "items.sku", "max_doc_count": 30},
               "aggs": {"b": {"sum": {"field": "bytes"}}}}}),
    "multi_terms": (
        {"m": {"multi_terms": {"terms": [{"field": "level"},
                                         {"field": "status"}],
                               "size": 6},
               "aggs": {"p": {"min": {"field": "price"}}}}},),
    "variable_width_histogram": (
        {"v": {"variable_width_histogram": {"field": "bytes",
                                            "buckets": 6}}},),
    "ip_range": (
        {"ip": {"ip_range": {"field": "client", "ranges": [
            {"to": "10.1.0.0"}, {"from": "10.1.0.0", "to": "10.2.128.0"},
            {"mask": "10.3.0.0/16"}, {"from": "10.2.128.0"}]},
            "aggs": {"lv": {"terms": {"field": "level"}}}}},),
    "nested": (
        {"n": {"nested": {"path": "items"}, "aggs": {
            "sku": {"terms": {"field": "items.sku"}},
            "n": {"stats": {"field": "items.n"}}}}},),
    "children": (
        {"a": {"children": {"type": "answer"}, "aggs": {
            "lv": {"terms": {"field": "level"}}}}},),
    "parent": (
        {"q": {"parent": {"type": "answer"}, "aggs": {
            "st": {"terms": {"field": "status"}}}}},),
    "adjacency_matrix": (
        {"adj": {"adjacency_matrix": {"filters": {
            "err": {"term": {"level": "error"}},
            "slow": {"match": {"msg": "slow"}},
            "big": {"range": {"bytes": {"gte": 5000}}}},
            "separator": "+"},
            "aggs": {"p": {"avg": {"field": "price"}}}}},),
    "sampler": (
        {"s": {"sampler": {"shard_size": 40},
               "aggs": {"lv": {"terms": {"field": "level"}}}},
         "d": {"diversified_sampler": {"field": "tags", "shard_size": 25,
                                       "max_docs_per_value": 3},
               "aggs": {"st": {"stats": {"field": "bytes"}}}},
         "dn": {"diversified_sampler": {"field": "status",
                                        "shard_size": 30},
                "aggs": {"st": {"terms": {"field": "status"}}}}},),
    "auto_date_histogram": (
        {"a": {"auto_date_histogram": {"field": "@timestamp",
                                       "buckets": 20},
               "aggs": {"b": {"avg": {"field": "bytes"}}}}},
        {"a": {"auto_date_histogram": {"field": "@timestamp",
                                       "buckets": 3}}}),
    "geo": (
        {"gb": {"geo_bounds": {"field": "loc"}},
         "gc": {"geo_centroid": {"field": "loc"}},
         "gd": {"geo_distance": {"field": "loc", "origin": [2.35, 48.85],
                                 "unit": "km", "ranges": [
                                     {"to": 100}, {"from": 100, "to": 300},
                                     {"from": 300, "to": 10000},
                                     {"from": 10000}]},
                "aggs": {"c": {"geo_centroid": {"field": "loc"}}}}},
        {"gh": {"geohash_grid": {"field": "loc", "precision": 2},
                "aggs": {"c": {"geo_centroid": {"field": "loc"}},
                         "lv": {"terms": {"field": "level"}}}},
         "gt": {"geotile_grid": {"field": "loc", "precision": 5,
                                 "size": 7}},
         "gz": {"geotile_grid": {"field": "loc", "precision": 20}}},
        {"map": {"geotile_grid": {"field": "loc", "precision": 4},
                 "aggs": {"c": {"geo_centroid": {"field": "loc"}},
                          "b": {"geo_bounds": {"field": "loc"}},
                          "o": {"geo_centroid": {"field": "price"}}}},
         "hash": {"geohash_grid": {"field": "loc", "precision": 3,
                                   "size": 20},
                  "aggs": {"c": {"geo_centroid": {"field": "loc"}}}}}),
    "metrics": (
        {"sm": {"scripted_metric": {
            "init_script": "state.n = 0; state.b = 0.0",
            "map_script": "if (!doc['bytes'].empty) { state.n += 1; "
                          "state.b += doc['bytes'].value }",
            "combine_script": "return state",
            "reduce_script": "double b = 0; long n = 0; for (def s : "
                             "states) { b += s.b; n += s.n } return n == 0 "
                             "? 0 : b / n"}},
         "tt": {"t_test": {"a": {"field": "price",
                                 "filter": {"term": {"level": "error"}}},
                           "b": {"field": "price",
                                 "filter": {"term": {"level": "info"}}}}},
         "tp": {"t_test": {"a": {"field": "price"},
                           "b": {"field": "bytes"}, "type": "paired"}},
         "mad": {"median_absolute_deviation": {"field": "bytes"}},
         "bx": {"boxplot": {"field": "price"}},
         "tm": {"top_metrics": {"metrics": [{"field": "bytes"},
                                            {"field": "price"}],
                                "sort": {"status": "asc"}, "size": 4}},
         "ss": {"string_stats": {"field": "tags",
                                 "show_distribution": True}},
         "ms": {"matrix_stats": {"fields": ["price", "bytes",
                                            "status"]}}},),
    "pipelines": (
        {"h": {"date_histogram": TS, "aggs": {
            "b": {"sum": {"field": "bytes"}},
            "card": {"cardinality": {"field": "host.keyword"}},
            "pc": {"percentiles": {"field": "price", "percents": [25, 75]}},
            "mf": {"moving_fn": {"buckets_path": "b", "window": 4,
                                 "script": "MovingFunctions.sum(values)"}},
            "ma": {"moving_avg": {"buckets_path": "b", "window": 3}},
            "sd": {"serial_diff": {"buckets_path": "b", "lag": 2}},
            "mp": {"moving_percentiles": {"buckets_path": "pc",
                                          "window": 3}},
            "nz": {"normalize": {"buckets_path": "b",
                                 "method": "z-score"}},
            "cc": {"cumulative_cardinality": {"buckets_path": "card"}},
            "bs": {"bucket_script": {"buckets_path": {"b": "b",
                                                      "n": "_count"},
                                     "script": "params.b / params.n"}},
            "sel": {"bucket_selector": {"buckets_path": {"n": "_count"},
                                        "script": "params.n > 50"}}}},
         "cc": {"cumulative_cardinality": {"buckets_path": "h>card"}}},),
}
LOGS_BODIES = [
    {"size": 0},
    {"size": 0, "query": {"match": {"msg": "error timeout"}}},
    {"size": 3, "query": {"range": {"@timestamp": {
        "gte": iso(T0_MS + 3_600_000 * 5),
        "lt": iso(T0_MS + 3_600_000 * 40)}}},
     "sort": [{"@timestamp": "desc"}]},
]
LOGS_RUNS = [(kind, i) for kind, cases in LOGS_CASES.items()
             for i in range(len(cases))]


@pytest.mark.parametrize("bi", range(len(LOGS_BODIES)))
@pytest.mark.parametrize("kind,ci", LOGS_RUNS)
def test_logs_cases_equal_the_reference(nodes, kind, ci, bi):
    got = assert_same_answer(nodes, "logs",
                             dict(LOGS_BODIES[bi],
                                  aggs=LOGS_CASES[kind][ci]))
    assert "aggregations" in got, got


# ---------------------------------------------------------------------------
# composite: order, ties, missing buckets, after values, walks
# ---------------------------------------------------------------------------

COMPOSITE_SOURCES = [
    [{"lv": {"terms": {"field": "level", "missing_bucket": True}}}],
    [{"lv": {"terms": {"field": "level", "order": "desc",
                       "missing_bucket": True}}},
     {"st": {"terms": {"field": "status"}}}],
    [{"b": {"histogram": {"field": "bytes", "interval": 2000,
                          "order": "desc", "missing_bucket": True}}},
     {"tg": {"terms": {"field": "tags", "missing_bucket": True}}}],
    [{"d": {"date_histogram": {"field": "@timestamp",
                               "calendar_interval": "day"}}},
     {"h": {"terms": {"field": "host.keyword", "order": "desc"}}},
     {"c": {"histogram": {"field": "codes", "interval": 10,
                          "missing_bucket": True}}}],
]
COMPOSITE_AFTERS = [
    (0, {"lv": None}), (0, {"lv": "debug"}), (0, {"lv": "nope"}),
    (0, {}), (1, {"lv": None, "st": 200}), (1, {"lv": "warn", "st": 250}),
    (1, {"lv": "info"}), (2, {"b": None, "tg": "beta"}),
    (2, {"b": 4000, "tg": None}), (2, {"b": 3999.5, "tg": "zzz"}),
    (3, {"d": 0, "h": "h3", "c": 10.0}),
]


@pytest.mark.parametrize("ai", range(len(COMPOSITE_AFTERS)))
def test_composite_after_values_equal_the_reference(nodes, ai):
    """``after`` values present, absent, between keys, missing (None)
    and partial, over asc and desc sources of keyword, numeric, histogram
    and calendar values with missing buckets."""
    si, after = COMPOSITE_AFTERS[ai]
    for query in (None, {"match": {"msg": "api cache"}}):
        assert_same_answer(nodes, "logs", agg_body({"c": {"composite": {
            "size": 9, "sources": COMPOSITE_SOURCES[si], "after": after},
            "aggs": {"p": {"sum": {"field": "price"}}}}}, query))


@pytest.mark.parametrize("index,si", [("shop2", None), ("shop3", None)]
                         + [("logs", i)
                            for i in range(len(COMPOSITE_SOURCES))])
def test_composite_walk_equals_the_reference_page_by_page(nodes, index, si):
    """Walking ``after_key`` page by page: each page equals the
    reference's, and the pages concatenated equal one page of every
    bucket."""
    sources = ([{"cat": {"terms": {"field": "category"}}},
                {"q": {"histogram": {"field": "qty", "interval": 5,
                                     "missing_bucket": True}}}]
               if si is None else COMPOSITE_SOURCES[si])
    whole = assert_same_answer(nodes, index, agg_body(
        {"c": {"composite": {"size": 100_000, "sources": sources}}}))
    whole = whole["aggregations"]["c"]["buckets"]
    size = max(1, len(whole) // 5)
    walked, after, pages = [], None, 0
    for _ in range(len(whole) + 2):
        comp = {"size": size, "sources": sources}
        if after is not None:
            comp["after"] = after
        got = assert_same_answer(nodes, index, agg_body(
            {"c": {"composite": comp}}))["aggregations"]["c"]
        if not got["buckets"]:
            assert "after_key" not in got
            break
        pages += 1
        walked.extend(got["buckets"])
        after = got["after_key"]
    assert walked == whole and pages >= 5


# ---------------------------------------------------------------------------
# top_hits' ties, the grid's keys, the reference facts copied
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", ["asc", "desc"])
def test_top_hits_ties_order_by_docid_then_segment(nodes, order):
    """On ``status`` (four values over two segments) the hits tie in
    blocks; within one the order is (docid in its segment, segment):
    the reference's stable sort of (missing, key, docid)."""
    jax_node, node = nodes
    body = agg_body({"t": {"top_hits": {"size": 80, "sort": [
        {"status": order}]}}})
    got = assert_same_answer(nodes, "logs", body)
    hits = got["aggregations"]["t"]["hits"]["hits"]
    ids = [int(h["_id"]) for h in hits]
    local = [(i - SPLIT, 1) if i >= SPLIT else (i, 0) for i in ids]
    keys = [h["sort"][0] for h in hits]
    sign = -1 if order == "desc" else 1
    assert [(sign * k, d, s) for k, (d, s) in zip(keys, local)] == sorted(
        (sign * k, d, s) for k, (d, s) in zip(keys, local))
    assert {s for _, s in local} == {0, 1}


def test_unsorted_top_hits_and_samplers_take_docs_by_docid(nodes):
    """Reference facts the port copies: an unsorted top_hits returns the
    first ``size`` matched docs by segment and docid, not the best
    scored; a sampler keeps the first ``shard_size`` matched docs of
    each segment by docid."""
    _, node = nodes
    query = {"match": {"msg": "error"}}
    st, r = node.rest_controller.dispatch("POST", "/logs/_search", {}, {
        "size": 1000, "query": query, "_source": False,
        "sort": [{"_score": "desc"}]})
    assert st == 200
    matched = sorted(int(h["_id"]) for h in r["hits"]["hits"])
    best = r["hits"]["hits"][0]["_id"]
    got = assert_same_answer(nodes, "logs", dict(agg_body({
        "t": {"top_hits": {"size": 5}},
        "s": {"sampler": {"shard_size": 4},
              "aggs": {"ids": {"terms": {"field": "host.keyword",
                                         "size": 50}},
                       "hs": {"top_hits": {"size": 100}}}}}, query)))
    a = got["aggregations"]
    assert [int(h["_id"]) for h in a["t"]["hits"]["hits"]] == matched[:5]
    assert int(best) not in matched[:5]
    first = [i for i in matched if i < SPLIT][:4] + \
        [i for i in matched if i >= SPLIT][:4]
    assert sorted(int(h["_id"]) for h in a["s"]["hs"]["hits"]["hits"]) \
        == first
    assert a["s"]["doc_count"] == 8


def _tile_center(x, y, zoom):
    n = 1 << zoom
    lat = float(np.degrees(np.arctan(np.sinh(np.pi * (1 - 2 * (y + 0.5)
                                                      / n)))))
    return {"lat": lat, "lon": (x + 0.5) / n * 360.0 - 180.0}


def test_grid_keys_of_neighbour_tiles_equal_the_reference(tmp_path):
    """Tiles of seven-digit coordinates whose keys share a long prefix
    (and order by count, then key as strings) at several zooms, and
    geohashes at full precision: the cells' integer codes spell the
    reference's keys."""
    jax_node = JaxNode(data_path=str(tmp_path))
    node = Node(device="cpu")
    try:
        docs = [{"p": _tile_center(1_040_000, y, 20)}
                for y in (1_000_001, 1_000_009, 1_000_009, 1_000_123)]
        docs.append({"p": _tile_center(300_000, 400_000, 20)})
        for c in (jax_node.rest_controller, node.rest_controller):
            put(c, "tiles", {"properties": {"p": {"type": "geo_point"}}})
            fill(c, "tiles", docs)
        pair = (jax_node, node)
        for prec in (7, 16, 20, 24):
            got = assert_same_answer(pair, "tiles", agg_body({
                "g": {"geotile_grid": {"field": "p", "precision": prec},
                      "aggs": {"c": {"geo_centroid": {"field": "p"}}}},
                "h": {"geohash_grid": {"field": "p", "precision": 12}}}))
            keys = [(b["key"], b["doc_count"])
                    for b in got["aggregations"]["g"]["buckets"]]
            if prec == 20:
                assert keys == [("20/1040000/1000009", 2),
                                ("20/1040000/1000001", 1),
                                ("20/1040000/1000123", 1),
                                ("20/300000/400000", 1)]
    finally:
        node.close()
        jax_node.close()


@pytest.mark.parametrize("aggs,stage", [
    (SHOP_CASES["scripted_metric"][0], "script"),
    (SHOP_CASES["composite_multi"][0], "group"),
    (SHOP_CASES["top_hits_sorted"][2], "hits"),
    (SMALL_CASES[10][2], "cells")])
def test_profile_counts_the_aggregation_stages_once(nodes, aggs, stage):
    """``profile: true``: the aggregation's named host stage appears in
    the first shard's aggregations breakdown, and the breakdown sums to
    the coordinator's ``aggs_ns`` (each stage counted once)."""
    _, node = nodes
    index = "cities" if stage == "cells" else "shop2"
    st, r = node.rest_controller.dispatch(
        "POST", f"/{index}/_search", {}, dict(agg_body(aggs), profile=True))
    assert st == 200, r
    entry = r["profile"]["shards"][0]["aggregations"][0]
    assert entry["breakdown"][stage] > 0
    assert entry["time_in_nanos"] == sum(entry["breakdown"].values()) \
        == r["profile"]["coordinator"]["phases"]["aggs_ns"]


def test_join_aggs_across_segments_and_deletes(tmp_path):
    """tests/test_join_percolate.py's cross-segment case: the parent in
    one segment, its children in the next, a child deleted, and an
    unknown relation type, on both nodes."""
    pair = (JaxNode(data_path=str(tmp_path)), Node(device="cpu"))
    try:
        for c in (n.rest_controller for n in pair):
            put(c, "qa2", QA_MAPPINGS)
            fill(c, "qa2", [{"text": "the question", "join": "question"}],
                 ["q1"], ["r"])
            fill(c, "qa2", [{"text": "an answer",
                             "join": {"name": "answer", "parent": "q1"}}]
                 * 2, ["a1", "a2"], ["r", "r"])
        children = agg_body({"c": {"children": {"type": "answer"}}},
                            {"match": {"text": "question"}})
        parent = agg_body({"p": {"parent": {"type": "answer"}}},
                          {"match": {"text": "answer"}})
        got = assert_same_answer(pair, "qa2", children)
        assert got["aggregations"]["c"]["doc_count"] == 2
        got = assert_same_answer(pair, "qa2", parent)
        assert got["aggregations"]["p"]["doc_count"] == 1
        for c in (n.rest_controller for n in pair):
            st, r = c.dispatch("POST", "/qa2/_bulk", {"refresh": "true"},
                               json.dumps({"delete": {"_id": "a1",
                                                      "routing": "r"}})
                               + "\n")
            assert st == 200 and not r["errors"], r
        got = assert_same_answer(pair, "qa2", children)
        assert got["aggregations"]["c"]["doc_count"] == 1
        assert_same_answer(pair, "qa2", agg_body(
            {"c": {"children": {"type": "nope"}}}))
    finally:
        pair[1].close()
        pair[0].close()
