"""The aggregation collectors (ops/aggs.py) on the card against the same
ops on CPU tensors and a float64 oracle, and one aggs body served by a
CUDA node.

Counts, keys, min and max equal the CPU run exactly; the card's float32
sums are atomic adds in no fixed order, so sums and sums of squares are
held to the float64 oracle within rtol 1e-4 (and to the CPU run within
the same)."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.corpus import bench_cat
from elasticsearch_tpu_torch.index.segment import segment_from_numpy
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import aggs as agg_ops
from elasticsearch_tpu_torch.ops.device import DeviceSegment
from elasticsearch_tpu_torch.telemetry.engine import TRACKER

pytestmark = pytest.mark.cuda

RTOL = 1e-4
N = 300_000


@pytest.fixture(scope="module")
def columns():
    rng = np.random.default_rng(31)
    values = np.round(rng.lognormal(8.0, 1.2, N)).astype(np.float32)
    missing = rng.random(N) < 0.02
    values[missing] = 0.0
    mask = rng.random(N) < 0.6
    return values, missing, mask


def test_terms_counts_on_the_card(cuda_device):
    ords, terms = bench_cat(N)
    seg = segment_from_numpy({"keywords": {"cat": {"terms": terms,
                                                   "ords": ords}}})
    mask = np.zeros(DeviceSegment(seg, "cpu").n_docs_padded, bool)
    mask[:N] = np.random.default_rng(5).random(N) < 0.3
    out = []
    for dev in (cuda_device, "cpu"):
        perm, starts = DeviceSegment(seg, dev).keyword_ord_major("cat")
        out.append(agg_ops.terms_counts_per_term(
            perm, starts, torch.from_numpy(mask).to(dev)))
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_array_equal(
        out[0], np.bincount(ords[mask[:N]], minlength=len(terms)))


def test_metric_stats_on_the_card(cuda_device, columns):
    values, missing, mask = columns
    gpu = agg_ops.masked_metric_stats(*(torch.from_numpy(a).to(cuda_device)
                                        for a in columns))
    cpu = agg_ops.masked_metric_stats(*map(torch.from_numpy, columns))
    sel = mask & ~missing
    v = values[sel].astype(np.float64)
    assert gpu[0] == cpu[0] == int(sel.sum())
    assert gpu[2] == cpu[2] == float(v.min())
    assert gpu[3] == cpu[3] == float(v.max())
    np.testing.assert_allclose([gpu[1], gpu[4]], [v.sum(), (v * v).sum()],
                               rtol=RTOL)
    np.testing.assert_allclose([gpu[1], gpu[4]], [cpu[1], cpu[4]],
                               rtol=RTOL)


@pytest.mark.parametrize("nb", [48, 4096])
def test_bucket_collectors_on_the_card(cuda_device, columns, nb):
    values, missing, mask = columns
    ids = np.random.default_rng(nb).integers(0, nb, N).astype(np.int32)
    args = (ids, mask, values, missing)
    gpu = [agg_ops.bucket_counts(torch.from_numpy(ids).to(cuda_device),
                                 torch.from_numpy(mask).to(cuda_device), nb),
           agg_ops.bucket_metric_columns(
               *(torch.from_numpy(a).to(cuda_device) for a in args), nb)]
    cpu = [agg_ops.bucket_counts(torch.from_numpy(ids),
                                 torch.from_numpy(mask), nb),
           agg_ops.bucket_metric_columns(*map(torch.from_numpy, args), nb)]
    np.testing.assert_array_equal(gpu[0], cpu[0])
    np.testing.assert_array_equal(gpu[0], np.bincount(ids[mask],
                                                      minlength=nb))
    sel = mask & ~missing
    v = values.astype(np.float64)
    want_s = np.bincount(ids[sel], v[sel], minlength=nb)
    want_ss = np.bincount(ids[sel], v[sel] ** 2, minlength=nb)
    cnt, s, mn, mx, ss = gpu[1]
    np.testing.assert_array_equal(cnt, cpu[1][0])
    np.testing.assert_array_equal(mn, cpu[1][2])
    np.testing.assert_array_equal(mx, cpu[1][3])
    np.testing.assert_allclose(s, want_s, rtol=RTOL)
    np.testing.assert_allclose(ss, want_ss, rtol=RTOL)


def test_an_aggs_body_through_a_cuda_node(cuda_device):
    """The bench's match+terms-agg body shape on a CUDA node and on a CPU
    node over the same segment: equal aggregations, and every collector
    of the body launched on the card."""
    rng = np.random.default_rng(9)
    n = 250_000      # above DEVICE_AGG_MIN_DOCS: the device collectors
    ords, terms = bench_cat(n)
    word = rng.random(n) < 0.4
    docids = np.nonzero(word)[0].astype(np.int32)
    nb = (len(docids) + 127) // 128
    block_docids = np.zeros(nb * 128, np.int32)
    block_tfs = np.zeros(nb * 128, np.float32)
    block_docids[:len(docids)] = docids
    block_tfs[:len(docids)] = 1.0
    price = np.round(rng.random(n) * 100, 2)
    arrays = {"fields": {"title": dict(
        terms=["w"], doc_freq=np.array([len(docids)], np.int32),
        term_block_start=np.array([0]), term_block_count=np.array([nb]),
        block_docids=block_docids.reshape(nb, 128),
        block_tfs=block_tfs.reshape(nb, 128),
        field_lengths=np.ones(n, np.float32))},
        "keywords": {"cat": {"terms": terms, "ords": ords}},
        "numerics": {"price": {"values": price}}}
    body = {"query": {"match": {"title": "w"}}, "size": 0,
            "aggs": {"cats": {"terms": {"field": "cat"},
                              "aggs": {"p": {"avg": {"field": "price"}}}},
                     "st": {"stats": {"field": "price"}},
                     "h": {"histogram": {"field": "price", "interval": 5},
                           "aggs": {"s": {"sum": {"field": "price"}}}}}}
    answers = []
    kernels = [getattr(agg_ops, f).kernel_name for f in (
        "terms_counts_per_term", "masked_metric_stats", "bucket_counts",
        "bucket_metric_columns")]
    before = {name: TRACKER.calls(name) for name in kernels}
    for dev in (cuda_device, "cpu"):
        node = Node(device=dev)
        try:
            node.create_index("t", {"properties": {
                "title": {"type": "text"}, "cat": {"type": "keyword"},
                "price": {"type": "double"}}})
            node.indices["t"].engine.install_segments(
                [segment_from_numpy(arrays, name="t0")])
            st, r = node.rest_controller.dispatch("POST", "/t/_search", {},
                                                  body)
            assert st == 200, r
            answers.append(r)
        finally:
            node.close()
        if dev is cuda_device:
            for f, b in before.items():
                assert TRACKER.calls(f) > b, f
    gpu, cpu = answers
    assert gpu["hits"]["total"] == cpu["hits"]["total"]
    ga, ca = gpu["aggregations"], cpu["aggregations"]
    assert [(b["key"], b["doc_count"]) for b in ga["cats"]["buckets"]] == \
        [(b["key"], b["doc_count"]) for b in ca["cats"]["buckets"]]
    assert ga["cats"]["buckets"][0]["key"] == "c000"
    for g, c in zip(ga["cats"]["buckets"], ca["cats"]["buckets"]):
        assert g["p"]["value"] == pytest.approx(c["p"]["value"], rel=RTOL)
    assert (ga["st"]["count"], ga["st"]["min"], ga["st"]["max"]) == \
        (ca["st"]["count"], ca["st"]["min"], ca["st"]["max"])
    assert ga["st"]["sum"] == pytest.approx(
        float(price[word].astype(np.float32).astype(np.float64).sum()),
        rel=RTOL)
    assert [(b["key"], b["doc_count"]) for b in ga["h"]["buckets"]] == \
        [(b["key"], b["doc_count"]) for b in ca["h"]["buckets"]]
    for g, c in zip(ga["h"]["buckets"], ca["h"]["buckets"]):
        assert g["s"]["value"] == pytest.approx(c["s"]["value"], rel=RTOL)


# ---------------------------------------------------------------------------
# the 35 aggregation types earlier slices deferred: a CUDA node against a
# CPU node over the same seeded documents
# ---------------------------------------------------------------------------

SMALL_MAPPINGS = {"properties": {
    "title": {"type": "text"}, "cat": {"type": "keyword"},
    "tags": {"type": "keyword"}, "price": {"type": "double"},
    "qty": {"type": "long"}, "ts": {"type": "date"},
    "loc": {"type": "geo_point"}, "ip": {"type": "ip"},
    "items": {"type": "nested", "properties": {
        "sku": {"type": "keyword"}, "n": {"type": "integer"}}},
    "rel": {"type": "join", "relations": {"question": "answer"}}}}
WORDS = ["red", "green", "blue", "fast", "slow", "error", "cache", "api"]


def small_bulk(n=800, seed=41):
    """Seeded documents over every field type the deferred aggregations
    read; the first 100 are questions, the rest answers routed to one."""
    import json
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        d = {"title": " ".join(rng.choice(WORDS, int(rng.integers(1, 5)))),
             "cat": f"c{int(rng.integers(0, 12)):02d}",
             "price": float(np.round(rng.random() * 100, 2)),
             "ts": 1767225600000 + i * 600_000,
             "loc": {"lat": float(np.round(rng.uniform(-60, 70), 5)),
                     "lon": float(np.round(rng.uniform(-180, 180), 5))},
             "ip": f"10.{int(rng.integers(0, 3))}.{int(rng.integers(0, 256))}"
                   f".{int(rng.integers(0, 256))}"}
        if rng.random() < 0.8:
            d["qty"] = int(rng.integers(1, 50))
        if rng.random() < 0.7:
            d["tags"] = [str(t) for t in rng.choice(WORDS, 2)]
        if rng.random() < 0.6:
            d["items"] = [{"sku": f"s{int(rng.integers(0, 5))}",
                           "n": int(rng.integers(1, 9))}
                          for _ in range(int(rng.integers(1, 4)))]
        meta = {"_id": str(i)}
        if i < 100:
            d["rel"] = "question"
        else:
            parent = str(int(rng.integers(0, 100)))
            d["rel"] = {"name": "answer", "parent": parent}
            meta["routing"] = parent
        lines.append(json.dumps({"index": meta}) + "\n" + json.dumps(d)
                     + "\n")
    return "".join(lines)


CAT = {"field": "cat"}
DAILY = {"date_histogram": {"field": "ts", "fixed_interval": "12h"}}
DEFERRED_BODIES = {
    "adjacency_matrix": {"a": {"adjacency_matrix": {"filters": {
        "cheap": {"range": {"price": {"lt": 30}}},
        "red": {"match": {"title": "red"}}, "c01": {"term": {"cat": "c01"}}}}}},
    "auto_date_histogram": {"a": {"auto_date_histogram": {
        "field": "ts", "buckets": 8}, "aggs": {"p": {"avg": {"field": "price"}}}}},
    "boxplot": {"b": {"boxplot": {"field": "price"}}},
    "bucket_script": {"d": dict(DAILY, aggs={
        "p": {"sum": {"field": "price"}},
        "s": {"bucket_script": {"buckets_path": {"p": "p", "n": "_count"},
                                "script": "params.p / params.n"}}})},
    "bucket_selector": {"c": {"terms": CAT, "aggs": {
        "p": {"sum": {"field": "price"}},
        "s": {"bucket_selector": {"buckets_path": {"p": "p"},
                                  "script": "params.p > 3000"}}}}},
    "children": {"c": {"children": {"type": "answer"},
                       "aggs": {"cats": {"terms": CAT}}}},
    "composite": {"c": {"composite": {"size": 20, "sources": [
        {"cat": {"terms": {"field": "cat", "order": "desc"}}},
        {"q": {"histogram": {"field": "qty", "interval": 10,
                             "missing_bucket": True}}}],
        "after": {"cat": "c09", "q": None}},
        "aggs": {"p": {"max": {"field": "price"}}}}},
    "cumulative_cardinality": {"d": dict(DAILY, aggs={
        "u": {"cardinality": CAT},
        "cc": {"cumulative_cardinality": {"buckets_path": "u"}}})},
    "diversified_sampler": {"s": {"diversified_sampler": {
        "field": "cat", "shard_size": 40, "max_docs_per_value": 2},
        "aggs": {"p": {"avg": {"field": "price"}}}}},
    "geo_bounds": {"g": {"geo_bounds": {"field": "loc"}}},
    "geo_centroid": {"g": {"geo_centroid": {"field": "loc"}}},
    "geo_distance": {"g": {"geo_distance": {
        "field": "loc", "origin": "48.8566,2.3522", "unit": "km",
        "ranges": [{"to": 2000}, {"from": 2000, "to": 8000},
                   {"from": 8000}]}}},
    "geohash_grid": {"g": {"geohash_grid": {"field": "loc", "precision": 2},
                           "aggs": {"c": {"geo_centroid": {
                               "field": "loc"}}}}},
    "geotile_grid": {"g": {"geotile_grid": {"field": "loc", "precision": 3,
                                            "size": 30},
                           "aggs": {"p": {"avg": {"field": "price"}}}}},
    "ip_range": {"i": {"ip_range": {"field": "ip", "ranges": [
        {"to": "10.1.0.0"}, {"mask": "10.1.0.0/16"},
        {"from": "10.2.0.0"}]}}},
    "matrix_stats": {"m": {"matrix_stats": {"fields": ["price", "qty"]}}},
    "median_absolute_deviation": {"m": {"median_absolute_deviation": {
        "field": "price"}}},
    "moving_avg": {"d": dict(DAILY, aggs={
        "p": {"sum": {"field": "price"}},
        "m": {"moving_avg": {"buckets_path": "p", "window": 3}}})},
    "moving_fn": {"d": dict(DAILY, aggs={
        "p": {"sum": {"field": "price"}},
        "m": {"moving_fn": {"buckets_path": "p", "window": 3,
                            "script": "MovingFunctions.max(values)"}}})},
    "moving_percentiles": {"d": dict(DAILY, aggs={
        "p": {"percentiles": {"field": "price", "percents": [50]}},
        "m": {"moving_percentiles": {"buckets_path": "p", "window": 3}}})},
    "multi_terms": {"m": {"multi_terms": {"terms": [CAT, {"field": "tags"}],
                                          "size": 8}}},
    "nested": {"n": {"nested": {"path": "items"}, "aggs": {
        "s": {"terms": {"field": "items.sku"}}}}},
    "normalize": {"d": dict(DAILY, aggs={
        "p": {"sum": {"field": "price"}},
        "z": {"normalize": {"buckets_path": "p", "method": "z-score"}}})},
    "parent": {"p": {"parent": {"type": "answer"}}},
    "rare_terms": {"r": {"rare_terms": {"field": "tags",
                                        "max_doc_count": 100}}},
    "sampler": {"s": {"sampler": {"shard_size": 50},
                      "aggs": {"c": {"terms": CAT}}}},
    "scripted_metric": {"s": {"scripted_metric": {
        "init_script": "state.s = 0.0",
        "map_script": "state.s += doc['price'].value",
        "combine_script": "return state.s",
        "reduce_script": "double t = 0; for (def x : states) { t += x } "
                         "return t"}}},
    "serial_diff": {"d": dict(DAILY, aggs={
        "p": {"sum": {"field": "price"}},
        "s": {"serial_diff": {"buckets_path": "p", "lag": 2}}})},
    "significant_terms": {"s": {"significant_terms": {"field": "tags",
                                                      "min_doc_count": 2}}},
    "significant_text": {"s": {"significant_text": {"field": "title",
                                                    "min_doc_count": 2}}},
    "string_stats": {"s": {"string_stats": {"field": "tags",
                                            "show_distribution": True}}},
    "t_test": {"t": {"t_test": {
        "a": {"field": "price", "filter": {"term": {"cat": "c01"}}},
        "b": {"field": "price", "filter": {"term": {"cat": "c02"}}}}}},
    "top_hits": {"c": {"terms": {"field": "cat", "size": 3}, "aggs": {
        "t": {"top_hits": {"size": 2, "sort": [{"price": "desc"}]}}}}},
    "top_metrics": {"t": {"top_metrics": {"metrics": [{"field": "qty"}],
                                          "sort": {"ts": "desc"},
                                          "size": 3}}},
    "variable_width_histogram": {"v": {"variable_width_histogram": {
        "field": "price", "buckets": 6}}},
}


@pytest.fixture(scope="module")
def small_nodes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of csrc/ run only on "
                    "the card")
    nodes = [Node(device=torch.device("cuda", torch.cuda.current_device())),
             Node(device="cpu")]
    bulk = small_bulk()
    for node in nodes:
        c = node.rest_controller
        st, r = c.dispatch("PUT", "/small", {}, {
            "mappings": SMALL_MAPPINGS,
            "settings": {"index": {"number_of_shards": 2}}})
        assert st == 200, r
        st, r = c.dispatch("POST", "/small/_bulk", {"refresh": "true"}, bulk)
        assert st == 200 and not r["errors"], r
    yield nodes
    for node in nodes:
        node.close()


@pytest.mark.parametrize("agg_type", sorted(DEFERRED_BODIES))
def test_each_deferred_type_on_the_card_equals_the_cpu(small_nodes,
                                                       agg_type):
    """Each type on a CUDA node (its query masks on the card) equals a
    CPU node over the same documents, under match_all and a match:
    every key, count and value exactly (the aggregations are host
    numpy over the same masks)."""
    assert len(DEFERRED_BODIES) == 35
    for query in ({"match_all": {}}, {"match": {"title": "red cache"}}):
        body = {"size": 0, "query": query,
                "aggs": DEFERRED_BODIES[agg_type]}
        answers = [n.rest_controller.dispatch("POST", "/small/_search", {},
                                              body) for n in small_nodes]
        (st_g, gpu), (st_c, cpu) = answers
        assert st_g == st_c == 200, (gpu, cpu)
        assert gpu["_shards"]["failed"] == 0
        assert gpu["hits"]["total"] == cpu["hits"]["total"]
        assert gpu["aggregations"] == cpu["aggregations"]
