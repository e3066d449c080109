"""The port's aggregations against the reference's, on the CPU.

- ``KeywordDocValues``: built by both SegmentWriters from the same
  seeded documents (keyword fields, multi-values, explicit multi-fields
  and a dynamic ``.keyword`` subfield), merged with deletes, and entered
  through ``segment_from_numpy``; the arrays bit-equal. The ord-major
  permutation (``DeviceSegment.keyword_ord_major``) equals the
  reference's. ``corpus.bench_cat`` draws the reference bench's column.
- The four collectors of ops/aggs.py on seeded arrays against the
  reference's jnp programs (and the terms counts against a host
  bincount).
- ``_search`` with ``aggs`` over REST on both nodes: every in-slice agg
  type, sub-aggs at depth, sibling and parent pipelines, ``post_filter``,
  ``min_score``, ``size`` 0 and > 0, ``track_total_hits`` false, an
  empty index and the ``rank.rrf`` query branch, on the reference's
  tests/test_aggregations.py shop corpus and on a seeded ~3k-doc corpus
  of two segments with deletes. Each body runs with
  ``DEVICE_AGG_MIN_DOCS`` at its default (every collector on the host)
  and at 0 in both packages (the device collectors on CPU tensors and
  on the reference's CPU jax).
- Every deferred agg type answers a typed 400; a collector that raises
  fails the request (a 500), never answers from the host.

Tolerance: keys, order, ``doc_count``, ``sum_other_doc_count``, ``min``
and ``max`` exact, and every value exact where both packages answer on
the host; device sums, averages and sums of squares rtol 1e-5 (float32
sums in another order).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.segment import KeywordDocValues as JaxKeywords
from elasticsearch_tpu.index.segment import merge_segments as jax_merge
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.ops import aggs as jax_aggs
from elasticsearch_tpu.ops.device import DeviceSegment as JaxDeviceSegment
from elasticsearch_tpu.search import aggregations as jax_aggregations
from elasticsearch_tpu_torch.corpus import bench_cat, bench_feat
from elasticsearch_tpu_torch.index.segment import merge_segments as port_merge
from elasticsearch_tpu_torch.index.segment import segment_from_numpy
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import aggs as agg_ops
from elasticsearch_tpu_torch.ops.device import READBACKS, DeviceSegment
from elasticsearch_tpu_torch.search import aggregations as port_aggregations
from elasticsearch_tpu_torch.telemetry.engine import TRACKER
from test_torch_dense import assert_same_page, build_both, iso

RTOL = 1e-5

# ---------------------------------------------------------------------------
# a seeded logs-shaped corpus with keyword, multi-valued and dynamic fields
# ---------------------------------------------------------------------------

MAPPINGS = {"properties": {
    "msg": {"type": "text"},
    "title": {"type": "text", "fields": {"raw": {"type": "keyword"}}},
    "level": {"type": "keyword"},
    "tags": {"type": "keyword"},
    "status": {"type": "integer"},
    "bytes": {"type": "long"},
    "price": {"type": "double"},
    "@timestamp": {"type": "date"},
    "codes": {"type": "short"},
    "vec": {"type": "dense_vector", "dims": 4, "similarity": "cosine"},
}}
WORDS = ["get", "post", "index", "login", "error", "timeout", "cache",
         "miss", "hit", "user", "admin", "api", "v1", "v2", "slow"]
LEVELS = ["info", "warn", "error", "debug"]
TAGS = ["alpha", "beta", "gamma", "delta", "eps", "zeta"]
T0_MS = 1767225600000          # 2026-01-01T00:00:00Z
STEP_MS = 60_000
N_DOCS = 3000
SPLIT = 1600                   # the first segment's docs
DELETED = [3, 17, 64, 500, 1599, 1600, 1700, 2222, 2999]


def corpus_docs(seed: int = 11, n: int = N_DOCS):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        ms = T0_MS + i * STEP_MS + int(rng.integers(0, 1000))
        doc = {"msg": " ".join(rng.choice(WORDS, int(rng.integers(1, 6)))),
               "title": str(rng.choice(WORDS)) + " " + str(
                   rng.choice(WORDS)),
               "@timestamp": iso(ms) if i % 3 else ms,
               "status": int(rng.choice([200, 200, 200, 304, 404, 500])),
               "price": float(np.round(rng.random() * 100, 2)),
               "host": f"h{int(rng.integers(0, 7))}",
               "vec": [float(x) for x in np.round(rng.standard_normal(4),
                                                  3)]}
        if rng.random() < 0.9:
            doc["level"] = str(rng.choice(LEVELS))
        if rng.random() < 0.8:
            doc["tags"] = [str(t) for t in
                           rng.choice(TAGS, int(rng.integers(1, 4)))]
        if rng.random() < 0.85:
            doc["bytes"] = int(rng.lognormal(8.0, 1.0))
        if rng.random() < 0.3:
            doc["codes"] = [int(c) for c in
                            rng.integers(0, 40, int(rng.integers(1, 4)))]
        docs.append(doc)
    return docs


def _bulk(docs, lo, hi):
    return "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                   + json.dumps(docs[i]) + "\n" for i in range(lo, hi))


SHOP_MAPPINGS = {"properties": {
    "category": {"type": "keyword"},
    "price": {"type": "double"},
    "qty": {"type": "long"},
    "sold_at": {"type": "date"},
    "name": {"type": "text"},
}}
# tests/test_aggregations.py's documents
SHOP_DOCS = [
    {"category": "fruit", "price": 1.0, "qty": 10, "sold_at": "2021-01-01",
     "name": "apple"},
    {"category": "fruit", "price": 2.0, "qty": 20, "sold_at": "2021-01-01",
     "name": "banana"},
    {"category": "fruit", "price": 3.0, "qty": 5, "sold_at": "2021-01-02",
     "name": "cherry"},
    {"category": "veg", "price": 4.0, "qty": 7, "sold_at": "2021-01-02",
     "name": "daikon"},
    {"category": "veg", "price": 5.0, "qty": 2, "sold_at": "2021-01-03",
     "name": "endive"},
    {"category": "meat", "price": 10.0, "sold_at": "2021-01-03",
     "name": "flank steak"},
]


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """The reference's and the port's node, each holding "shop" (one
    segment), "logs" (two segments, deletes in both) and "empty"."""
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("aggs")))
    node = Node(device="cpu")
    docs = corpus_docs()
    deletes = "".join(json.dumps({"delete": {"_id": str(i)}}) + "\n"
                      for i in DELETED)
    for c in (jax_node.rest_controller, node.rest_controller):
        for name, mappings in (("shop", SHOP_MAPPINGS), ("logs", MAPPINGS),
                               ("empty", SHOP_MAPPINGS)):
            st, _ = c.dispatch("PUT", f"/{name}", {}, {
                "mappings": mappings,
                "settings": {"index": {"number_of_shards": 1}}})
            assert st == 200
        st, r = c.dispatch("POST", "/shop/_bulk", {"refresh": "true"},
                           _bulk(SHOP_DOCS, 0, len(SHOP_DOCS)))
        assert st == 200 and not r["errors"], r
        for lo, hi in ((0, SPLIT), (SPLIT, len(docs))):
            st, r = c.dispatch("POST", "/logs/_bulk", {"refresh": "true"},
                               _bulk(docs, lo, hi))
            assert st == 200 and not r["errors"], r
        st, r = c.dispatch("POST", "/logs/_bulk", {"refresh": "true"},
                           deletes)
        assert st == 200 and not r["errors"], r
    yield jax_node, node
    node.close()
    jax_node.close()


# ---------------------------------------------------------------------------
# KeywordDocValues, the ord-major permutation, bench_cat
# ---------------------------------------------------------------------------

KW_FIELDS = ("level", "tags", "title.raw", "host.keyword")


def assert_keywords_equal(pkv, jkv, what):
    assert pkv.terms == list(jkv.terms), what
    for a in ("ords", "offsets", "all_ords"):
        got, ref = getattr(pkv, a), np.asarray(getattr(jkv, a))
        assert got.dtype == ref.dtype, f"{what}.{a}"
        np.testing.assert_array_equal(got, ref, err_msg=f"{what}.{a}")


@pytest.fixture(scope="module")
def built():
    """Both packages' segments of the corpus (two, deletes in both)."""
    docs = corpus_docs()
    (j0, _), (p0, _) = build_both(MAPPINGS, docs[:SPLIT], "k0")
    (j1, _), (p1, _) = build_both(MAPPINGS, docs[SPLIT:], "k1",
                                  offset=SPLIT)
    for d in DELETED:
        seg_j, seg_p, local = ((j0, p0, d) if d < SPLIT
                               else (j1, p1, d - SPLIT))
        seg_j.delete(local)
        seg_p.delete(local)
    return (j0, j1), (p0, p1)


def test_keyword_doc_values_match_reference(built):
    """Every keyword field and the dynamic ``host.keyword`` subfield: the
    port's terms, ords, offsets and all_ords equal the reference's, per
    segment and after a merge that drops the deleted docs."""
    (j0, j1), (p0, p1) = built
    for js, ps in ((j0, p0), (j1, p1)):
        assert sorted(ps.keywords) == sorted(js.keywords)
        assert set(KW_FIELDS) <= set(ps.keywords)
        for f in ps.keywords:
            assert_keywords_equal(ps.keywords[f], js.keywords[f],
                                  f"{ps.name}.{f}")
    mj = jax_merge("m", [j0, j1])
    mp = port_merge("m", [p0, p1])
    assert sorted(mp.keywords) == sorted(mj.keywords)
    for f in mp.keywords:
        assert_keywords_equal(mp.keywords[f], mj.keywords[f], f"merged {f}")


def test_merge_keeps_only_the_live_docs_terms():
    """A term held only by deleted docs leaves the merged dictionary, as
    in the reference."""
    docs = [{"level": "a"}, {"level": ["b", "c"]}, {"level": "c"}, {}]
    (js, _), (ps, _) = build_both(MAPPINGS, docs, "d0")
    js.delete(1)
    ps.delete(1)
    mj, mp = jax_merge("m", [js]), port_merge("m", [ps])
    assert mp.keywords["level"].terms == ["a", "c"]
    assert_keywords_equal(mp.keywords["level"], mj.keywords["level"],
                          "merged level")


def test_segment_from_numpy_keywords_and_bench_cat():
    """``bench_cat`` is the reference bench's draw (bench.py's
    ``default_rng(99)``: first the categories, then ``feat``), and
    through ``segment_from_numpy`` it equals the bench's
    KeywordDocValues; explicit offsets pass through; bad ords raise."""
    n = 5000
    ords, terms = bench_cat(n)
    rng2 = np.random.default_rng(99)
    ref = np.minimum((rng2.random(n) ** 2 * 500), 500 - 1).astype(np.int32)
    feat = rng2.random(n).astype(np.float64)
    np.testing.assert_array_equal(ords, ref)
    np.testing.assert_array_equal(bench_feat(n), feat)
    assert terms[0] == "c000" and terms[-1] == "c499" and len(terms) == 500
    seg = segment_from_numpy({"keywords": {"cat": {"terms": terms,
                                                   "ords": ords}}})
    assert seg.n_docs == n
    jkv = JaxKeywords("cat", terms, ords=ref,
                      offsets=np.arange(n + 1, dtype=np.int64),
                      all_ords=ref)
    assert_keywords_equal(seg.keywords["cat"], jkv, "cat")
    # a missing value and a multi-valued doc, given explicitly
    kv = segment_from_numpy({"keywords": {"k": {
        "terms": ["x", "y"], "ords": [0, -1, 0],
        "offsets": [0, 1, 1, 3], "all_ords": [0, 0, 1]}}}).keywords["k"]
    assert kv.get(0) == ["x"] and kv.get(1) == [] and kv.get(2) == ["x", "y"]
    with pytest.raises(ValueError, match="ords"):
        segment_from_numpy({"keywords": {"k": {"terms": ["x"],
                                               "ords": [0, 1]}}})
    with pytest.raises(ValueError, match="offsets"):
        segment_from_numpy({"keywords": {"k": {
            "terms": ["x"], "ords": [0], "offsets": [0, 2],
            "all_ords": [0]}}})


def test_keyword_ord_major_matches_reference(built):
    (j0, _), (p0, _) = built
    jdev, pdev = JaxDeviceSegment(j0), DeviceSegment(p0, "cpu")
    for f in KW_FIELDS:
        jperm, jstarts = jdev.keyword_ord_major(f)
        perm, starts = pdev.keyword_ord_major(f)
        assert perm.dtype == torch.int32 and starts.dtype == np.int64
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
        np.testing.assert_array_equal(starts, jstarts)
        # built once
        assert pdev.keyword_ord_major(f)[0] is perm
    assert pdev.keyword_ord_major("no_such_field") is None


# ---------------------------------------------------------------------------
# the collectors of ops/aggs.py
# ---------------------------------------------------------------------------

def ord_major(all_ords, offsets, n_terms):
    order = np.argsort(all_ords, kind="stable")
    pos_doc = np.searchsorted(offsets, np.arange(len(all_ords)),
                              side="right") - 1
    return (pos_doc[order].astype(np.int32),
            np.searchsorted(all_ords[order],
                            np.arange(n_terms + 1)).astype(np.int64))


@pytest.mark.parametrize("seed", range(3))
def test_terms_counts_match_reference(seed):
    rng = np.random.default_rng(seed)
    n_docs, n_terms = 5000, 37
    counts = rng.integers(0, 4, size=n_docs)
    offsets = np.zeros(n_docs + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    all_ords = rng.integers(0, n_terms - 3, size=int(counts.sum())
                            ).astype(np.int32)   # three empty terms
    mask = np.zeros(5120, bool)
    mask[:n_docs] = rng.random(n_docs) < 0.3
    perm, starts = ord_major(all_ords, offsets, n_terms)
    r0 = READBACKS["ops.aggs.terms_counts"]
    l0 = TRACKER.calls("terms_counts")
    got = agg_ops.terms_counts_per_term(torch.from_numpy(perm), starts,
                                        torch.from_numpy(mask))
    assert TRACKER.calls("terms_counts") == l0 + 1
    assert READBACKS["ops.aggs.terms_counts"] == r0 + 1
    ref = jax_aggs.terms_counts_per_term(jnp.asarray(perm), starts,
                                         jnp.asarray(mask))
    host = np.bincount(all_ords[np.repeat(mask[:n_docs], counts)],
                       minlength=n_terms)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got, host)


def f32_column(rng, n, missing_share=0.1):
    values = (rng.standard_normal(n) * 1000).astype(np.float32)
    missing = rng.random(n) < missing_share
    values[missing] = 0.0
    return values, missing


@pytest.mark.parametrize("seed", range(3))
def test_masked_metric_stats_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = 4096
    values, missing = f32_column(rng, n)
    for mask in (rng.random(n) < 0.4, np.zeros(n, bool)):
        args = (values, missing, mask)
        got = agg_ops.masked_metric_stats(*map(torch.from_numpy, args))
        ref = jax_aggs.masked_metric_stats(*map(jnp.asarray, args))
        assert got[0] == ref[0]
        if ref[0] == 0:
            assert got == (0, 0.0, None, None, 0.0)
            continue
        assert (got[2], got[3]) == (ref[2], ref[3])
        np.testing.assert_allclose([got[1], got[4]], [ref[1], ref[4]],
                                   rtol=RTOL)


@pytest.mark.parametrize("nb", [1, 37, 300, 8192])
def test_bucket_collectors_match_reference(nb):
    rng = np.random.default_rng(nb)
    n = 8192
    ids = rng.integers(0, nb, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    values, missing = f32_column(rng, n)
    got = agg_ops.bucket_counts(torch.from_numpy(ids),
                                torch.from_numpy(mask), nb)
    ref = jax_aggs.bucket_counts(jnp.asarray(ids), jnp.asarray(mask), nb)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    got = agg_ops.bucket_metric_columns(*map(torch.from_numpy, (
        ids, mask, values, missing)), nb)
    ref = jax_aggs.bucket_metric_columns(*map(jnp.asarray, (
        ids, mask, values, missing)), nb)
    np.testing.assert_array_equal(got[0], ref[0])       # counts
    np.testing.assert_array_equal(got[2], ref[2])       # min
    np.testing.assert_array_equal(got[3], ref[3])       # max
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL, atol=1e-3)
    np.testing.assert_allclose(got[4], ref[4], rtol=RTOL)


def test_bucket_cap_and_ladder_match_reference():
    for nb in (0, 1, 63, 64, 65, 1000, 8192, 8193):
        assert agg_ops.pow2_buckets(nb) == jax_aggs.pow2_buckets(nb)
    ids = torch.zeros(8, dtype=torch.int32)
    mask = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="AGG_BUCKET_CAP"):
        agg_ops.bucket_counts(ids, mask, agg_ops.AGG_BUCKET_CAP + 1)
    with pytest.raises(ValueError, match="AGG_BUCKET_CAP"):
        agg_ops.bucket_metric_columns(ids, mask, ids.float(), ~mask,
                                      agg_ops.AGG_BUCKET_CAP + 1)


# ---------------------------------------------------------------------------
# _search with aggs on both nodes
# ---------------------------------------------------------------------------

# float leaves held exactly even on the device route: min/max (the
# float32 column's own values) and keys, unless a pipeline (an agg named
# "p_...") computed them from device sums
EXACT_KEYS = {"min", "max", "key", "from", "to"}


def assert_same_aggs(got, ref, rtol, path="aggregations"):
    """Equal trees: dict keys and order of lists exactly; ints and
    strings exactly; floats exactly, or within ``rtol`` (device sums)
    unless the leaf is a min, max or key, or sits under an agg whose
    name starts with ``min``/``max``, and not under a pipeline named
    ``p_...``."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), \
            f"{path}: {sorted(got)} vs {sorted(ref)}"
        for k in ref:
            assert_same_aggs(got[k], ref[k], rtol, f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same_aggs(g, r, rtol, f"{path}[{i}]")
    elif isinstance(ref, float) and not isinstance(got, bool):
        last = path.rsplit(".", 1)[-1]
        names = path.split(".")
        exact = rtol == 0 or (
            (last in EXACT_KEYS
             or any(n.startswith(("min", "max")) for n in names))
            and not any(n.startswith("p_") for n in names))
        if exact:
            assert got == ref, f"{path}: {got!r} vs {ref!r}"
        else:
            assert got == pytest.approx(ref, rel=rtol, abs=1e-9), \
                f"{path}: {got!r} vs {ref!r}"
    else:
        assert type(got) is type(ref) and got == ref, \
            f"{path}: {got!r} vs {ref!r}"


SHOP_CASES = [
    {"avg_price": {"avg": {"field": "price"}},
     "sum_price": {"sum": {"field": "price"}},
     "min_price": {"min": {"field": "price"}},
     "max_price": {"max": {"field": "price"}},
     "n": {"value_count": {"field": "price"}},
     "st": {"stats": {"field": "price"}},
     "est": {"extended_stats": {"field": "price"}}},
    {"cats": {"cardinality": {"field": "category"}},
     "pct": {"percentiles": {"field": "price", "percents": [50]}},
     "ranks": {"percentile_ranks": {"field": "price", "values": [3.0]}}},
    {"by_cat": {"terms": {"field": "category"},
                "aggs": {"avg_price": {"avg": {"field": "price"}}}}},
    {"by_qty": {"terms": {"field": "qty", "size": 2}}},
    {"h": {"histogram": {"field": "price", "interval": 5.0}}},
    {"d": {"date_histogram": {"field": "sold_at", "calendar_interval": "day"}}},
    {"d": {"date_histogram": {"field": "sold_at", "fixed_interval": "12h"},
           "aggs": {"s": {"sum": {"field": "price"}},
                    "cs": {"cumulative_sum": {"buckets_path": "s"}},
                    "dv": {"derivative": {"buckets_path": "_count"}}}}},
    {"r": {"range": {"field": "price", "ranges": [
        {"to": 3.0}, {"from": 3.0, "to": 6.0}, {"from": 6.0}]}}},
    {"cheap": {"filter": {"range": {"price": {"lt": 3.0}}},
               "aggs": {"avg": {"avg": {"field": "price"}}}},
     "split": {"filters": {"filters": {
         "fruity": {"term": {"category": "fruit"}},
         "veggy": {"term": {"category": "veg"}}}}},
     "no_qty": {"missing": {"field": "qty"}},
     "g": {"global": {}, "aggs": {"all_avg": {"avg": {"field": "price"}}}}},
    {"by_cat": {"terms": {"field": "category"},
                "aggs": {"avg_p": {"avg": {"field": "price"}}}},
     "avg_of_avgs": {"avg_bucket": {"buckets_path": "by_cat>avg_p"}},
     "max_count": {"max_bucket": {"buckets_path": "by_cat"}},
     "pb": {"percentiles_bucket": {"buckets_path": "by_cat>avg_p"}},
     "esb": {"extended_stats_bucket": {"buckets_path": "by_cat>avg_p"}}},
    {"w": {"weighted_avg": {"value": {"field": "price"},
                            "weight": {"field": "qty"}}}},
    {"dr": {"date_range": {"field": "sold_at", "ranges": [
        {"to": "2021-01-02"}, {"from": "2021-01-02", "key": "late"}]},
        "aggs": {"n": {"value_count": {"field": "price"}}}}},
]
SHOP_QUERIES = [None, {"term": {"category": "fruit"}},
                {"range": {"price": {"lte": 3.0}}}]


def search_both(nodes, index, body):
    jax_node, node = nodes
    st, got = node.rest_controller.dispatch("POST", f"/{index}/_search", {},
                                            body)
    # the reference caches size-0 responses: each gate computes afresh
    st2, ref = jax_node.rest_controller.dispatch(
        "POST", f"/{index}/_search", {}, dict(body, request_cache=False))
    assert st == st2 == 200, (got, ref)
    return got, ref


@pytest.fixture(params=["host", "device"])
def gate(request, monkeypatch):
    """The collectors' doc gate: its default (every segment here is
    below it: the host route in both packages) or 0 in both (the device
    route: torch CPU tensors and the reference's CPU jax). The
    reference reads the global at call time."""
    if request.param == "device":
        monkeypatch.setattr(port_aggregations, "DEVICE_AGG_MIN_DOCS", 0)
        monkeypatch.setattr(jax_aggregations, "DEVICE_AGG_MIN_DOCS", 0)
        return RTOL
    return 0.0


@pytest.mark.parametrize("qi", range(len(SHOP_QUERIES)))
@pytest.mark.parametrize("ci", range(len(SHOP_CASES)))
def test_shop_aggs_match_reference(nodes, gate, ci, qi):
    body = {"size": 0, "aggs": SHOP_CASES[ci]}
    if SHOP_QUERIES[qi] is not None:
        body["query"] = SHOP_QUERIES[qi]
    got, ref = search_both(nodes, "shop", body)
    assert got["hits"]["total"] == ref["hits"]["total"]
    assert_same_aggs(got["aggregations"], ref["aggregations"], gate)


def test_shop_answers_as_the_reference_tests_assert(nodes):
    """A few of tests/test_aggregations.py's own assertions, on the
    port's node."""
    _, node = nodes

    def agg(aggs, **kw):
        st, r = node.rest_controller.dispatch("POST", "/shop/_search", {},
                                              {"size": 0, "aggs": aggs,
                                               **kw})
        assert st == 200, r
        return r["aggregations"]

    a = agg({"by_cat": {"terms": {"field": "category"}}})
    assert [(b["key"], b["doc_count"]) for b in a["by_cat"]["buckets"]] \
        == [("fruit", 3), ("veg", 2), ("meat", 1)]
    a = agg({"h": {"histogram": {"field": "price", "interval": 5.0}}})
    assert [(b["key"], b["doc_count"]) for b in a["h"]["buckets"]] == [
        (0.0, 4), (5.0, 1), (10.0, 1)]
    a = agg({"r": {"range": {"field": "price", "ranges": [
        {"to": 3.0}, {"from": 3.0, "to": 6.0}, {"from": 6.0}]}}})
    assert [b["doc_count"] for b in a["r"]["buckets"]] == [2, 3, 1]
    assert a["r"]["buckets"][0]["key"] == "*-3.0"
    a = agg({"w": {"weighted_avg": {"value": {"field": "price"},
                                    "weight": {"field": "qty"}}}})
    assert a["w"]["value"] == pytest.approx(
        (1 * 10 + 2 * 20 + 3 * 5 + 4 * 7 + 5 * 2) / (10 + 20 + 5 + 7 + 2))


LOGS_CASES = [
    # keyword terms: order, size, sub-metrics, multi-valued, multi-field,
    # dynamic .keyword
    {"lv": {"terms": {"field": "level", "size": 3,
                      "order": {"_key": "asc"}}}},
    {"tg": {"terms": {"field": "tags"},
            "aggs": {"avg_p": {"avg": {"field": "price"}},
                     "max_p": {"max": {"field": "price"}}}}},
    {"hs": {"terms": {"field": "host.keyword", "order": {"_count": "asc"}}},
     "tr": {"terms": {"field": "title.raw", "size": 5}}},
    # numeric terms (host), multi-valued numeric terms
    {"st": {"terms": {"field": "status"}},
     "cd": {"terms": {"field": "codes", "size": 4}}},
    # the fixed-interval histogram with device metric columns and parent
    # pipelines over them
    {"h": {"date_histogram": {"field": "@timestamp", "fixed_interval": "1h"},
           "aggs": {"avg_b": {"avg": {"field": "bytes"}},
                    "sum_b": {"sum": {"field": "bytes"}},
                    "max_b": {"max": {"field": "bytes"}},
                    "min_b": {"min": {"field": "bytes"}},
                    "n_b": {"value_count": {"field": "bytes"}},
                    "st_b": {"stats": {"field": "price"}},
                    "cs": {"cumulative_sum": {"buckets_path": "sum_b"}},
                    "dv": {"derivative": {"buckets_path": "_count"}}}}},
    # a calendar interval and extended_stats: the host
    {"h": {"date_histogram": {"field": "@timestamp",
                              "calendar_interval": "day"},
           "aggs": {"es": {"extended_stats": {"field": "bytes"}}}}},
    {"h": {"date_histogram": {"field": "@timestamp", "fixed_interval": "30m",
                              "min_doc_count": 25}}},
    {"h": {"histogram": {"field": "bytes", "interval": 1000},
           "aggs": {"st": {"stats": {"field": "price"}}}}},
    # a non-metric sub-agg and a multi-valued metric: the host
    {"h": {"histogram": {"field": "price", "interval": 10},
           "aggs": {"lv": {"terms": {"field": "level"}}}},
     "hc": {"histogram": {"field": "price", "interval": 25},
            "aggs": {"sum_c": {"sum": {"field": "codes"}}}}},
    # metrics: device-eligible, f32-inexact (@timestamp), multi-valued,
    # with missing
    {"avg_p": {"avg": {"field": "price"}},
     "sum_p": {"sum": {"field": "price"}},
     "min_b": {"min": {"field": "bytes"}},
     "max_b": {"max": {"field": "bytes"}},
     "n": {"value_count": {"field": "bytes"}},
     "st": {"stats": {"field": "bytes"}},
     "est": {"extended_stats": {"field": "price"}},
     "ts": {"stats": {"field": "@timestamp"}},
     "sum_c": {"sum": {"field": "codes"}},
     "avg_m": {"avg": {"field": "bytes", "missing": 0}}},
    {"pc": {"percentiles": {"field": "bytes", "percents": [50, 95, 99]}},
     "pr": {"percentile_ranks": {"field": "price", "values": [10, 50.5]}},
     "c1": {"cardinality": {"field": "level"}},
     "c2": {"cardinality": {"field": "tags"}},
     "c3": {"cardinality": {"field": "status"}},
     "w": {"weighted_avg": {"value": {"field": "price"},
                            "weight": {"field": "bytes"}}}},
    {"err": {"filters": {"filters": {
        "4xx": {"range": {"status": {"gte": 400, "lt": 500}}},
        "5xx": {"range": {"status": {"gte": 500}}}}},
        "aggs": {"lv": {"terms": {"field": "level"}}}},
     "e": {"filter": {"term": {"level": "error"}},
           "aggs": {"st": {"stats": {"field": "bytes"}}}}},
    {"r": {"range": {"field": "bytes", "ranges": [
        {"to": 1000}, {"from": 1000, "to": 5000, "key": "mid"},
        {"from": 5000}]},
        "aggs": {"avg_p": {"avg": {"field": "price"}}}},
     "dr": {"date_range": {"field": "@timestamp", "ranges": [
         {"to": iso(T0_MS + 3_600_000 * 10)},
         {"from": T0_MS + 3_600_000 * 10, "to": T0_MS + 3_600_000 * 30},
         {"from": iso(T0_MS + 3_600_000 * 30)}]},
         "aggs": {"n": {"value_count": {"field": "price"}}}},
     "mb": {"missing": {"field": "bytes"}},
     "mt": {"missing": {"field": "tags"},
            "aggs": {"sum_p": {"sum": {"field": "price"}}}}},
    {"g": {"global": {}, "aggs": {"avg_p": {"avg": {"field": "price"}},
                                  "lv": {"terms": {"field": "level"}}}}},
    # sibling pipelines and their sibling-form parents
    {"lv": {"terms": {"field": "level"},
            "aggs": {"avg_p": {"avg": {"field": "price"}}}},
     "h": {"histogram": {"field": "price", "interval": 20},
           "aggs": {"sum_b": {"sum": {"field": "bytes"}}}},
     "p_avg": {"avg_bucket": {"buckets_path": "lv>avg_p"}},
     "p_sum": {"sum_bucket": {"buckets_path": "h>sum_b"}},
     "p_lo": {"min_bucket": {"buckets_path": "lv>avg_p"}},
     "p_hi": {"max_bucket": {"buckets_path": "h"}},
     "p_st": {"stats_bucket": {"buckets_path": "h>sum_b"}},
     "p_es": {"extended_stats_bucket": {"buckets_path": "lv>avg_p",
                                        "sigma": 3}},
     "p_pc": {"percentiles_bucket": {"buckets_path": "h>sum_b",
                                     "percents": [25, 50]}},
     "p_cs": {"cumulative_sum": {"buckets_path": "h>sum_b"}},
     "p_dv": {"derivative": {"buckets_path": "h"}}},
    {"tg": {"terms": {"field": "tags", "size": 10},
            "aggs": {"avg_p": {"avg": {"field": "price"}},
                     "srt": {"bucket_sort": {"sort": [{"avg_p": "desc"}],
                                             "size": 3, "from": 1}}}}},
    # sub-aggs three deep
    {"lv": {"terms": {"field": "level"}, "aggs": {
        "h": {"date_histogram": {"field": "@timestamp",
                                 "fixed_interval": "6h"},
              "aggs": {"tg": {"terms": {"field": "tags", "size": 3},
                              "aggs": {"st": {"stats": {
                                  "field": "bytes"}}}}}}}}},
]
LOGS_BODIES = [
    {"size": 0},
    {"size": 0, "query": {"match": {"msg": "error timeout"}}},
    {"size": 5, "query": {"range": {"@timestamp": {
        "gte": iso(T0_MS + 3_600_000 * 5), "lt": iso(T0_MS + 3_600_000 * 40)}}},
     "sort": [{"@timestamp": "desc"}]},
    # the aggs see the query's docs, the hits the post-filtered ones
    {"size": 10, "query": {"match": {"msg": "api"}},
     "post_filter": {"term": {"level": "warn"}}},
    {"size": 10, "query": {"match": {"msg": "cache miss hit"}},
     "min_score": 0.95},
    {"size": 0, "query": {"bool": {"filter": [{"term": {"status": 500}}]}},
     "track_total_hits": False},
]


@pytest.mark.parametrize("bi", range(len(LOGS_BODIES)))
@pytest.mark.parametrize("ci", range(len(LOGS_CASES)))
def test_logs_aggs_match_reference(nodes, gate, ci, bi):
    body = dict(LOGS_BODIES[bi], aggs=LOGS_CASES[ci])
    got, ref = search_both(nodes, "logs", body)
    if body.get("track_total_hits", True):
        assert_same_page(got, ref)
    else:
        assert "total" not in got["hits"] and "total" not in ref["hits"]
        assert [h["_id"] for h in got["hits"]["hits"]] == \
            [h["_id"] for h in ref["hits"]["hits"]]
    assert_same_aggs(got["aggregations"], ref["aggregations"], gate)


def test_post_filter_and_min_score_shape_the_agg_masks(nodes):
    """The aggs count the docs of the query (min_score applied), not of
    the post_filter."""
    _, node = nodes
    c = node.rest_controller
    aggs = {"lv": {"terms": {"field": "level"}}}
    q = {"match": {"msg": "api"}}
    _, plain = c.dispatch("POST", "/logs/_search", {},
                          {"query": q, "aggs": aggs})
    _, post = c.dispatch("POST", "/logs/_search", {},
                         {"query": q, "aggs": aggs,
                          "post_filter": {"term": {"level": "warn"}}})
    assert post["aggregations"] == plain["aggregations"]
    assert post["hits"]["total"]["value"] < plain["hits"]["total"]["value"]
    _, ms = c.dispatch("POST", "/logs/_search", {},
                       {"query": q, "aggs": aggs, "min_score": 0.75})
    n = sum(b["doc_count"] for b in ms["aggregations"]["lv"]["buckets"])
    total = sum(b["doc_count"] for b in plain["aggregations"]["lv"]["buckets"])
    assert 0 < n < total


def test_empty_index_answers_aggregations(nodes, gate):
    body = {"size": 0, "aggs": SHOP_CASES[0] | SHOP_CASES[1] | {
        "by_cat": {"terms": {"field": "category"}},
        "h": {"histogram": {"field": "price", "interval": 5}},
        "f": {"filter": {"term": {"category": "veg"}}},
        "g": {"global": {}},
        "sb": {"sum_bucket": {"buckets_path": "by_cat"}}}}
    got, ref = search_both(nodes, "empty", body)
    assert got["hits"]["total"] == ref["hits"]["total"]
    assert_same_aggs(got["aggregations"], ref["aggregations"], 0.0)
    assert got["aggregations"]["by_cat"]["buckets"] == []
    # an empty aggs object asks no aggregation
    got, ref = search_both(nodes, "empty", {"size": 0, "aggs": {}})
    assert "aggregations" not in got and "aggregations" not in ref


def test_rrf_aggs_ride_the_query_branch(nodes, gate):
    """With rank.rrf the aggregations compute once, over the query
    branch, not over the kNN branch's hits."""
    body = {"query": {"match": {"msg": "login"}},
            "knn": {"field": "vec", "query_vector": [0.5, -0.2, 0.1, 0.9],
                    "k": 20, "num_candidates": 50},
            "rank": {"rrf": {}}, "size": 10, "_source": False,
            "aggs": {"lv": {"terms": {"field": "level"},
                            "aggs": {"avg_p": {"avg": {"field": "price"}}}},
                     "st": {"stats": {"field": "bytes"}}}}
    got, ref = search_both(nodes, "logs", body)
    assert_same_aggs(got["aggregations"], ref["aggregations"], gate)
    _, node = nodes
    _, alone = node.rest_controller.dispatch("POST", "/logs/_search", {}, {
        "query": body["query"], "size": 0, "aggs": body["aggs"]})
    assert got["aggregations"] == alone["aggregations"]


@pytest.mark.parametrize("agg_type",
                         sorted(port_aggregations.DEFERRED_AGGS))
def test_deferred_types_answer_a_typed_400(nodes, agg_type):
    """Each type the reference knows and this slice defers is a 400
    ``unsupported_in_slice_exception``, nested or not, before any agg
    of the tree is computed."""
    _, node = nodes
    for aggs in ({"x": {agg_type: {}}},
                 {"h": {"histogram": {"field": "price", "interval": 5},
                        "aggs": {"lv": {"terms": {"field": "category"},
                                        "aggs": {"x": {agg_type: {}}}}}}}):
        st, r = node.rest_controller.dispatch("POST", "/shop/_search", {},
                                              {"size": 0, "aggs": aggs})
        assert st == 400, r
        assert r["error"]["type"] == "unsupported_in_slice_exception"


def test_unknown_type_is_a_parsing_exception(nodes):
    for c in (n.rest_controller for n in nodes):
        st, r = c.dispatch("POST", "/shop/_search", {}, {
            "size": 0, "aggs": {"x": {"made_up": {"field": "price"}}}})
        assert st == 400 and r["error"]["type"] == "parsing_exception", r


# each collector, and a body that reaches it on the device route
COLLECTOR_BODIES = {
    "terms_counts_per_term": {"lv": {"terms": {"field": "level"}}},
    "masked_metric_stats": {"s": {"sum": {"field": "price"}}},
    "bucket_counts": {"h": {"histogram": {"field": "price",
                                          "interval": 10}}},
    "bucket_metric_columns": {"h": {"histogram": {
        "field": "price", "interval": 10},
        "aggs": {"s": {"sum": {"field": "bytes"}}}}},
}
COLLECTOR_SITES = {"terms_counts_per_term": "ops.aggs.terms_counts",
                   "masked_metric_stats": "ops.aggs.metric_stats",
                   "bucket_counts": "ops.aggs.bucket_counts",
                   "bucket_metric_columns": "ops.aggs.bucket_metrics"}


@pytest.mark.parametrize("name", sorted(COLLECTOR_BODIES))
def test_device_route_launches_each_collector(nodes, monkeypatch, name):
    """On the device route each collector launches once per segment
    (two on "logs") and reads back through the funnel; at the default
    gate none launches."""
    _, node = nodes
    c = node.rest_controller
    fn = getattr(agg_ops, name)
    site = COLLECTOR_SITES[name]
    body = {"size": 0, "aggs": COLLECTOR_BODIES[name]}
    l0, r0 = TRACKER.calls(fn.kernel_name), READBACKS[site]
    st, _ = c.dispatch("POST", "/logs/_search", {}, body)
    assert st == 200 and TRACKER.calls(fn.kernel_name) == l0 \
        and READBACKS[site] == r0
    monkeypatch.setattr(port_aggregations, "DEVICE_AGG_MIN_DOCS", 0)
    st, _ = c.dispatch("POST", "/logs/_search", {}, body)
    assert st == 200
    assert TRACKER.calls(fn.kernel_name) == l0 + 2 \
        and READBACKS[site] == r0 + 2


@pytest.mark.parametrize("name", sorted(COLLECTOR_BODIES))
def test_a_collector_that_raises_fails_the_request(nodes, monkeypatch,
                                                   name):
    """No host fallback: a device collector's error is the request's."""
    _, node = nodes

    def broken(*a, **k):
        raise RuntimeError("device collector failed")

    monkeypatch.setattr(port_aggregations, "DEVICE_AGG_MIN_DOCS", 0)
    monkeypatch.setattr(agg_ops, name, broken)
    st, r = node.rest_controller.dispatch(
        "POST", "/logs/_search", {},
        {"size": 0, "aggs": COLLECTOR_BODIES[name]})
    assert st == 500, r
    assert "device collector failed" in r["error"]["reason"]
