"""The ``rank_feature`` and ``rank_features`` field types and the
queries that read them (``rank_feature``, ``text_expansion`` /
``weighted_tokens``), the port against the reference on the CPU.

- The mapper: a value <= 0 is refused (MapperParsingException, a 400
  through ``_bulk``), each ``rank_features`` key becomes its own numeric
  column ``{field}.{key}``, equal to the reference's columns.
- ``rank_feature`` in all four functions (saturation with and without a
  pivot, log, sigmoid, linear) and with a negative score impact: the
  reference's tests/test_mapper_extras.py:146-182 at the executor level
  on both packages.
- ``text_expansion``: the dict and ``weighted_tokens`` forms, boost and
  the parse errors, on both nodes: the reference's
  tests/test_search_features.py:689-741.
- Device accounting: the feature columns are ``doc_values`` in
  ``HBM_SLAB_CLASSES``; the breaker charges exactly ``hbm_bytes()``, and
  a walk of the segment's tensors finds every byte.

Scores rtol 1e-5 (float32 elementwise math and a float32 weighted sum
in another order); masks, ids, order and totals exact.
"""

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.errors import \
    MapperParsingException as JaxMapperParsingException
from elasticsearch_tpu.common.errors import \
    ParsingException as JaxParsingException
from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.index.segment import SegmentWriter as JaxWriter
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.ops.device import DeviceSegment as JaxDeviceSegment
from elasticsearch_tpu.search.context import SegmentContext as JaxContext
from elasticsearch_tpu.search.context import ShardStats as JaxStats
from elasticsearch_tpu.search.queries import parse_query as jax_parse
from elasticsearch_tpu_torch.index.mapper import (DocumentMapper,
                                                  MapperParsingException)
from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops.device import DeviceSegment
from elasticsearch_tpu_torch.search.context import (DeviceSegmentCache,
                                                    SegmentContext,
                                                    ShardStats)
from elasticsearch_tpu_torch.search.queries import (ParsingException,
                                                    parse_query)
from elasticsearch_tpu_torch.telemetry.engine import TRACKER
from elasticsearch_tpu_torch.utils.breaker import CircuitBreaker
from test_torch_accounting import _tensors_held
from test_torch_dense import assert_same_page

RTOL = 1e-5

# the rank_feature(s) part of tests/test_mapper_extras.py's mapping and
# documents (the port maps none of that file's other field types yet)
MAPPINGS = {"properties": {
    "pagerank": {"type": "rank_feature"},
    "inverse_rank": {"type": "rank_feature",
                     "positive_score_impact": False},
    "topics": {"type": "rank_features"},
    "title": {"type": "text"},
}}
DOCS = [
    {"pagerank": 10.0, "inverse_rank": 1.0, "topics": {"sports": 20.0},
     "title": "quick brown fox"},
    {"pagerank": 2.0, "inverse_rank": 5.0, "topics": {"politics": 3.0},
     "title": "quick brawl"},
    {"pagerank": 5.0, "topics": {"sports": 1.0, "politics": 8.0},
     "title": "slow snail"},
]


@pytest.fixture(scope="module")
def ctxs():
    jm, pm = MapperService(mappings=MAPPINGS), DocumentMapper(MAPPINGS)
    jw, pw = JaxWriter(), SegmentWriter()
    for i, d in enumerate(DOCS):
        jw.add(jm.parse(str(i), d))
        pw.add(pm.parse(str(i), d))
    js, ps = jw.build("s0"), pw.build("s0")
    return (JaxContext(js, JaxDeviceSegment(js), jm, JaxStats([js])),
            SegmentContext(ps, DeviceSegment(ps, "cpu"), pm,
                           ShardStats([ps])))


def run_both(ctxs, body):
    """(port scores, port mask), both cut to the real docs, after
    checking them against the reference's."""
    jctx, pctx = ctxs
    js, jm = jax_parse(body).execute(jctx)
    ps, pm = parse_query(body).execute(pctx)
    n = pctx.segment.n_docs
    ps, pm = ps.numpy(), pm.numpy()
    np.testing.assert_array_equal(pm, np.asarray(jm))
    np.testing.assert_allclose(ps, np.asarray(js), rtol=RTOL, atol=0)
    return ps[:n], pm[:n]


# ---------------------------------------------------------------------------
# the mapper
# ---------------------------------------------------------------------------

def test_each_feature_key_is_its_own_column(ctxs):
    jctx, pctx = ctxs
    seg, jseg = pctx.segment, jctx.segment
    assert {"topics.sports", "topics.politics", "pagerank",
            "inverse_rank"} <= set(seg.numerics)
    assert "topics" not in seg.numerics and "topics" not in seg.postings
    for f, nv in seg.numerics.items():
        jnv = jseg.numerics[f]
        np.testing.assert_array_equal(nv.values, jnv.values)
        np.testing.assert_array_equal(nv.missing, jnv.missing)
    np.testing.assert_array_equal(seg.numerics["topics.sports"].missing,
                                  [False, True, False])
    assert pctx.device.numerics["topics.politics"].dtype == torch.float32


@pytest.mark.parametrize("doc", [
    {"pagerank": -1.0}, {"pagerank": 0}, {"topics": {"a": 0.0}},
    {"topics": {"a": 1.0, "b": -2.0}}, {"topics": 3.0},
    {"topics": [{"a": 1.0}, {"b": -1.0}]}])
def test_nonpositive_values_are_refused(doc):
    with pytest.raises(JaxMapperParsingException):
        MapperService(mappings=MAPPINGS).parse("x", doc)
    with pytest.raises(MapperParsingException):
        DocumentMapper(MAPPINGS).parse("x", doc)


def test_refused_documents_fail_their_bulk_item(tmp_path):
    """Through ``_bulk`` on both nodes: the bad item fails with a
    mapper_parsing_exception, the good ones index."""
    jax_node = JaxNode(data_path=str(tmp_path))
    node = Node(device="cpu")
    try:
        lines = "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                        + json.dumps(d) + "\n" for i, d in enumerate(
                            [DOCS[0], {"pagerank": -3.0}, DOCS[2]]))
        for c in (jax_node.rest_controller, node.rest_controller):
            c.dispatch("PUT", "/f", {}, {"mappings": MAPPINGS})
            st, r = c.dispatch("POST", "/f/_bulk", {"refresh": "true"},
                               lines)
            assert st == 200 and r["errors"]
            items = [next(iter(it.values())) for it in r["items"]]
            assert [it["status"] for it in items] == [201, 400, 201]
            assert items[1]["error"]["type"] == "mapper_parsing_exception"
    finally:
        node.close()
        jax_node.close()


def test_rank_feature_is_not_a_later_slice_type():
    m = DocumentMapper({"properties": {"r": {"type": "rank_feature"},
                                       "rs": {"type": "rank_features"}}})
    assert m.field_type("r").positive_score_impact is True
    assert m.field_type("rs").type_name == "rank_features"
    parsed = m.parse("1", {"r": "2.5", "rs": {"x": 1, "y": 0.5}})
    assert parsed.numeric_values == {"r": [2.5], "rs.x": [1.0],
                                     "rs.y": [0.5]}


# ---------------------------------------------------------------------------
# rank_feature (tests/test_mapper_extras.py:146-182)
# ---------------------------------------------------------------------------

def test_rank_feature_saturation(ctxs):
    scores, mask = run_both(ctxs, {"rank_feature": {
        "field": "pagerank", "saturation": {"pivot": 5.0}}})
    assert set(np.nonzero(mask)[0]) == {0, 1, 2}
    assert scores[0] == pytest.approx(10 / 15)
    assert scores[1] == pytest.approx(2 / 7)
    assert scores[0] > scores[2] > scores[1]


def test_rank_feature_default_pivot_is_the_mean(ctxs):
    scores, _ = run_both(ctxs, {"rank_feature": {"field": "pagerank"}})
    pivot = np.float32(17.0 / 3.0)
    assert scores[0] == pytest.approx(10 / (10 + pivot), rel=RTOL)


def test_rank_feature_log(ctxs):
    scores, _ = run_both(ctxs, {"rank_feature": {
        "field": "pagerank", "log": {"scaling_factor": 1.0}}})
    assert scores[0] == pytest.approx(np.log(11.0), rel=1e-5)


def test_rank_feature_sigmoid(ctxs):
    scores, _ = run_both(ctxs, {"rank_feature": {
        "field": "pagerank", "sigmoid": {"pivot": 5.0, "exponent": 1.0}}})
    assert scores[2] == pytest.approx(0.5)


def test_rank_feature_linear(ctxs):
    scores, _ = run_both(ctxs, {"rank_feature": {
        "field": "pagerank", "linear": {}, "boost": 2.0}})
    np.testing.assert_allclose(scores, [20.0, 4.0, 10.0])


def test_rank_feature_negative_impact(ctxs):
    scores, mask = run_both(ctxs, {"rank_feature": {
        "field": "inverse_rank", "saturation": {"pivot": 0.5}}})
    assert mask[0] and mask[1] and not mask[2]
    assert scores[0] > scores[1]
    for fn in ({"log": {"scaling_factor": 4.0}},
               {"sigmoid": {"pivot": 0.5, "exponent": 2.0}},
               {"linear": {}}, {}):
        run_both(ctxs, {"rank_feature": dict(fn, field="inverse_rank")})


def test_rank_features_query(ctxs):
    scores, mask = run_both(ctxs, {"rank_feature": {
        "field": "topics.sports", "saturation": {"pivot": 1.0}}})
    assert set(np.nonzero(mask)[0]) == {0, 2}
    assert scores[0] > scores[2]


def test_rank_feature_on_a_missing_field(ctxs):
    scores, mask = run_both(ctxs, {"rank_feature": {"field": "nope"}})
    assert not mask.any() and not scores.any()


def test_text_expansion_at_the_executor(ctxs):
    before = TRACKER.calls("feature_plane_sum")
    scores, mask = run_both(ctxs, {"text_expansion": {"topics": {
        "tokens": {"sports": 0.5, "politics": 2.0, "nope": 9.0}}}})
    assert TRACKER.calls("feature_plane_sum") == before + 1
    np.testing.assert_allclose(scores, [10.0, 6.0, 16.5], rtol=RTOL)
    assert mask.all()


# ---------------------------------------------------------------------------
# text_expansion over REST (tests/test_search_features.py:689-741)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("sparse")))
    node = Node(device="cpu")
    docs = {"s": {"1": {"expansion": {"quantum": 2.0, "physics": 1.0}},
                  "2": {"expansion": {"cooking": 3.0, "physics": 0.5}},
                  "3": {"expansion": {"gardening": 1.0}}},
            "s2": {"1": {"e": {"x": 2.0}}}}
    mappings = {"s": {"properties": {"expansion": {"type": "rank_features"}}},
                "s2": {"properties": {"e": {"type": "rank_features"}}}}
    for c in (jax_node.rest_controller, node.rest_controller):
        for index, dd in docs.items():
            assert c.dispatch("PUT", f"/{index}", {},
                              {"mappings": mappings[index]})[0] == 200
            lines = "".join(json.dumps({"index": {"_id": i}}) + "\n"
                            + json.dumps(d) + "\n" for i, d in dd.items())
            st, r = c.dispatch("POST", f"/{index}/_bulk",
                               {"refresh": "true"}, lines)
            assert st == 200 and not r["errors"], r
    yield jax_node, node
    node.close()
    jax_node.close()


def search_both(nodes, index, body):
    jax_node, node = nodes
    st, got = node.rest_controller.dispatch("POST", f"/{index}/_search", {},
                                            body)
    st2, ref = jax_node.rest_controller.dispatch("POST", f"/{index}/_search",
                                                 {}, body)
    assert st == st2 == 200, (got, ref)
    assert_same_page(got, ref)
    return got


def test_text_expansion_query(nodes):
    r = search_both(nodes, "s", {"query": {"text_expansion": {"expansion": {
        "tokens": {"quantum": 1.5, "physics": 1.0}}}}})
    hits = {h["_id"]: h["_score"] for h in r["hits"]["hits"]}
    assert set(hits) == {"1", "2"}
    assert hits["1"] == pytest.approx(1.5 * 2.0 + 1.0 * 1.0)
    assert hits["2"] == pytest.approx(1.0 * 0.5)
    r = search_both(nodes, "s", {"query": {"weighted_tokens": {"expansion": {
        "tokens": [{"token": "gardening", "weight": 2.0}]}}}})
    assert [h["_id"] for h in r["hits"]["hits"]] == ["3"]


def test_text_expansion_boost_and_errors(nodes):
    r1 = search_both(nodes, "s2", {"query": {"text_expansion": {"e": {
        "tokens": {"x": 1.0}}}}})
    r2 = search_both(nodes, "s2", {"query": {"text_expansion": {"e": {
        "tokens": {"x": 1.0}}, "boost": 3.0}}})
    r3 = search_both(nodes, "s2", {"query": {"text_expansion": {"e": {
        "tokens": {"x": 1.0}, "boost": 0.5}}}})
    s1 = r1["hits"]["hits"][0]["_score"]
    assert r2["hits"]["hits"][0]["_score"] == pytest.approx(3.0 * s1)
    assert r3["hits"]["hits"][0]["_score"] == pytest.approx(0.5 * s1)
    for bad in ({"text_expansion": {}},
                {"text_expansion": {"e": "nope"}},
                {"text_expansion": {"e": {"tokens": {}}}},
                {"text_expansion": {"e": {"tokens": [{"nope": 1}]}}},
                {"text_expansion": {"e": {"tokens": {"x": "NaNope"}}}}):
        with pytest.raises(JaxParsingException):
            jax_parse(bad)
        with pytest.raises(ParsingException):
            parse_query(bad)
        st, r = nodes[1].rest_controller.dispatch("POST", "/s2/_search", {},
                                                  {"query": bad})
        assert st == 400 and r["error"]["type"] == "parsing_exception", r


@pytest.mark.parametrize("body", [
    {"text_expansion": {"expansion": {"tokens": {"physics": 2.0}}}},
    {"bool": {"should": [
        {"text_expansion": {"expansion": {"tokens": {"physics": 2.0,
                                                     "cooking": 0.1}}}},
        {"rank_feature": {"field": "expansion.quantum"}}]}},
    {"bool": {"must": [{"weighted_tokens": {"expansion": {"tokens": [
        {"token": "physics", "weight": 1.0}]}}}],
        "must_not": [{"rank_feature": {"field": "expansion.cooking",
                                       "linear": {}}}]}},
])
def test_feature_queries_in_bools(nodes, body):
    search_both(nodes, "s", {"query": body})


# ---------------------------------------------------------------------------
# device accounting
# ---------------------------------------------------------------------------

def test_feature_columns_are_charged_doc_values(tmp_path):
    """Each feature column is a doc_values column of n_docs_padded
    float32 values and bools; the breaker holds exactly the segment's
    hbm_bytes(), and a walk of its tensors finds every byte."""
    node = Node(device="cpu", settings={"indices.breaker.hbm.limit": "1gb"})
    try:
        c = node.rest_controller
        c.dispatch("PUT", "/f", {}, {"mappings": MAPPINGS})
        lines = "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                        + json.dumps(d) + "\n" for i, d in enumerate(DOCS))
        c.dispatch("POST", "/f/_bulk", {"refresh": "true"}, lines)
        st, r = c.dispatch("POST", "/f/_search", {}, {"query": {
            "text_expansion": {"topics": {"tokens": {"sports": 1.0}}}}})
        assert st == 200 and r["hits"]["total"]["value"] == 2
        seg = node.indices["f"].engine.segments[0]
        cache = node.search_service.cache
        dev = cache.get(seg)
        nd = dev.n_docs_padded
        by_class = dev.hbm_bytes_by_class()
        assert by_class["doc_values"] == len(seg.numerics) * nd * (4 + 1)
        # the four feature columns and the written docs' _seq_no,
        # _primary_term and _version
        assert len(seg.numerics) == 4 + 3
        assert {"_seq_no", "_primary_term", "_version"} <= set(seg.numerics)
        br = node.breaker_service.get_breaker(CircuitBreaker.HBM)
        assert br.used == dev.hbm_bytes() == \
            cache.hbm_stats()["total_bytes"]
        assert sum(_tensors_held(dev).values()) == dev.hbm_bytes()
    finally:
        node.close()


def test_feature_columns_upload_as_the_reference_counts(ctxs):
    jctx, pctx = ctxs
    assert pctx.device.hbm_bytes_by_class()["doc_values"] == \
        jctx.device.hbm_bytes_by_class()["doc_values"]
    cache = DeviceSegmentCache("cpu")
    assert cache.get(pctx.segment).hbm_bytes() == pctx.device.hbm_bytes()
