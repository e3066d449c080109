"""The port's dense_vector kNN path against the reference's, on the CPU.

The same seeded documents go through both packages (each its own mapper
and SegmentWriter, the same deletes) and the same bodies through both:

- the mapper: the dims bounds, a vector of the wrong length, the default
  similarity, a vector's JSON array as one value;
- the segment: ``VectorValues`` through ``SegmentWriter.build``,
  ``merge_segments`` with deletes, and ``segment_from_numpy``;
- the device slab: the bfloat16 bits (and a float32 slab's values),
  ``norms``, ``sq_norms`` and ``has_value`` against the reference's
  ``DeviceVectors``;
- ``knn_nominate_batch`` for cosine, dot_product and l2_norm on float32
  and bfloat16 slabs, with deletes and with ties at the cut;
- ``KnnQuery`` (``k``, ``num_candidates``, ``filter``) and ``exists``
  on a vector field, at the ops level;
- ``_search`` on both nodes: pure kNN (the KnnBatcher's cohort launch,
  deletes, big cuts), knn merged into the query, ``rank.rrf``, a
  filtered knn, knn on two segments, ``_merge_knn_into_query``;
- the KnnBatcher sharing one launch across concurrent callers.

Tolerances: float32 slab scores rtol 1e-5; bfloat16 nomination scores
atol 1e-4 (the two products sum in different orders), ids equal except
among scores that tie within that tolerance; answers through
``_search``: ids, order and totals exact, scores rtol 1e-6 (the exact
float32 re-rank is the same host formula on both sides), except where a
BM25 sum is in the score: the dense executor's rtol 1e-5
(tests/test_torch_dense.py).
"""

import json
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapper import MapperParsingException as \
    JaxMapperParsingException
from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.index.segment import SegmentWriter as JaxWriter
from elasticsearch_tpu.index.segment import merge_segments as jax_merge
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.ops import vector as jax_vec
from elasticsearch_tpu.ops.device import DeviceSegment as JaxDeviceSegment
from elasticsearch_tpu.search import service as jax_service
from elasticsearch_tpu.search.context import SegmentContext as JaxContext
from elasticsearch_tpu.search.context import ShardStats as JaxStats
from elasticsearch_tpu.search.queries import parse_query as jax_parse
from elasticsearch_tpu_torch.corpus import knn_query_vectors, unit_vectors
from elasticsearch_tpu_torch.index.mapper import (DenseVectorFieldType,
                                                  DocumentMapper,
                                                  MapperParsingException)
from elasticsearch_tpu_torch.index.segment import (SegmentWriter,
                                                   merge_segments,
                                                   segment_from_numpy)
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import vector as vec_ops
from elasticsearch_tpu_torch.ops.device import DeviceSegment
from elasticsearch_tpu_torch.search import service as port_service
from elasticsearch_tpu_torch.search.batching import KnnBatcher
from elasticsearch_tpu_torch.search.context import (DeviceSegmentCache,
                                                    SegmentContext,
                                                    ShardStats)
from elasticsearch_tpu_torch.search.queries import (ParsingException,
                                                    parse_query)
from test_torch_node import assert_same_hits

F32_RTOL = 1e-5
BF16_ATOL = 1e-4
SEARCH_RTOL = 1e-6
BM25_RTOL = 1e-5
SIMS = ("cosine", "dot_product", "l2_norm")
DIMS = 8
WORDS = ["quantum", "computing", "garden", "pasta", "river", "stone",
         "cloud", "forest"]


def make_docs(n, seed, sim="cosine", pool=0):
    """Seeded docs with a text field ``t``, a long ``n`` and an 8-d
    vector ``v`` on about 90 % of them; ``pool`` > 0 draws the vectors
    from that many distinct ones (exact ties in every score)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((max(pool, 1), DIMS))
    docs = []
    for i in range(n):
        d = {"t": " ".join(rng.choice(WORDS, int(rng.integers(1, 5)))),
             "n": int(rng.integers(0, 100))}
        if rng.random() < 0.9:
            v = (base[int(rng.integers(pool))] if pool
                 else rng.standard_normal(DIMS))
            if sim != "cosine":
                v = v * 0.5
            d["v"] = [float(x) for x in v]
        docs.append(d)
    return docs


def mappings(sim="cosine"):
    return {"properties": {"t": {"type": "text"}, "n": {"type": "long"},
                           "v": {"type": "dense_vector", "dims": DIMS,
                                 "similarity": sim}}}


def build_both(maps, docs, name, offset=0):
    jm, pm = MapperService(mappings=maps), DocumentMapper(maps)
    jw, pw = JaxWriter(), SegmentWriter()
    for i, d in enumerate(docs):
        jw.add(jm.parse(str(i + offset), d))
        pw.add(pm.parse(str(i + offset), d))
    return (jw.build(name), jm), (pw.build(name), pm)


def assert_topk_equiv(got_s, got_i, ref_s, ref_i, atol=0.0, rtol=0.0):
    """Equal scores within the tolerance, and equal ids except where two
    docs' scores tie within it (then either may stand at the slot, and
    the slot's id must be one of the reference's ids of that score)."""
    got_s, ref_s = np.asarray(got_s, np.float64), np.asarray(ref_s,
                                                            np.float64)
    assert got_s.shape == ref_s.shape
    np.testing.assert_allclose(got_s, ref_s, rtol=rtol, atol=atol)
    tol = atol + rtol * np.abs(ref_s)
    for j in np.nonzero(np.asarray(got_i) != np.asarray(ref_i))[0]:
        tied = np.abs(ref_s - ref_s[j]) <= 2 * tol[j]
        assert tied.sum() > 1, f"slot {j}: no tie explains the id"
        assert got_i[j] in set(np.asarray(ref_i)[tied]), f"slot {j}"


# ---------------------------------------------------------------------------
# mapper and segment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims,ok", [(0, False), (1, True), (2048, True),
                                     (2049, False), (4096, False)])
def test_dense_vector_dim_bounds(dims, ok):
    maps = {"properties": {"v": {"type": "dense_vector", "dims": dims}}}
    if ok:
        MapperService(mappings=maps)
        assert DocumentMapper(maps).field_type("v").dims == dims
        return
    with pytest.raises(JaxMapperParsingException) as ref:
        MapperService(mappings=maps)
    with pytest.raises(MapperParsingException) as got:
        DocumentMapper(maps)
    assert str(got.value) == str(ref.value)


def test_dense_vector_parse_as_the_reference():
    maps = {"properties": {"v": {"type": "dense_vector", "dims": 3}}}
    jm, pm = MapperService(mappings=maps), DocumentMapper(maps)
    ft = pm.field_type("v")
    assert isinstance(ft, DenseVectorFieldType)
    assert ft.similarity == "cosine"
    for bad in ([1.0, 2.0], [1.0, 2.0, 3.0, 4.0], [[1.0, 2.0, 3.0]]):
        with pytest.raises(JaxMapperParsingException) as ref:
            jm.parse("1", {"v": bad})
        with pytest.raises(MapperParsingException) as got:
            pm.parse("1", {"v": bad})
        assert str(got.value) == str(ref.value)
    jd = jm.parse("1", {"v": [1, 2.5, -3]})
    pd = pm.parse("1", {"v": [1, 2.5, -3]})
    assert pd.vectors["v"].dtype == np.float32
    np.testing.assert_array_equal(pd.vectors["v"], jd.vectors["v"])
    assert pd.vector_similarity == jd.vector_similarity == {"v": "cosine"}
    l2 = DocumentMapper({"properties": {"v": {
        "type": "dense_vector", "dims": 3, "similarity": "l2_norm"}}})
    assert l2.parse("1", {"v": [0, 0, 1]}).vector_similarity == {
        "v": "l2_norm"}


def assert_same_vectors(pv, jv):
    np.testing.assert_array_equal(pv.vectors, jv.vectors)
    np.testing.assert_array_equal(pv.has_value, jv.has_value)
    assert (pv.dims, pv.similarity) == (jv.dims, jv.similarity)
    assert pv.vectors.dtype == np.float32


@pytest.mark.parametrize("sim", SIMS)
def test_segment_vectors_build_and_merge(sim):
    """``SegmentWriter.build`` and ``merge_segments`` (deletes dropped,
    docids remapped) give the reference's VectorValues; a segment that
    lacks the field merges in as docs without a value."""
    docs = make_docs(60, 3, sim)
    (j0, jm), (p0, pm) = build_both(mappings(sim), docs[:40], "a")
    assert_same_vectors(p0.vectors["v"], j0.vectors["v"])
    (j1, _), (p1, _) = build_both(mappings(sim), docs[40:], "b", 40)
    plain = [{"t": "river stone"}, {"t": "cloud"}]
    (j2, _), (p2, _) = build_both({"properties": {"t": {"type": "text"}}},
                                  plain, "c", 60)
    for d in (0, 7, 33):
        j0.delete(d)
        p0.delete(d)
    j1.delete(5)
    p1.delete(5)
    jm_, pm_ = jax_merge("m", [j0, j1, j2]), merge_segments("m",
                                                          [p0, p1, p2])
    assert pm_.n_docs == jm_.n_docs == 60 - 4 + 2
    assert_same_vectors(pm_.vectors["v"], jm_.vectors["v"])
    assert pm_.stored.ids == jm_.stored.ids


def test_segment_from_numpy_vectors():
    """A vectors-only segment from numpy arrays: the float32 array is
    kept as given (the host copy of the re-rank), ``has_value`` and
    ``similarity`` default; mismatched shapes are refused."""
    vecs = unit_vectors(50, DIMS, 1)
    seg = segment_from_numpy({"vectors": {"v": {"vectors": vecs}}})
    vv = seg.vectors["v"]
    assert seg.n_docs == 50 and seg.postings == {}
    assert vv.vectors is vecs and vv.has_value.all()
    assert (vv.dims, vv.similarity) == (DIMS, "cosine")
    has = np.arange(50) % 3 > 0
    seg = segment_from_numpy({"vectors": {"v": {
        "vectors": vecs.astype(np.float64), "has_value": has,
        "similarity": "dot_product"}}})
    np.testing.assert_array_equal(seg.vectors["v"].vectors, vecs)
    assert seg.vectors["v"].similarity == "dot_product"
    with pytest.raises(ValueError):
        segment_from_numpy({"vectors": {"v": {"vectors": vecs,
                                              "has_value": has[:10]}}})
    with pytest.raises(ValueError):
        segment_from_numpy({"vectors": {"v": {"vectors": vecs[:, 0]}}})


# ---------------------------------------------------------------------------
# the device slab
# ---------------------------------------------------------------------------

def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_slab_bits_equal_the_reference(sim, dtype, monkeypatch):
    """The slab (bit for bit), norms, sq_norms and has_value of the
    port's DeviceVectors equal the reference's, padding included; zero
    vectors (docs without one) stay zero under cosine. The slab is built
    in row chunks smaller than the segment here."""
    docs = make_docs(1500, 5, sim)
    (js, _), (ps, _) = build_both(mappings(sim), docs, "s")
    jdt, pdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
                else (jnp.float32, torch.float32))
    jv = JaxDeviceSegment(js, vector_dtype=jdt).vectors["v"]
    monkeypatch.setattr(vec_ops, "ROW_CHUNK", 256)
    pv = DeviceSegment(ps, "cpu", vector_dtype=pdt).vectors["v"]
    assert pv.vectors.dtype == pdt
    np.testing.assert_array_equal(_bits(pv.vectors), _bits(jv.vectors))
    np.testing.assert_array_equal(pv.norms.numpy(), np.asarray(jv.norms))
    np.testing.assert_array_equal(pv.sq_norms.numpy(),
                                  np.asarray(jv.sq_norms))
    np.testing.assert_array_equal(pv.has_value.numpy(),
                                  np.asarray(jv.has_value))
    assert (pv.similarity, pv.dims) == (jv.similarity, jv.dims)


def test_host_norms_are_chunk_invariant(monkeypatch):
    vecs = unit_vectors(3000, 24, 9) * 3.0
    monkeypatch.setattr(vec_ops, "ROW_CHUNK", 128)
    np.testing.assert_array_equal(vec_ops.host_norms(vecs),
                                  np.linalg.norm(vecs, axis=1))


# ---------------------------------------------------------------------------
# knn_nominate_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pool", [0, 6])
def test_knn_nominate_batch_matches_reference(sim, dtype, pool):
    """A cohort of 8 queries (the Q bucket a batcher launches) with
    deletes: the top-128 scores and ids. ``pool`` 6 draws every vector
    from six distinct ones, so the cut falls inside a group of exactly
    equal scores and the lowest docids must win it on both sides."""
    docs = make_docs(700, 11, sim, pool=pool)
    (js, _), (ps, _) = build_both(mappings(sim), docs, "s")
    jdt, pdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
                else (jnp.float32, torch.float32))
    jv = JaxDeviceSegment(js, vector_dtype=jdt).vectors["v"]
    dev = DeviceSegment(ps, "cpu", vector_dtype=pdt)
    pv = dev.vectors["v"]
    nd = pv.vectors.shape[0]
    rng = np.random.default_rng(12)
    live = np.zeros(nd, bool)
    live[:len(docs)] = rng.random(len(docs)) > 0.1
    qs = rng.standard_normal((8, DIMS)).astype(np.float32)
    js_, ji = jax_vec.knn_nominate_batch(
        jnp.asarray(qs), jv.vectors, jv.sq_norms, jv.has_value,
        jnp.asarray(live), sim, 128)
    ps_, pi = vec_ops.knn_nominate_batch(
        torch.from_numpy(qs), pv.vectors, pv.sq_norms, pv.has_value,
        torch.from_numpy(live), sim, 128)
    js_, ji = np.asarray(js_), np.asarray(ji)
    ps_, pi = ps_.numpy(), pi.numpy()
    assert ps_.dtype == np.float32 and pi.dtype == np.int32
    tol = (dict(atol=BF16_ATOL) if dtype == "bfloat16"
           else dict(rtol=F32_RTOL))
    for r in range(len(qs)):
        fin = np.isfinite(js_[r])
        assert (np.isfinite(ps_[r]) == fin).all()
        assert_topk_equiv(ps_[r][fin], pi[r][fin], js_[r][fin], ji[r][fin],
                          **tol)
        assert live[pi[r][fin]].all()


@pytest.mark.parametrize("sim", SIMS)
def test_score_functions_match_reference(sim):
    """dot_scores, cosine_scores and l2_scores on a float32 slab, and
    the host exact re-rank formula, against the reference's."""
    rng = np.random.default_rng(4)
    slab = rng.standard_normal((300, DIMS)).astype(np.float32)
    qs = rng.standard_normal((3, DIMS)).astype(np.float32)
    sq = (slab * slab).sum(axis=1).astype(np.float32)
    js, ts = jnp.asarray(slab), torch.from_numpy(slab)
    pairs = [(jax_vec.dot_scores(jnp.asarray(qs), js),
              vec_ops.dot_scores(torch.from_numpy(qs), ts)),
             (jax_vec.cosine_scores(jnp.asarray(qs), js),
              vec_ops.cosine_scores(torch.from_numpy(qs), ts)),
             (jax_vec.l2_scores(jnp.asarray(qs), js, jnp.asarray(sq)),
              vec_ops.l2_scores(torch.from_numpy(qs), ts,
                                torch.from_numpy(sq)))]
    for ref, got in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=F32_RTOL, atol=1e-6)
    np.testing.assert_array_equal(
        vec_ops.exact_rerank_scores(slab[:50], qs[0], sim),
        jax_vec.exact_rerank_scores(slab[:50], qs[0], sim))


def test_bfloat16_product_has_float32_output():
    """A bfloat16 slab's scores come out float32 (not bfloat16, whose 8
    mantissa bits would tie in large groups) and equal the float32
    product of the bfloat16 values."""
    rng = np.random.default_rng(8)
    slab = torch.from_numpy(rng.standard_normal((400, 64)).astype(
        np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    assert vec_ops.matmul_route(slab) == "upcast"
    out = vec_ops.dot_scores(q, slab)
    assert out.dtype == torch.float32
    ref = q.to(torch.bfloat16).double() @ slab.double().T
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert len(np.unique(out.numpy())) == out.numel()


# ---------------------------------------------------------------------------
# KnnQuery and exists at the ops level
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=SIMS)
def knn_ctx(request):
    sim = request.param
    docs = make_docs(400, 21, sim)
    (js, jm), (ps, pm) = build_both(mappings(sim), docs, "s0")
    return (sim, JaxContext(js, JaxDeviceSegment(js), jm, JaxStats([js])),
            SegmentContext(ps, DeviceSegment(ps, "cpu"), pm,
                           ShardStats([ps])))


def knn_cases(sim):
    q = [float(x) for x in np.random.default_rng(31).standard_normal(DIMS)]
    return [
        {"knn": {"field": "v", "query_vector": q}},
        {"knn": {"field": "v", "query_vector": q, "k": 7}},
        {"knn": {"field": "v", "query_vector": q, "num_candidates": 25}},
        {"knn": {"field": "v", "query_vector": q, "k": 5,
                 "num_candidates": 12}},
        {"knn": {"field": "v", "query_vector": q, "k": 10,
                 "filter": {"range": {"n": {"gte": 50}}}}},
        {"knn": {"field": "v", "query_vector": q,
                 "filter": {"match": {"t": "quantum"}}}},
        {"knn": {"field": "nope", "query_vector": q}},
        {"exists": {"field": "v"}},
        {"bool": {"must": [{"match": {"t": "river"}}],
                  "should": [{"knn": {"field": "v", "query_vector": q,
                                      "k": 20}}]}},
    ]


@pytest.mark.parametrize("ci", range(9))
def test_knn_query_matches_reference(knn_ctx, ci):
    """(scores, mask) of each body on the bfloat16 slab: masks equal,
    scores within the bfloat16 tolerance (a doc the re-rank did not
    reach keeps its nominated score), the re-ranked ones within rtol
    1e-6. The cut keeps every tie of the kth score."""
    sim, jctx, pctx = knn_ctx
    body = knn_cases(sim)[ci]
    js, jmask = jax_parse(body).execute(jctx)
    ps, pmask = parse_query(body).execute(pctx)
    n = pctx.segment.n_docs
    js, jmask = np.asarray(js)[:n], np.asarray(jmask)[:n]
    ps, pmask = ps.numpy()[:n], pmask.numpy()[:n]
    np.testing.assert_array_equal(pmask, jmask)
    np.testing.assert_allclose(ps, js, atol=BF16_ATOL, rtol=0)
    exact = np.isclose(ps, js, rtol=SEARCH_RTOL, atol=0)
    if "knn" in body and "num_candidates" not in body["knn"]:
        # every doc re-ranked (3 k >= the docs): exact float32 scores
        assert exact[pmask].all()


def test_knn_query_dims_mismatch_is_a_400(knn_ctx):
    _, _, pctx = knn_ctx
    with pytest.raises(ParsingException, match="different number of "
                                               "dimensions"):
        parse_query({"knn": {"field": "v",
                             "query_vector": [1.0, 2.0]}}).execute(pctx)
    with pytest.raises(ParsingException):
        parse_query({"knn": {"query_vector": [1.0]}})


# ---------------------------------------------------------------------------
# _search on both nodes
# ---------------------------------------------------------------------------

def _bulk(controller, index, docs, lo, hi):
    bulk = "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                   + json.dumps(docs[i]) + "\n" for i in range(lo, hi))
    st, r = controller.dispatch("POST", f"/{index}/_bulk",
                                {"refresh": "true"}, bulk)
    assert st == 200 and not r["errors"], r


@pytest.fixture(scope="module")
def knn_nodes(tmp_path_factory):
    """Both nodes with the same indices: ``cos``, ``dot`` and ``l2``
    (one segment each, deletes in ``cos``), and ``two`` (two
    segments)."""
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("knn")))
    node = Node(device="cpu")
    for index, sim, n, segs, seed in (("cos", "cosine", 500, 1, 41),
                                      ("dot", "dot_product", 300, 1, 42),
                                      ("l2", "l2_norm", 300, 1, 43),
                                      ("two", "cosine", 400, 2, 44)):
        docs = make_docs(n, seed, sim)
        for c in (jax_node.rest_controller, node.rest_controller):
            st, _ = c.dispatch("PUT", f"/{index}", {}, {
                "mappings": mappings(sim),
                "settings": {"index": {"number_of_shards": 1}}})
            assert st == 200
            if segs == 2:
                _bulk(c, index, docs, 0, n // 2)
                _bulk(c, index, docs, n // 2, n)
            else:
                _bulk(c, index, docs, 0, n)
                if index == "cos":
                    dels = "".join(json.dumps({"delete": {"_id": str(i)}})
                                   + "\n" for i in range(0, n, 7))
                    st, r = c.dispatch("POST", "/cos/_bulk",
                                       {"refresh": "true"}, dels)
                    assert st == 200 and not r["errors"]
    yield jax_node, node
    node.close()
    jax_node.close()


def _qv(seed):
    return [round(float(x), 4)
            for x in np.random.default_rng(seed).standard_normal(DIMS)]


SEARCH_CASES = [
    # pure kNN: the cohort launch
    ("cos", {"knn": {"field": "v", "query_vector": _qv(1), "k": 10},
             "size": 10, "_source": False}, "batched"),
    ("cos", {"knn": {"field": "v", "query_vector": _qv(2), "k": 50,
                     "num_candidates": 100}, "size": 20,
             "_source": False}, "batched"),
    ("cos", {"knn": {"field": "v", "query_vector": _qv(3),
                     "num_candidates": 40}, "_source": False}, "batched"),
    ("dot", {"knn": {"field": "v", "query_vector": _qv(4), "k": 15},
             "size": 30, "_source": False}, "batched"),
    ("l2", {"knn": {"field": "v", "query_vector": _qv(5), "k": 15},
            "size": 15, "_source": False}, "batched"),
    # the dense executor: _source, a filter, a big cut, two segments
    ("cos", {"knn": {"field": "v", "query_vector": _qv(6), "k": 8},
             "size": 8}, "dense"),
    ("cos", {"knn": {"field": "v", "query_vector": _qv(7), "k": 10,
                     "filter": {"range": {"n": {"lt": 40}}}},
             "size": 10, "_source": False}, "dense"),
    ("cos", {"knn": {"field": "v", "query_vector": _qv(8), "k": 5000},
             "size": 500, "_source": False}, "dense"),
    ("two", {"knn": {"field": "v", "query_vector": _qv(9), "k": 12},
             "size": 12, "_source": False}, "dense"),
    ("cos", {"knn": {"field": "v", "query_vector": _qv(10), "k": 5},
             "size": 10, "_source": False, "track_total_hits": True},
     "dense"),
    # knn merged into the query (score sum)
    ("cos", {"query": {"match": {"t": "quantum garden"}},
             "knn": {"field": "v", "query_vector": _qv(11), "k": 20},
             "size": 25}, "bm25"),
    ("dot", {"query": {"match": {"t": "river"}},
             "knn": [{"field": "v", "query_vector": _qv(12), "k": 5},
                     {"field": "v", "query_vector": _qv(13), "k": 5}],
             "size": 20, "_source": False}, "bm25"),
    ("two", {"query": {"match": {"t": "stone"}},
             "knn": {"field": "v", "query_vector": _qv(14), "k": 10},
             "size": 15}, "bm25"),
    # rank.rrf: a batched knn branch (_source false), a dense one
    ("cos", {"query": {"match": {"t": "cloud forest"}},
             "knn": {"field": "v", "query_vector": _qv(15), "k": 30,
                     "num_candidates": 60},
             "rank": {"rrf": {}}, "size": 20, "_source": False}, "rrf"),
    ("l2", {"query": {"match": {"t": "pasta"}},
            "knn": {"field": "v", "query_vector": _qv(16), "k": 10},
            "rank": {"rrf": {"rank_constant": 20, "window_size": 15}},
            "size": 10}, "rrf"),
    ("two", {"knn": {"field": "v", "query_vector": _qv(17), "k": 10},
             "rank": {"rrf": {}}, "size": 5, "from": 2,
             "_source": False}, "rrf"),
    # exists on the vector field
    ("cos", {"query": {"exists": {"field": "v"}}, "size": 5}, "dense"),
]


def rrf_fusion(branches, k_const, from_, size, index):
    """(ids, scores, total) of the rank.rrf fusion of ``branches`` (each
    a list of hits, best first), ties by (index, id)."""
    scores = {}
    for hits in branches:
        for rank, h in enumerate(hits):
            scores[h["_id"]] = scores.get(h["_id"], 0.0) + 1.0 / (
                k_const + rank + 1)
    order = sorted(scores, key=lambda i: (-scores[i], (index, i)))
    page = order[from_:from_ + size]
    return page, [scores[i] for i in page], len(scores)


def rrf_branches(jax_node, node, index, body):
    """Each rank.rrf branch of ``body`` asked apart, as ``_rrf_search``
    asks it, on both nodes: [(reference hits, port hits)]. The
    reference's BM25 branch is asked one hit more (the tie-aware
    compare reads it)."""
    rrf = body["rank"]["rrf"]
    size, from_ = body.get("size", 10), body.get("from", 0)
    window = rrf.get("window_size", max(100, size + from_))
    source = body.get("_source", True)

    def ask(sub, extra=0):
        return tuple(c.dispatch("POST", f"/{index}/_search", {}, dict(
            sub, size=window + e))[1]["hits"]["hits"]
            for c, e in ((jax_node.rest_controller, extra),
                         (node.rest_controller, 0)))

    out = []
    if "query" in body:
        out.append(ask({"query": body["query"], "_source": source}, 1))
    for clause in port_service._knn_clauses(body["knn"]):
        pair = None
        if source is False:
            # the cohort launch, with the window as its size
            jsvc = jax_node.search_service
            jsearchers = [(index, s) for s in
                          jsvc.indices_service.get(index).shard_searchers()]
            psvc = node.search_service
            psearchers = [(index, s) for s in
                          psvc._shard_searchers(node.indices[index])]
            pair = (jsvc._knn_branch_hits(jsearchers, clause["knn"], window),
                    psvc._knn_branch_hits(psearchers, clause["knn"], window))
            assert (pair[0] is None) == (pair[1] is None)
        if pair is None or pair[0] is None:
            pair = ask({"query": clause, "_source": source})
        out.append(pair)
    return out


def check_rrf(jax_node, node, index, body, got, ref):
    """A fused answer: its kNN branches equal the reference's exactly;
    its BM25 branch equals the reference's up to the order inside a
    float32 tie (the reference's plan path sums through a global float32
    prefix, so a true tie can come out of it apart: test_torch_plan's
    tie-aware compare, rtol 1e-4); the port's answer is the fusion of
    its own branches; and where the two BM25 branches agree in order the
    two fused answers agree exactly."""
    rrf = body["rank"]["rrf"]
    branches = rrf_branches(jax_node, node, index, body)
    same_order = True
    for bi, (rh, ph) in enumerate(branches):
        if bi == 0 and "query" in body:
            # totals aside (a window of the branch, not its answer)
            page = [{"hits": {"total": {"value": 0, "relation": "eq"},
                              "hits": h}} for h in (ph, rh)]
            assert_same_hits(page[0], page[1], len(ph))
            same_order = [h["_id"] for h in ph] == \
                [h["_id"] for h in rh[:len(ph)]]
        else:
            assert [h["_id"] for h in ph] == [h["_id"] for h in rh]
            np.testing.assert_allclose([h["_score"] for h in ph],
                                       [h["_score"] for h in rh],
                                       rtol=SEARCH_RTOL, atol=0)
    ids, scores, total = rrf_fusion(
        [ph for _, ph in branches], rrf.get("rank_constant", 60),
        body.get("from", 0), body.get("size", 10), index)
    assert [h["_id"] for h in got["hits"]["hits"]] == ids
    assert [h["_score"] for h in got["hits"]["hits"]] == scores
    assert got["hits"]["total"]["value"] == total
    if same_order:
        assert [h["_id"] for h in got["hits"]["hits"]] == \
            [h["_id"] for h in ref["hits"]["hits"]]
        assert got["hits"]["total"] == ref["hits"]["total"]


@pytest.mark.parametrize("ci", range(len(SEARCH_CASES)))
def test_search_matches_reference(knn_nodes, ci):
    """Each body on both nodes: totals, ids and order exact; scores
    rtol 1e-6 (1e-5 where a BM25 sum is in them); a rank.rrf body
    branch by branch (``check_rrf``); the KnnBatcher launched exactly
    for the bodies the reference batches."""
    jax_node, node = knn_nodes
    index, body, kind = SEARCH_CASES[ci]
    jb = jax_node.search_service.knn_batcher
    pb = node.search_service.knn_batcher
    j0, p0 = jb.launches, pb.launches
    st, ref = jax_node.rest_controller.dispatch(
        "POST", f"/{index}/_search", {}, json.loads(json.dumps(body)))
    assert st == 200, ref
    st, got = node.rest_controller.dispatch(
        "POST", f"/{index}/_search", {}, json.loads(json.dumps(body)))
    assert st == 200, got
    assert (pb.launches - p0) == (jb.launches - j0)
    if kind == "batched":
        assert pb.launches - p0 == 1
    if kind == "rrf":
        check_rrf(jax_node, node, index, body, got, ref)
        return
    assert got["hits"]["total"] == ref["hits"]["total"]
    gh, rh = got["hits"]["hits"], ref["hits"]["hits"]
    assert [h["_id"] for h in gh] == [h["_id"] for h in rh]
    assert [h["_index"] for h in gh] == [h["_index"] for h in rh]
    assert [h.get("_source") for h in gh] == [h.get("_source") for h in rh]
    rtol = BM25_RTOL if kind == "bm25" else SEARCH_RTOL
    np.testing.assert_allclose([h["_score"] for h in gh],
                               [h["_score"] for h in rh], rtol=rtol, atol=0)
    if rh:
        assert got["hits"]["max_score"] == pytest.approx(
            ref["hits"]["max_score"], rel=rtol)
    assert len(gh) > 0 or kind == "dense"


def test_deletes_never_surface_from_the_cohort(knn_nodes):
    """Deleting the nearest doc after a search: the next cohort launch
    reads the new live mask (the signature keys the live version)."""
    jax_node, node = knn_nodes
    body = {"knn": {"field": "v", "query_vector": _qv(40), "k": 5},
            "size": 5, "_source": False}
    first = node.rest_controller.dispatch("POST", "/dot/_search", {},
                                          dict(body))[1]
    top = first["hits"]["hits"][0]["_id"]
    for c in (jax_node.rest_controller, node.rest_controller):
        st, r = c.dispatch("POST", "/dot/_bulk", {"refresh": "true"},
                           json.dumps({"delete": {"_id": top}}) + "\n")
        assert st == 200 and not r["errors"]
    launches = node.search_service.knn_batcher.launches
    st, got = node.rest_controller.dispatch("POST", "/dot/_search", {},
                                            dict(body))
    assert node.search_service.knn_batcher.launches == launches + 1
    ref = jax_node.rest_controller.dispatch("POST", "/dot/_search", {},
                                            dict(body))[1]
    ids = [h["_id"] for h in got["hits"]["hits"]]
    assert top not in ids
    assert ids == [h["_id"] for h in ref["hits"]["hits"]]
    assert got["hits"]["total"] == ref["hits"]["total"]


def test_rrf_fuses_its_own_branches(knn_nodes):
    """An rrf answer equals the fusion computed here from the node's
    own answers to its two branches asked apart as a user would ask
    them (the chip's gate: ``k`` equal to the window, as the reference
    bench's bodies have it)."""
    _, node = knn_nodes
    q = {"match": {"t": "garden stone"}}
    knn = {"field": "v", "query_vector": _qv(50), "k": 100,
           "num_candidates": 150}
    body = {"query": q, "knn": knn, "rank": {"rrf": {"rank_constant": 10}},
            "size": 30, "_source": False}
    fused = node.rest_controller.dispatch("POST", "/cos/_search", {},
                                          dict(body))[1]
    branches = [node.rest_controller.dispatch(
        "POST", "/cos/_search", {}, b)[1]["hits"]["hits"] for b in (
        {"query": q, "size": 100, "_source": False},
        {"knn": knn, "size": 100, "_source": False})]
    ids, scores, total = rrf_fusion(branches, 10, 0, 30, "cos")
    assert [h["_id"] for h in fused["hits"]["hits"]] == ids
    assert [h["_score"] for h in fused["hits"]["hits"]] == scores
    assert fused["hits"]["total"] == {"value": total, "relation": "gte"}


@pytest.mark.parametrize("body", [
    {"knn": {"field": "v", "query_vector": [1.0]}},
    {"query": {"match": {"t": "x"}}, "knn": {"field": "v",
                                             "query_vector": [1.0]}},
    {"knn": [{"field": "v", "query_vector": [1.0], "k": 3},
             {"field": "w", "query_vector": [0.5]}], "size": 4},
    {"knn": [{"field": "v", "query_vector": [1.0]}]},
])
def test_merge_knn_into_query_as_the_reference(body):
    assert port_service._merge_knn_into_query(body) == \
        jax_service._merge_knn_into_query(body)
    assert port_service._knn_clauses(body["knn"]) == \
        jax_service._knn_clauses(body["knn"])


def test_rank_errors(knn_nodes):
    _, node = knn_nodes
    c = node.rest_controller
    st, r = c.dispatch("POST", "/cos/_search", {}, {"rank": "rrf"})
    assert st == 400 and r["error"]["type"] == "illegal_argument_exception"
    st, r = c.dispatch("POST", "/cos/_search", {}, {"rank": {"rrf": {}}})
    assert st == 400 and "at least one of" in r["error"]["reason"]


# ---------------------------------------------------------------------------
# KnnBatcher
# ---------------------------------------------------------------------------

def one_cohort(batcher, ctx, field, qs, cut):
    """Each caller's (scores, ids) for ``qs`` asked at once from one
    thread each, while the batcher's launch slots are held until every
    caller has queued: the leader then pops them all as one cohort."""
    out = [None] * len(qs)

    def call(i):
        out[i] = batcher.topk(ctx, field, qs[i], cut)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(qs))]
    held = 0
    while batcher._launch_slots.acquire(blocking=False):
        held += 1
    try:
        for t in threads:
            t.start()
        while True:
            with batcher._lock:
                if sum(map(len, batcher._pending.values())) == len(qs):
                    break
            time.sleep(0.001)
    finally:
        for _ in range(held):
            batcher._launch_slots.release()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return out


def test_knn_batcher_shares_one_launch_across_callers():
    """24 callers at once on one slab: one cohort launch serves them,
    and each caller's row equals its query launched alone."""
    vecs = unit_vectors(3000, DIMS, 61)
    seg = segment_from_numpy({"vectors": {"v": {"vectors": vecs}}},
                             name="kb")
    ctx = SegmentContext(seg, DeviceSegmentCache("cpu").get(seg), None,
                         ShardStats([seg]))
    qs = knn_query_vectors(vecs, 24, np.random.default_rng(62))
    solo_batcher = KnnBatcher()
    solo = [solo_batcher.topk(ctx, "v", q, 300) for q in qs]
    assert solo_batcher.stats()["knn_launches"] == 24
    batcher = KnnBatcher()
    out = one_cohort(batcher, ctx, "v", qs, 300)
    assert batcher.stats() == {"knn_launches": 1,
                               "knn_batched_queries": len(qs),
                               "knn_avg_batch": float(len(qs))}
    for (s, i), (s0, i0) in zip(out, solo):
        np.testing.assert_array_equal(i, i0)
        np.testing.assert_array_equal(s, s0)
        assert len(i) == 300


def test_knn_batcher_caps_q_by_the_score_matrix(monkeypatch):
    """A cohort's [Q, ND] score matrix stays within KNN_SCORE_ELEMS:
    with a cap of two rows a cohort of five launches three times."""
    from elasticsearch_tpu_torch.search import batching
    vecs = unit_vectors(1000, DIMS, 71)
    seg = segment_from_numpy({"vectors": {"v": {"vectors": vecs}}},
                             name="kc")
    ctx = SegmentContext(seg, DeviceSegmentCache("cpu").get(seg), None,
                         ShardStats([seg]))
    monkeypatch.setattr(batching, "KNN_SCORE_ELEMS", 2 * 1024)
    batcher = KnnBatcher()
    entries = [batching._KnnEntry(q, 50) for q in
               knn_query_vectors(vecs, 5, np.random.default_rng(72))]
    dv = ctx.device.vectors["v"]
    batcher._run(entries, dv, ctx.device.live, 64)
    assert batcher.launches == 3 and batcher.batched_queries == 5
    solo = KnnBatcher()
    for e in entries:
        np.testing.assert_array_equal(
            KnnBatcher._finish(e, ctx, "v")[1],
            solo.topk(ctx, "v", e.qvec, 50)[1])


def test_knn_path_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seg = segment_from_numpy({"vectors": {"v": {
        "vectors": unit_vectors(10, DIMS, 1)}}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceSegmentCache()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceSegment(seg)
    assert DeviceSegment(seg, "cpu").vectors["v"].vectors.device.type \
        == "cpu"


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", json.dumps(body).encode(),
        {"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.load(resp)


def test_knn_bodies_reach_the_fallback_over_http():
    """Behind the C++ front, ``knn`` and ``rank`` bodies with ``_source:
    false`` on the index the front serves fast are refused by its
    grammar: they reach the fallback workers, and each answer equals
    ``RestController.dispatch`` of the body on the same node."""
    node = Node(device="cpu")
    try:
        docs = make_docs(200, 81)
        c = node.rest_controller
        c.dispatch("PUT", "/h", {}, {"mappings": mappings()})
        _bulk(c, "h", docs, 0, len(docs))
        port = node.start(0)
        bodies = [
            {"knn": {"field": "v", "query_vector": _qv(82), "k": 10},
             "size": 10, "_source": False},
            {"query": {"match": {"t": "river"}},
             "knn": {"field": "v", "query_vector": _qv(83), "k": 10},
             "rank": {"rrf": {}}, "size": 10, "_source": False},
            {"query": {"match": {"t": "river"}},
             "knn": {"field": "v", "query_vector": _qv(84), "k": 5},
             "size": 10, "_source": False},
        ]
        h0 = node.http_stats()
        for body in bodies:
            st, got = _post(port, "/h/_search", body)
            assert st == 200
            ref = c.dispatch("POST", "/h/_search", {}, dict(body))[1]
            assert got["hits"] == ref["hits"]
        h1 = node.http_stats()
        assert h1["fast"] == h0["fast"]
        assert h1["fallback"] - h0["fallback"] == len(bodies)
        assert node.fastpath.front_registration()["index"] == "h"
    finally:
        node.close()


@pytest.mark.parametrize("source,total", [(False, 15), (True, 5)])
def test_rrf_knn_branch_k_as_the_reference(knn_nodes, source, total):
    """A fact of the reference the port keeps for parity: a rank.rrf
    kNN branch through the cohort launch (``_source: false``) gives up
    to the window's hits of its nominated row (here 3 k = 15, past
    ``k`` = 5), while through the dense executor (``_source: true``)
    it keeps ``k``. Both nodes fuse the same number of docs."""
    jax_node, node = knn_nodes
    body = {"knn": {"field": "v", "query_vector": _qv(60), "k": 5},
            "rank": {"rrf": {}}, "size": 100, "_source": source}
    got, ref = (c.dispatch("POST", "/l2/_search", {}, dict(body))[1]
                for c in (node.rest_controller, jax_node.rest_controller))
    assert got["hits"]["total"] == ref["hits"]["total"] == {
        "value": total, "relation": "eq"}
    assert [h["_id"] for h in got["hits"]["hits"]] == \
        [h["_id"] for h in ref["hits"]["hits"]]
