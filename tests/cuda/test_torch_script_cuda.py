"""Script scoring on the card against the same calls on the CPU.

One seeded corpus (``corpus.py`` ``build_corpus``) as one segment with
the reference bench's ``feat`` column (``bench_feat``) and a 32-d cosine
``vec`` field, resident on each device:

- a scripted plan cohort (Q = 8, the bench's script and two constant
  ``Math`` scripts) launched on the card equals the same cohort on the
  CPU;
- dense-executor script bodies (a vector function, function_score,
  min_score, a statement script, NaN and -inf scores) launch the
  contribution kernel on the card and answer as the CPU does.

Tolerance: ids, order and totals exact, scores rtol 1e-6 (the same
float32 operations on both devices; the vector function's bfloat16
product sums in another order on the card, held at rtol 1e-5)."""

import numpy as np
import pytest

from elasticsearch_tpu_torch.corpus import (bench_feat, build_corpus,
                                            make_queries, segment_from_corpus,
                                            term_name, unit_vectors)
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.search import batching
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.plan import bind_plan, compile_plan
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.search.searcher import ShardSearcher

pytestmark = pytest.mark.cuda

RTOL = 1e-6
N_DOCS, VOCAB, DIMS = 60000, 3000, 32
MAPPINGS = {"properties": {
    "title": {"type": "text"}, "feat": {"type": "double"},
    "vec": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"}}}


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(41)
    c = build_corpus(rng, N_DOCS, VOCAB)
    queries = make_queries(rng, c["df"], n_docs=N_DOCS, n_queries=16)
    seg = segment_from_corpus(
        c, name="script_cuda",
        numerics={"feat": {"values": bench_feat(N_DOCS)}},
        vectors={"vec": {"vectors": unit_vectors(N_DOCS, DIMS, 42)}})
    return seg, [" ".join(term_name(t) for t in q) for q in queries]


def searchers(seg, device):
    mapper = DocumentMapper(MAPPINGS)
    return (ShardSearcher([seg], mapper, DeviceSegmentCache(device)),
            ShardSearcher([seg], mapper, DeviceSegmentCache("cpu")))


BENCH_SCRIPT = "doc['feat'].value * 0.5 + _score"


def bench_body(text, source=BENCH_SCRIPT, params=None):
    return {"script_score": {"query": {"match": {"title": text}},
                             "script": {"source": source,
                                        "params": params or {}}}}


# the bench's script, and constant ones that read neither a column nor
# _score: their value is made on the CPU and must reach the card
@pytest.mark.parametrize("source,params", [
    (BENCH_SCRIPT, None), ("Math.log(10)", None),
    ("Math.max(params.a, 1)", {"a": 3})])
def test_scripted_plan_cohort_card_equals_cpu(cuda_device, corpus, source,
                                              params):
    seg, texts = corpus
    out = []
    for searcher in searchers(seg, cuda_device):
        ctx = searcher._contexts()[0]
        bps = []
        for t in texts[:8]:
            plan = compile_plan(parse_query(bench_body(t, source, params)),
                                searcher)
            assert plan is not None and plan.script is not None
            bps.append(bind_plan(plan, ctx, 1000))
        entries = [batching._Entry(bp) for bp in bps]
        batcher = batching.PlanBatcher()
        batcher._run(entries, ctx, 1000, searcher.k1, searcher.b)
        assert batcher.stats()["launches"] == 1
        out.append([e.result for e in entries])
    for (v0, i0, t0), (v1, i1, t1) in zip(*out):
        assert t0 == t1 > 0
        keep = v1 > -np.inf
        np.testing.assert_array_equal(i0[keep], i1[keep])
        np.testing.assert_allclose(v0[keep], v1[keep], rtol=RTOL, atol=0)


def dense_bodies(texts):
    qv = np.random.default_rng(43).standard_normal(DIMS)
    qv = (qv / np.linalg.norm(qv)).round(4).tolist()
    return [
        ({"script_score": {"query": {"match": {"title": texts[0]}},
                           "script": {"source": "cosineSimilarity(params.qv, "
                                                "'vec') + 1.0 + _score",
                                      "params": {"qv": qv}}}}, 1e-5),
        ({"function_score": {"query": {"match": {"title": texts[1]}},
                             "functions": [{"script_score": {"script": {
                                 "source": "doc['feat'].value"}},
                                 "weight": 2.0}, {"weight": 0.5}],
                             "score_mode": "sum",
                             "boost_mode": "multiply"}}, RTOL),
        ({"script_score": {"query": {"match": {"title": texts[2]}},
                           "script": {"source": "doc['feat'].value * 10 "
                                                "+ _score"},
                           "min_score": 10.0}}, RTOL),
        ({"script_score": {"query": {"match": {"title": texts[3]}},
                           "script": {"source": "double s = _score; if "
                                      "(doc['feat'].value > 0.5) { s += 1; }"
                                      " return s;"}}}, RTOL),
        ({"script_score": {"query": {"match": {"title": texts[4]}},
                           "script": {"source": "Math.log(doc['feat'].value"
                                                " - 0.5) + _score"}}}, RTOL),
    ]


@pytest.mark.parametrize("bi", range(5))
@pytest.mark.parametrize("allow_plan", [True, False])
def test_dense_script_bodies_card_equal_cpu(cuda_device, corpus, bi,
                                            allow_plan):
    seg, texts = corpus
    body, rtol = dense_bodies(texts)[bi]
    card, cpu = searchers(seg, cuda_device)
    before = gather_bm25_contrib.launches
    a = card.query_phase(parse_query(body), 500, allow_plan=allow_plan)
    if bi < 4 or not allow_plan:   # the last one plans when allowed
        assert gather_bm25_contrib.launches > before
    b = cpu.query_phase(parse_query(body), 500, allow_plan=allow_plan)
    assert a.total_hits == b.total_hits > 0
    assert len(a.docs) == len(b.docs)
    if rtol == RTOL:
        assert [d.docid for d in a.docs] == [d.docid for d in b.docs]
        np.testing.assert_allclose([d.score for d in a.docs],
                                   [d.score for d in b.docs], rtol=rtol,
                                   atol=0)
        return
    # a near tie may order apart: the same score for every doc both
    # return, and a doc only one returns ties the last score within rtol
    sa = {d.docid: d.score for d in a.docs}
    sb = {d.docid: d.score for d in b.docs}
    for docid in sa.keys() & sb.keys():
        assert sa[docid] == pytest.approx(sb[docid], rel=rtol)
    kth = b.docs[-1].score
    for docid in sa.keys() ^ sb.keys():
        assert sa.get(docid, sb.get(docid)) == pytest.approx(kth, rel=rtol)
