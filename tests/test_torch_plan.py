"""The port's plan path against the reference's, on the CPU.

Searcher level: every body of the reference's plan test cases goes
through the reference ``ShardSearcher`` (JAX) and the port's
(``device="cpu"``) over the same postings and numeric columns: the
reference's three-segment fixture (seed 7), its segments carried into
the port with ``segment_from_numpy``. Cases holding a ``range`` clause
put a dense factor (``dense_mask``, and a ``bonus`` for a must factor)
into the plan launch on both sides. ``post_filter``, ``from`` and a k
larger than the postings are covered too.

Ops level: ``plan_topk`` / ``plan_topk_batch`` against the reference's
on seeded streams: both combine modes, pad groups, k larger than the
row, and ties at the kth value, where the lowest docid wins.

Tolerance: totals exact; scores rtol 1e-4; ids and order compared with
``assert_same_hits`` of test_torch_node.py (the reference sums float32
contributions through a global prefix, the port per run, so a near tie
may come out of the two in either order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.index.segment import SegmentWriter
from elasticsearch_tpu.ops import plan as jax_plan
from elasticsearch_tpu.search.context import \
    DeviceSegmentCache as JaxSegmentCache
from elasticsearch_tpu.search.queries import parse_query as jax_parse
from elasticsearch_tpu.search.searcher import ShardSearcher as JaxSearcher
from elasticsearch_tpu_torch.corpus import (PLAN_CASES, PLAN_MAPPINGS,
                                            PLAN_TAGS, PLAN_VOCAB)
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.index.segment import segment_from_numpy
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import plan as plan_ops
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.plan import compile_plan
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.search.searcher import ShardSearcher
from test_plan import CASES
from test_torch_node import assert_same_hits

RTOL = 1e-4

MAPPINGS = PLAN_MAPPINGS
FIELDS = ("title", "body", "tag")
VOCAB, TAGS = PLAN_VOCAB, PLAN_TAGS
# cases with a range clause: a dense factor in the plan launch
DENSE = {i for i, c in enumerate(CASES) if "range" in str(c)}


def carry(seg, fields=FIELDS):
    """A reference segment's postings (of ``fields``), numeric and
    keyword columns, ids and sources as a port Segment (the keyword
    columns carry a join's ``{field}#parent`` and a flattened field's
    keyed terms too)."""
    postings = {}
    for f in fields:
        pf = seg.postings[f]
        postings[f] = {a: np.asarray(getattr(pf, a)) for a in (
            "doc_freq", "total_term_freq", "term_block_start",
            "term_block_count", "block_docids", "block_tfs",
            "field_lengths")}
        postings[f]["terms"] = list(pf.terms)
    numerics = {f: {a: np.asarray(getattr(nv, a)) for a in (
        "values", "missing", "offsets", "all_values")}
        for f, nv in seg.numerics.items()}
    keywords = {f: {"terms": list(kv.terms),
                    **{a: np.asarray(getattr(kv, a)) for a in (
                        "ords", "offsets", "all_ords")}}
                for f, kv in seg.keywords.items()}
    return segment_from_numpy(
        {"fields": postings, "numerics": numerics, "keywords": keywords,
         "ids": list(seg.stored.ids),
         "sources": [seg.stored.source(d) for d in range(seg.n_docs)]},
        name=seg.name)


@pytest.fixture(scope="module")
def searchers():
    """The reference's plan fixture (seed 7, three segments) and the
    port's searcher over the same postings."""
    rng = np.random.default_rng(7)
    svc = MapperService(mappings=MAPPINGS)
    segments = []
    doc_no = 0
    for seg_i in range(3):
        w = SegmentWriter()
        for _ in range(rng.integers(40, 120)):
            n_title = int(rng.integers(1, 8))
            n_body = int(rng.integers(2, 20))
            doc = {
                "title": " ".join(rng.choice(VOCAB, n_title)),
                "body": " ".join(rng.choice(VOCAB, n_body)),
                "tag": str(rng.choice(TAGS)),
                "views": int(rng.integers(0, 100)),
            }
            w.add(svc.parse(str(doc_no), doc))
            doc_no += 1
        segments.append(w.build(f"s{seg_i}"))
    ref = JaxSearcher(segments, svc, JaxSegmentCache())
    port_segments = [carry(s) for s in segments]
    port = ShardSearcher(port_segments, DocumentMapper(MAPPINGS),
                         DeviceSegmentCache("cpu"))
    return ref, port


def as_hits(res, segments, lo=0):
    """A query result in the REST response's shape."""
    return {"hits": {
        "total": {"value": res.total_hits, "relation": "eq"},
        "hits": [{"_id": segments[d.segment_idx].stored.ids[d.docid],
                  "_score": d.score} for d in res.docs[lo:]]}}


def both(searchers, body, size, post_filter=None):
    """The port's page of ``size`` hits and the reference's answer with
    one hit more, as ``assert_same_hits`` takes them."""
    ref, port = searchers
    r = ref.query_phase(jax_parse(body), size + 1,
                        post_filter=None if post_filter is None
                        else jax_parse(post_filter))
    assert r.docs or not r.total_hits
    p = port.query_phase(parse_query(body), size,
                         None if post_filter is None
                         else parse_query(post_filter))
    return as_hits(p, port.segments), as_hits(r, ref.segments)


@pytest.mark.parametrize("size", [10, 500])
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_plan_cases_match_reference(searchers, ci, size):
    body = CASES[ci]
    if ci in DENSE:
        # the dense factor rides the plan launch on both sides
        assert compile_plan(parse_query(body), searchers[1]).dense
    got, ref = both(searchers, body, size)
    assert got["hits"]["total"]["value"] > 0, body
    assert_same_hits(got, ref, size, rtol=RTOL)


def test_plan_cases_are_the_reference_cases():
    """chip_smoke.py drives the plan path with the port's copy of the
    reference's cases (it cannot import the JAX package's tests)."""
    assert PLAN_CASES == CASES


def test_post_filter_matches_reference(searchers):
    got, ref = both(searchers, {"match": {"body": "wolf fox"}}, 500,
                    post_filter={"term": {"tag": "red"}})
    assert 0 < got["hits"]["total"]["value"] < 200
    assert_same_hits(got, ref, 500, rtol=RTOL)


def test_k_larger_than_the_postings(searchers):
    got, ref = both(searchers, {"match": {"title": "alpha"}}, 2000)
    assert len(got["hits"]["hits"]) == got["hits"]["total"]["value"]
    assert_same_hits(got, ref, 2000, rtol=RTOL)


def test_randomized_bool_trees(searchers):
    """Random plannable bool trees (the reference's fuzz without its
    range filters) agree with the reference."""
    rng = np.random.default_rng(11)

    def leaf():
        r = rng.random()
        if r < 0.5:
            n = int(rng.integers(1, 4))
            spec = {"query": " ".join(rng.choice(VOCAB, n))}
            if rng.random() < 0.25:
                spec["operator"] = "and"
            elif n > 1 and rng.random() < 0.3:
                spec["minimum_should_match"] = int(rng.integers(1, n + 1))
            return {"match": {str(rng.choice(["title", "body"])): spec}}
        if r < 0.7:
            return {"term": {"tag": str(rng.choice(TAGS))}}
        return {"terms": {"tag": [str(t) for t in
                                  rng.choice(TAGS, 2, replace=False)]}}

    for _ in range(12):
        b = {}
        if rng.random() < 0.8:
            b["must"] = [leaf() for _ in range(rng.integers(1, 3))]
        if rng.random() < 0.5:
            b["filter"] = [leaf()]
        if rng.random() < 0.4:
            b["must_not"] = [leaf()]
        if rng.random() < 0.5 or not b.get("must") and not b.get("filter"):
            b["should"] = [leaf() for _ in range(rng.integers(1, 3))]
            if rng.random() < 0.3:
                b["minimum_should_match"] = int(
                    rng.integers(1, len(b["should"]) + 1))
        got, ref = both(searchers, {"bool": b}, 500)
        assert_same_hits(got, ref, 500, rtol=RTOL)


def test_rest_from_and_typed_400s(searchers):
    """Through the port's REST layer on an index of three segments:
    ``from`` pages (a dense case too), later slices are typed 400s, and
    ``track_total_hits: false`` answers the exact hits without
    ``hits.total``."""
    ref, port = searchers
    node = Node(device="cpu")
    try:
        node.create_index("p", MAPPINGS)
        node.indices["p"].engine.install_segments(port.segments)
        c = node.rest_controller
        for body, lo, size in [(CASES[0], 5, 10), (CASES[12], 3, 4),
                               (CASES[9], 20, 30), (CASES[-1], 2, 5)]:
            st, got = c.dispatch("POST", "/p/_search", {},
                                 {"query": body, "from": lo, "size": size})
            assert st == 200, got
            r = ref.query_phase(jax_parse(body), lo + size + 1)
            assert len(got["hits"]["hits"]) == \
                max(0, min(size, len(r.docs) - lo))
            assert_same_hits(got, as_hits(r, ref.segments, lo), size,
                             rtol=RTOL)
            for h in got["hits"]["hits"]:
                assert h["_source"]["title"]
        for bad in ({"query": CASES[0], "timeout": "1s"},
                    {"query": CASES[0], "stored_fields": ["title"]}):
            st, r = c.dispatch("POST", "/p/_search", {}, bad)
            assert st == 400 and r["error"]["type"] == \
                "unsupported_in_slice_exception", (bad, r)
        # top_hits, once a later slice here, is served
        st, r = c.dispatch("POST", "/p/_search", {}, {
            "query": CASES[0], "size": 0,
            "aggs": {"t": {"top_hits": {"size": 3}}}})
        assert st == 200 and len(r["aggregations"]["t"]["hits"]["hits"]) \
            == min(3, r["hits"]["total"]["value"]), r
        st, exact = c.dispatch("POST", "/p/_search", {}, {"query": CASES[0]})
        st2, untracked = c.dispatch("POST", "/p/_search", {}, {
            "query": CASES[0], "track_total_hits": False})
        assert st == st2 == 200 and "total" not in untracked["hits"]
        assert untracked["hits"]["hits"] == exact["hits"]["hits"]
    finally:
        node.close()


# ---------------------------------------------------------------------------
# ops level
# ---------------------------------------------------------------------------

ND, TB, NB = 700, 40, 16


def corpus(seed):
    """Seeded blocks of docid-ascending postings (tf 1..4, padded with
    tf = 0 at docid 0) and the reserved zero block."""
    rng = np.random.default_rng(seed)
    bd = np.zeros((TB + 1, 128), np.int32)
    bt = np.zeros((TB + 1, 128), np.float32)
    for i in range(TB):
        n = int(rng.integers(20, 128))
        bd[i, :n] = np.sort(rng.choice(ND, n, replace=False))
        bt[i, :n] = rng.integers(1, 5, n)
    lens = rng.integers(4, 60, ND).astype(np.float32)
    live = rng.random(ND) > 0.05
    return bd, bt, lens, live


def selections(rng, n_real, ngroups, n_subs=3, const_p=0.3):
    """One stream's [NB] selection: ``n_real`` distinct blocks, then pads
    (the zero block, group = ngroups)."""
    sel = np.full(NB, TB, np.int32)
    grp = np.full(NB, ngroups, np.int32)
    sub = np.zeros(NB, np.int32)
    w = np.zeros(NB, np.float32)
    c = np.zeros(NB, bool)
    sel[:n_real] = rng.choice(TB, n_real, replace=False)
    grp[:n_real] = rng.integers(0, ngroups, n_real)
    sub[:n_real] = rng.integers(0, n_subs, n_real)
    w[:n_real] = rng.uniform(0.2, 2.0, n_real)
    c[:n_real] = rng.random(n_real) < const_p
    return sel, grp, sub, w, c


def groups(kinds, reqs, consts, pad_to=8):
    """Group tables padded with never-present FILTER groups."""
    kind = np.full(pad_to, plan_ops.FILTER, np.int32)
    req = np.full(pad_to, 1 << 30, np.int32)
    const = np.full(pad_to, np.nan, np.float32)
    kind[:len(kinds)] = kinds
    req[:len(reqs)] = reqs
    const[:len(consts)] = consts
    return kind, req, const


def both_ops(seed, sels, gk, gr, gc, n_must, n_filter, msm, bonus, tie,
             k, combine):
    bd, bt, lens, live = corpus(seed)
    avgs = (float(lens.mean()), float(lens.mean()) * 1.3)
    jstreams = [jax_plan.FieldStream(
        jnp.asarray(bd), jnp.asarray(bt), jnp.asarray(lens),
        jnp.float32(avg), *s) for s, avg in zip(sels, avgs)]
    # the reference's top k + 1, as assert_same_hits takes it
    rv, ri, rt = jax_plan.plan_topk(
        jstreams, gk, gr, gc, jnp.asarray(live), None, n_must, n_filter,
        msm, bonus=bonus, tie=tie, k=k + 1, combine=combine)
    tstreams = [plan_ops.FieldStream(
        torch.from_numpy(bd), torch.from_numpy(bt), torch.from_numpy(lens),
        avg, *s) for s, avg in zip(sels, avgs)]
    pv, pi, pt = plan_ops.plan_topk(
        tstreams, gk, gr, gc, torch.from_numpy(live), n_must, n_filter,
        msm, bonus=bonus, tie=tie, k=k, combine=combine)
    return ((pv.numpy(), pi.numpy(), int(pt)),
            (np.asarray(rv), np.asarray(ri), int(rt)))


def rows_as_hits(vals, ids, total):
    keep = np.isfinite(vals)
    return {"hits": {"total": {"value": total, "relation": "eq"},
                     "hits": [{"_id": str(i), "_score": float(v)}
                              for v, i in zip(vals[keep], ids[keep])]}}


@pytest.mark.parametrize("combine", ["sum", "dismax"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_topk_matches_reference(seed, combine):
    rng = np.random.default_rng(100 + seed)
    sels = [selections(rng, 12, 3), selections(rng, 9, 3)]
    # MUST(req 1) + SHOULD(req 2 of 3 subgroups) + constant SHOULD, then
    # a MUST_NOT over a pad-free group: pad groups fill the table to 8
    gk, gr, gc = groups([plan_ops.MUST, plan_ops.SHOULD, plan_ops.SHOULD],
                        [1, 2, 1], [np.nan, np.nan, 0.75])
    for k in (10, 300):
        got, ref = both_ops(seed, sels, gk, gr, gc, 1, 0, 0, 0.25, 0.3, k,
                            combine)
        assert got[2] == ref[2] > 0
        assert_same_hits(rows_as_hits(*got), rows_as_hits(*ref), k,
                         rtol=RTOL)
        np.testing.assert_allclose(got[0], ref[0][:k], rtol=RTOL)


def test_plan_topk_filters_must_not_and_msm():
    rng = np.random.default_rng(7)
    sels = [selections(rng, 14, 4, const_p=0.0), selections(rng, 10, 4)]
    gk, gr, gc = groups([plan_ops.SHOULD, plan_ops.SHOULD, plan_ops.FILTER,
                         plan_ops.MUST_NOT], [1, 1, 1, 1],
                        [np.nan, 0.5, np.nan, np.nan])
    got, ref = both_ops(7, sels, gk, gr, gc, 0, 1, 1, 0.0, 0.0, 50, "sum")
    assert got[2] == ref[2] > 0
    assert_same_hits(rows_as_hits(*got), rows_as_hits(*ref), 50, rtol=RTOL)


def test_k_larger_than_the_row_pads():
    """k above the row length (2 streams x NB x 128 lanes): the tail is
    (-inf, sentinel), as the reference pads."""
    rng = np.random.default_rng(3)
    sels = [selections(rng, 5, 2), selections(rng, 4, 2)]
    gk, gr, gc = groups([plan_ops.SHOULD, plan_ops.SHOULD], [1, 1],
                        [np.nan, np.nan])
    k = 2 * NB * 128 + 100
    got, ref = both_ops(3, sels, gk, gr, gc, 0, 0, 1, 0.0, 0.0, k, "sum")
    assert got[0].shape == (k,) and got[2] == ref[2]
    assert np.isneginf(got[0][got[2]:]).all()
    assert (got[1][got[2]:] == plan_ops._SENTINEL).all()
    assert_same_hits(rows_as_hits(*got), rows_as_hits(*ref), k, rtol=RTOL)


def test_ties_at_the_kth_value_keep_the_lowest_docids():
    """Every match scores the same constant: the k hits are the k lowest
    live matching docids, in ascending order, on both sides."""
    rng = np.random.default_rng(5)
    sels = [selections(rng, 10, 1, const_p=0.0)]
    gk, gr, gc = groups([plan_ops.SHOULD], [1], [1.5])
    got, ref = both_ops(5, sels, gk, gr, gc, 0, 0, 1, 0.0, 0.0, 25, "sum")
    bd, bt, _, live = corpus(5)
    sel = sels[0][0][:10]
    matched = np.unique(bd[sel][bt[sel] > 0])
    matched = matched[live[matched]]
    np.testing.assert_array_equal(got[1], matched[:25])
    np.testing.assert_array_equal(ref[1][:25], matched[:25])
    assert (got[0] == np.float32(1.5)).all() and got[2] == len(matched)


def test_plan_topk_batch_matches_reference_and_single_rows():
    """A cohort of 4 queries: each packed row equals the port's own
    single-query launch bit for bit, and the reference's batched row."""
    bd, bt, lens, live = corpus(9)
    rng = np.random.default_rng(9)
    q = 4
    per_q = [selections(rng, int(rng.integers(3, NB)), 3) for _ in range(q)]
    gk, gr, gc = groups([plan_ops.MUST, plan_ops.SHOULD, plan_ops.MUST_NOT],
                        [1, 1, 1], [np.nan, np.nan, np.nan])
    stack = [np.stack([s[i] for s in per_q]) for i in range(5)]
    avg = float(lens.mean())
    tstream = plan_ops.FieldStream(torch.from_numpy(bd), torch.from_numpy(bt),
                                   torch.from_numpy(lens), avg, *stack)
    G = [np.stack([a] * q) for a in (gk, gr, gc)]
    scal = dict(n_must=np.ones(q, np.int32), n_filter=np.zeros(q, np.int32),
                msm=np.zeros(q, np.int32),
                bonus=np.array([0, .5, 0, 1], np.float32),
                tie=np.zeros(q, np.float32))
    k = 40
    got = plan_ops.plan_topk_batch([tstream], *G, torch.from_numpy(live),
                                   *scal.values(), k=k).numpy()
    jstream = jax_plan.FieldStream(jnp.asarray(bd), jnp.asarray(bt),
                                   jnp.asarray(lens), jnp.float32(avg),
                                   *stack)
    ref = np.asarray(jax_plan.plan_topk_batch(
        [jstream], *G, jnp.asarray(live), *scal.values(), k=k + 1))
    for qi in range(q):
        single = plan_ops.plan_topk(
            [tstream._replace(sel_blocks=stack[0][qi], sel_group=stack[1][qi],
                              sel_sub=stack[2][qi], sel_weight=stack[3][qi],
                              sel_const=stack[4][qi])],
            gk, gr, gc, torch.from_numpy(live), 1, 0, 0,
            bonus=float(scal["bonus"][qi]), k=k, packed=True).numpy()
        np.testing.assert_array_equal(got[qi], single)
        gv, gi, gt = plan_ops.unpack_result(got[qi], k)
        rv, ri, rt = plan_ops.unpack_result(ref[qi], k + 1)
        assert gt == rt
        assert_same_hits(rows_as_hits(gv, gi, gt), rows_as_hits(rv, ri, rt),
                         k, rtol=RTOL)
