"""The serving front's θ-warm essential lane
(elasticsearch_tpu_torch/search/fastpath.py), at server level on the
CPU.

- A cold query at k = 1000 stores its kth score θ and exact total; the
  repeat rides the essential lane (the dense patch) with the identical
  answer and exact total; both equal the float64 oracle (ids exact,
  scores within rtol 1e-6 of float64, the float32 they are reported
  in). When the hot-term table has no row for a non-essential term (it
  is given no memory here) the repeat stays on its full lane.
- A failed certificate (the candidate budget cut so the overflow bound
  engages) memoises the query in ``ess_bad`` and refires it on v2m: the
  same answer; the next repeat does not try the essential lane again.
- An exception inside an essential launch fails its requests and is
  counted; nothing is refired.
- Deleting a doc replaces the registration and drops θ, but keeps the
  tables derived from the postings alone (term bounds, hot-term table).
- A query beyond the largest bucket (the buckets are cut to 8/16/32
  blocks here so a small corpus has such queries) is no fast lane's:
  REST sends it to the plan path, which answers it exactly.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.corpus import (build_corpus, exact_topk,
                                            segment_from_corpus, term_name)
from elasticsearch_tpu_torch.index.segment import segment_from_numpy
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import fastpath as tfp
from elasticsearch_tpu_torch.search import fastpath as srv
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported

K1, B = 1.2, 0.75
N_DOCS = 20000


@pytest.fixture(scope="module")
def corpus():
    c = build_corpus(np.random.default_rng(5), n_docs=N_DOCS, vocab=3000)
    df = c["df"]
    mids = [int(t) for t in np.nonzero((df >= 300) & (df <= 600))[0]]
    hots = [int(t) for t in np.nonzero(df >= 5000)[0]]
    # four mid-df terms and a hot one: the hot term's bound stays below
    # 0.9·θ, so it is non-essential on the repeat
    queries = [sorted(mids[4 * i:4 * i + 4] + [hots[i]]) for i in range(3)]
    return c, queries


@pytest.fixture
def server(corpus):
    servers = []

    def make(seg=None):
        fp = srv.FastPathServer("cpu", DeviceSegmentCache("cpu"))
        fp.start()
        servers.append(fp)
        seg = seg if seg is not None else segment_from_corpus(corpus[0])
        return fp, fp.register("idx", seg, "title", K1, B), seg

    yield make
    for fp in servers:
        assert fp.stop()


def assert_oracle(c, q, got, k=1000, keep=None):
    ids, scores, total = exact_topk(c, q, k, keep=keep)
    vals, docids, tot = got
    assert tot == total
    order = ids[np.lexsort((ids, -scores.astype(np.float32)))]
    np.testing.assert_array_equal(docids, order)
    np.testing.assert_allclose(vals, np.sort(scores)[::-1], rtol=1e-6,
                               atol=0)


def same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2:] == b[2:]


@pytest.mark.parametrize("dense_mb", [512, 0], ids=["dense", "no_dense"])
def test_repeat_rides_essential_lane(server, corpus, dense_mb, monkeypatch):
    c, queries = corpus
    monkeypatch.setattr(srv, "DENSE_MB", dense_mb)
    fp, reg, _ = server()
    assert (reg["dense_tf"] is None) == (dense_mb == 0)
    q = queries[0]
    cold = fp.search(reg, q, 1000)
    assert_oracle(c, q, cold)
    key = (tuple(q), (), 1000)
    assert reg["theta"][key] == (float(cold[0][-1]), cold[2])
    warm = fp.search(reg, q, 1000)
    same(cold, warm)
    s = fp.serving_stats()
    counters = s["counters"]
    if dense_mb == 0:
        # every other condition admits the split; no row, no ess lane
        assert s["dispatch"] == {"v2m:1024": 2}
        assert counters["ess_no_dense"] == 1
        assert counters["ess_queries"] == counters["cohorts_ess"] == 0
        return
    assert s["dispatch"] == {"v2m:1024": 1, "ess:256": 1}
    assert counters["ess_queries"] == 1 and counters["ess_refires"] == 0
    assert counters["cohorts_ess"] == 1 and counters["ess_no_dense"] == 0
    # a smaller k never rides it: θ is the kth of k = 1000
    fp.search(reg, q, 10)
    assert fp.serving_stats()["dispatch"]["v2m:1024"] == 2


def test_filtered_repeat_uses_its_mask_row(server, corpus):
    c, queries = corpus
    fp, reg, _ = server()
    q = queries[1]
    hot = int(np.argmax(c["df"]))
    cold = fp.search(reg, q, 1000, (hot,))
    docs = np.zeros(N_DOCS, bool)
    gs = c["group_start"]
    docs[c["doc_ids"][gs[hot]:gs[hot + 1]]] = True
    assert_oracle(c, q, cold, keep=docs)
    warm = fp.search(reg, q, 1000, (hot,))
    same(cold, warm)
    assert fp.serving_stats()["dispatch"].get("ess:256") == 1


def test_failed_certificate_memoises_and_refires(server, corpus,
                                                 monkeypatch):
    c, queries = corpus
    fp, reg, _ = server()
    q = queries[2]
    cold = fp.search(reg, q, 1000)
    # 64 candidates < k: the patched kth is -inf and the overflow bound
    # finite, so the certificate fails
    monkeypatch.setattr(tfp, "CAND", 64)
    warm = fp.search(reg, q, 1000)
    same(cold, warm)
    key = (tuple(q), (), 1000)
    assert key in reg["ess_bad"]
    counters = fp.serving_stats()["counters"]
    assert counters["ess_queries"] == 1 and counters["ess_refires"] == 1
    assert fp.serving_stats()["dispatch"] == {"v2m:1024": 2, "ess:256": 1}
    again = fp.search(reg, q, 1000)
    same(cold, again)
    assert fp.serving_stats()["dispatch"] == {"v2m:1024": 3, "ess:256": 1}
    assert fp.engine_cache_stats()["hits"] == 2


def test_essential_launch_exception_fails_its_requests(server, corpus,
                                                       monkeypatch):
    c, queries = corpus
    fp, reg, _ = server()
    q = queries[0]
    fp.search(reg, q, 1000)

    def broken(*a, **kw):
        raise RuntimeError("injected essential launch failure")

    monkeypatch.setattr(srv, "bm25_essential_dense_topk_batch", broken)
    with pytest.raises(RuntimeError, match="injected"):
        fp.search(reg, q, 1000)
    counters = fp.serving_stats()["counters"]
    assert counters["cohorts_failed"] == 1 and counters["ess_refires"] == 0
    assert fp.serving_stats()["dispatch"] == {"v2m:1024": 1, "ess:256": 1}


def test_delete_drops_theta(server, corpus):
    c, queries = corpus
    fp, reg, seg = server()
    q = queries[0]
    cold = fp.search(reg, q, 1000)
    assert fp.engine_cache_stats()["entries"] == 1
    gone = int(cold[1][0])
    seg.delete(gone)
    reg2 = fp.register("idx", seg, "title", K1, B)
    assert reg2 is not reg and reg2["theta"] == {}
    # what the postings alone decide is kept, not rebuilt
    assert reg2["dense_tf"] is reg["dense_tf"] and reg2["maxc"] is reg["maxc"]
    assert not torch.equal(reg2["masks"][0], reg["masks"][0])
    assert fp.engine_cache_stats()["entries"] == 0
    after = fp.search(reg2, q, 1000)
    assert gone not in after[1].tolist()
    keep = np.ones(N_DOCS, bool)
    keep[gone] = False
    assert_oracle(c, q, after, keep=keep)
    assert "ess:256" not in fp.serving_stats()["dispatch"]
    # and the repeat on the new registration rides the lane again
    same(after, fp.search(reg2, q, 1000))
    assert fp.serving_stats()["dispatch"]["ess:256"] == 1


def test_engine_cache_stats(server, corpus):
    c, queries = corpus
    fp, reg, _ = server()
    assert fp.engine_cache_stats() == {"hits": 0, "misses": 0, "stores": 0,
                                       "entries": 0}
    for q in queries[:2]:
        fp.search(reg, q, 1000)
    fp.search(reg, queries[0], 1000)
    fp.search(reg, queries[0], 10)        # k != 1000: no lookup
    assert fp.engine_cache_stats() == {"hits": 1, "misses": 2, "stores": 2,
                                       "entries": 2}


def test_term_bounds_per_k1_b(server, corpus):
    """The term bounds are kept per (k1, b); the hot-term table, which
    holds only tfs, once per postings."""
    fp, reg, seg = server()
    other = fp.register("idx", seg, "title", 2.0, B)
    assert other is not reg and other["dense_tf"] is reg["dense_tf"]
    assert (other["maxc"] < reg["maxc"]).any()      # a larger k1
    assert fp.register("idx", seg, "title", K1, B)["maxc"] is reg["maxc"]


# ------------------------------------------------------------- oversize
def separated_segment():
    """A rare term ("star") of 300 docs with ten of tf 100, and a common
    flat term ("flat") of 6000 docs at tf 1: a query of both needs 50
    blocks, beyond the cut-down largest bucket of 32."""
    rng = np.random.default_rng(7)
    n = 20000
    lens = rng.integers(20, 60, n).astype(np.float32)
    star = np.sort(rng.choice(n, 300, replace=False)).astype(np.int32)
    flat = np.sort(rng.choice(n, 6000, replace=False)).astype(np.int32)
    star_tf = np.ones(300, np.float32)
    star_tf[rng.choice(300, 10, replace=False)] = 100.0
    blocks_d, blocks_t, starts, counts = [], [], [], []
    for d, tf in ((flat, np.ones(6000, np.float32)), (star, star_tf)):
        nb = -(-len(d) // 128)
        pad = nb * 128 - len(d)
        starts.append(sum(counts))
        counts.append(nb)
        blocks_d.append(np.concatenate([d, np.zeros(pad, np.int32)])
                        .reshape(nb, 128))
        blocks_t.append(np.concatenate([tf, np.zeros(pad, np.float32)])
                        .reshape(nb, 128))
    return segment_from_numpy(dict(
        terms=["flat", "star"], doc_freq=np.array([6000, 300]),
        term_block_start=np.array(starts), term_block_count=np.array(counts),
        block_docids=np.concatenate(blocks_d),
        block_tfs=np.concatenate(blocks_t), field_lengths=lens),
        name="sep", field="title")


@pytest.fixture
def small_buckets(monkeypatch):
    monkeypatch.setattr(srv, "NB_BUCKETS", (8, 16, 32))


def test_oversize_query_is_no_fast_lanes(server, small_buckets):
    fp, reg, _ = server(seg=separated_segment())
    assert fp.route(reg, [0, 1]) is None
    assert not fp.fits(reg, [0, 1], 10)
    with pytest.raises(SliceUnsupported, match="plan path serves it"):
        fp.submit(reg, [0, 1], 10)
    assert fp.route(reg, [1]) == ("v2m", 16)       # star alone fits


def test_rest_sends_oversize_query_to_plan_path(small_buckets):
    """Through REST the oversize query is answered by the plan path,
    with the exact total (relation "eq") and the float64 oracle's top
    10 (a sum over both terms' postings)."""
    seg = separated_segment()
    node = Node(device="cpu")
    try:
        node.create_index("sep", {"properties": {"title": {"type": "text"}}})
        node.indices["sep"].engine.install_segments([seg])
        st, r = node.rest_controller.dispatch(
            "POST", "/sep/_search", {},
            {"query": {"match": {"title": "star flat"}}, "size": 10})
        assert st == 200, r
        assert node.search_service.plan_batcher.launches == 1
        assert node.fastpath.serving_stats()["dispatch"] == {}
        pf = seg.postings["title"]
        n = seg.n_docs
        score = np.zeros(n)
        for t in (0, 1):
            s, c = int(pf.term_block_start[t]), int(pf.term_block_count[t])
            d = pf.block_docids[s:s + c].reshape(-1)
            tf = pf.block_tfs[s:s + c].reshape(-1).astype(np.float64)
            ok = tf > 0
            idf = np.log1p((n - pf.doc_freq[t] + 0.5)
                           / (pf.doc_freq[t] + 0.5))
            score[d[ok]] += idf * tf[ok] / (tf[ok] + K1 * (
                1 - B + B * pf.field_lengths[d[ok]] / pf.avg_field_length))
        matched = np.nonzero(score > 0)[0]
        top = matched[np.lexsort((matched, -score[matched]))][:10]
        assert r["hits"]["total"] == {"value": len(matched),
                                      "relation": "eq"}
        assert [int(h["_id"]) for h in r["hits"]["hits"]] == top.tolist()
    finally:
        node.close()


def test_essential_split_conditions(server, corpus):
    """The split refuses what the reference's attached branch refuses:
    k below MAX_K, no θ, a single known term, and a θ too low for any
    term to go non-essential."""
    c, queries = corpus
    fp, reg, _ = server()
    q = queries[0]
    nb = int(reg["nb"][q].sum())

    def split(term_ids, k=1000, theta=None):
        p = srv._Pending(reg, term_ids, (), k, "v2m", 1024)
        if theta is not None:
            reg["theta"][(tuple(term_ids), (), k)] = (theta, 5000)
        return fp._essential_split(reg, p, nb)

    assert split(q, k=10) is None
    assert split(q) is None                         # no θ yet
    assert split(q[:1], theta=100.0) is None        # one term
    assert split(q, theta=1e-6) is None             # nothing below 0.9·θ
    got = split(q, theta=100.0)
    bucket, ess, ne, bound, theta, total = got
    assert bucket == 256 and theta == 100.0 and total == 5000
    assert sorted(ess + ne) == sorted(q) and len(ess) >= 1
    assert bound == pytest.approx(sum(reg["maxc"][t] for t in ne))
    assert bound < 90.0
    # a non-essential term's bound never exceeds an essential one's
    assert max(reg["maxc"][ne]) <= min(reg["maxc"][ess])
    assert term_name(q[0]) in reg["dp"].host.terms
