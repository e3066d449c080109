"""The sharded programs of the port's parallel/sharded.py against the
reference's elasticsearch_tpu/parallel/sharded.py, on the CPU: the
reference on its eight virtual jax devices, the port on a grid of
``["cpu"] * 8`` (one process, no spawned ranks). The same seeded
documents of tests/test_parallel.py go through each package's own
mapper and SegmentWriter, eight shards of 100, and the same selections
(the reference test's ``_select``) through both programs.

Each of the reference's eight tests has its counterpart here: the BM25
top-k against the float64 scalar oracle, kNN against the float32 dot
products, the dfs statistics, the grid's shapes, the hybrid RRF against
the host fusion of its own branches, the 4 x 2 replica grid, and the
global ids past 2^31. The reference merges those on the host in int64
(its x64 is off); the port's ids are int64 on the device, and the tests
hold them exact with a per-shard stride of 2^33. Ids and order are
exact; BM25 scores rtol 2e-5 against the oracle and 1e-6 against the
reference, kNN scores rtol 1e-4 (two float32 matrix products)."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.index.segment import SegmentWriter as JaxWriter
from elasticsearch_tpu.ops import bm25 as jax_bm25
from elasticsearch_tpu.parallel import sharded as jax_sharded
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.parallel import sharded
from test_parallel import MAPPINGS, VOCAB, _select

CPU8 = ["cpu"] * 8
# a per-shard global-id stride that puts shard 1's ids past 2^31 and
# shard 7's past 2^35
BIG_STRIDE = 1 << 33


def build_both(rng, n_shards=8, docs_per_shard=100):
    """The reference test's ``build_shards`` documents, through both
    packages' writers: (reference segments, port segments)."""
    jm, pm = MapperService(mappings=MAPPINGS), DocumentMapper(MAPPINGS)
    probs = 1.0 / np.arange(1, len(VOCAB) + 1)
    probs /= probs.sum()
    jsegs, psegs = [], []
    for s in range(n_shards):
        jw, pw = JaxWriter(), SegmentWriter()
        for i in range(docs_per_shard):
            words = rng.choice(VOCAB, size=int(rng.integers(1, 20)), p=probs)
            doc = {"body": " ".join(words),
                   "vec": rng.standard_normal(8).astype(np.float32).tolist()}
            jw.add(jm.parse(f"{s}-{i}", doc))
            pw.add(pm.parse(f"{s}-{i}", doc))
        jsegs.append(jw.build(f"shard{s}"))
        psegs.append(pw.build(f"shard{s}"))
    return jsegs, psegs


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(7)
    jsegs, psegs = build_both(rng)
    jindex, jpfs = jax_sharded.build_sharded_index(
        jax_sharded.make_mesh(n_shards=8), jsegs, "body", with_vectors="vec")
    pindex, ppfs = sharded.build_sharded_index(
        sharded.make_mesh(n_shards=8, devices=CPU8), psegs, "body",
        with_vectors="vec")
    return jsegs, jindex, jpfs, psegs, pindex, ppfs


def global_idfs(pfs, terms):
    n_total = sum(pf.doc_count for pf in pfs)
    dfs = [sum(int(pf.doc_freq[pf.term_id(t)]) for pf in pfs
               if pf.term_id(t) >= 0) for t in terms]
    return [jax_bm25.idf(df, n_total) for df in dfs]


def selections(jpfs, jindex, terms, idfs, q=1):
    sel, wsel = _select(jpfs, jindex, terms, idfs)
    s, nb = sel.shape
    return (np.ascontiguousarray(np.broadcast_to(sel[:, None, :],
                                                 (s, q, nb))),
            np.ascontiguousarray(np.broadcast_to(wsel[:, None, :],
                                                 (s, q, nb))))


def bm25_oracle(pfs, nd, avg, terms, idfs, k, stride=None):
    """The reference test's global float64 scalar oracle:
    [(global id, score)] by (-score, id)."""
    stride = nd if stride is None else stride
    ref = {}
    for s, pf in enumerate(pfs):
        scores = jax_bm25.bm25_reference_scores(
            [pf.postings(t) for t in terms], idfs,
            np.maximum(pf.field_lengths, 1.0), avg, 1.2, 0.75)
        for d, sc in enumerate(scores):
            if sc > 0:
                ref[s * stride + d] = sc
    return sorted(ref.items(), key=lambda kv: (-kv[1], kv[0]))[:k]


def knn_oracle(segs, nd, query, k, stride=None):
    stride = nd if stride is None else stride
    ref = {}
    for s, seg in enumerate(segs):
        vv = seg.vectors["vec"]
        scores = vv.vectors @ query
        for d in range(seg.n_docs):
            if vv.has_value[d]:
                ref[s * stride + d] = scores[d]
    return sorted(ref.items(), key=lambda kv: (-kv[1], kv[0]))[:k]


def host(*ts):
    return tuple(t.cpu().numpy() if isinstance(t, torch.Tensor)
                 else np.asarray(t) for t in ts)


def test_sharded_bm25_matches_global_reference(both):
    jsegs, jindex, jpfs, psegs, pindex, ppfs = both
    terms = ["alpha", "gamma"]
    idfs = global_idfs(jpfs, terms)
    assert idfs == global_idfs(ppfs, terms)
    assert pindex.avg_len == jindex.avg_len
    sel, wsel = selections(jpfs, jindex, terms, idfs)
    vals, gids = host(*sharded.sharded_bm25_topk(pindex, sel, wsel, k=10))
    rv, rg = host(*jax_sharded.sharded_bm25_topk(jindex, sel, wsel, k=10))
    assert gids.dtype == np.int64
    expected = bm25_oracle(jpfs, jindex.n_docs_padded, jindex.avg_len,
                           terms, idfs, 10)
    assert gids[0].tolist() == [g for g, _ in expected] == rg[0].tolist()
    np.testing.assert_allclose(vals[0], [v for _, v in expected],
                               rtol=2e-5)
    np.testing.assert_allclose(vals[0], rv[0], rtol=1e-6)


def test_sharded_knn_matches_reference(both):
    jsegs, jindex, jpfs, psegs, pindex, ppfs = both
    queries = np.random.default_rng(3).standard_normal((2, 8)).astype(
        np.float32)
    vals, gids = host(*sharded.sharded_knn_topk(pindex, queries, k=5))
    rv, rg = host(*jax_sharded.sharded_knn_topk(jindex, queries, k=5))
    for qi in range(2):
        expected = knn_oracle(psegs, pindex.n_docs_padded, queries[qi], 5)
        np.testing.assert_allclose(vals[qi], [v for _, v in expected],
                                   rtol=1e-4, atol=1e-5)
        assert gids[qi].tolist() == [g for g, _ in expected]
    assert gids.tolist() == rg.tolist()
    np.testing.assert_allclose(vals, rv, rtol=1e-4, atol=1e-5)


def test_sharded_dfs_psum(both):
    jsegs, jindex, jpfs, psegs, pindex, ppfs = both
    sel, _ = _select(jpfs, jindex, ["alpha"], [1.0])
    dfs = host(sharded.sharded_dfs_stats(pindex, sel))[0]
    ref = np.asarray(jax_sharded.sharded_dfs_stats(jindex, sel))
    total_df = sum(int(pf.doc_freq[pf.term_id("alpha")]) for pf in ppfs
                   if pf.term_id("alpha") >= 0)
    assert int(dfs.sum()) == total_df
    assert dfs.tolist() == ref.tolist()


def test_mesh_shapes():
    mesh = sharded.make_mesh(n_shards=4, n_replicas=2, devices=CPU8)
    assert mesh.shape == {"replica": 2, "shard": 4}
    assert mesh.shape == jax_sharded.make_mesh(n_shards=4,
                                               n_replicas=2).shape
    mesh8 = sharded.make_mesh(devices=CPU8)
    assert mesh8.shape["shard"] == 8
    assert mesh8.devices.shape == (1, 8)
    assert all(d == torch.device("cpu") for d in mesh8.devices.flat)
    with pytest.raises(ValueError):
        sharded.make_mesh(n_shards=16, devices=CPU8)


def test_sharded_hybrid_rrf_matches_host_fusion(both):
    """The fusion on the mesh equals the host fusion of its own two
    branches' global top-k lists, and the reference's fusion."""
    jsegs, jindex, jpfs, psegs, pindex, ppfs = both
    terms = ["alpha", "gamma"]
    idfs = global_idfs(jpfs, terms)
    sel, wsel = selections(jpfs, jindex, terms, idfs)
    queries = np.random.default_rng(5).standard_normal((1, 8)).astype(
        np.float32)
    k = 10
    rrf_vals, rrf_gids = host(*sharded.sharded_hybrid_rrf(
        pindex, sel, wsel, queries, k))
    ref_vals, ref_gids = host(*jax_sharded.sharded_hybrid_rrf(
        jindex, sel, wsel, queries, k))
    b_vals, b_gids = host(*sharded.sharded_bm25_topk(pindex, sel, wsel, k))
    v_vals, v_gids = host(*sharded.sharded_knn_topk(pindex, queries, k))
    scores = {}
    for vals, gids in ((b_vals[0], b_gids[0]), (v_vals[0], v_gids[0])):
        for rank, (val, g) in enumerate(zip(vals, gids)):
            if np.isfinite(val):
                scores[int(g)] = scores.get(int(g), 0.0) + 1 / (
                    60 + rank + 1)
    expected = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
    got = [(int(g), float(v)) for v, g in zip(rrf_vals[0], rrf_gids[0])
           if np.isfinite(v)]
    ref = [(int(g), float(v)) for v, g in zip(ref_vals[0], ref_gids[0])
           if np.isfinite(v)]
    assert len(got) == len(expected) == len(ref)
    np.testing.assert_allclose([v for _, v in got],
                               [v for _, v in expected], rtol=1e-6)
    np.testing.assert_allclose([v for _, v in got], [v for _, v in ref],
                               rtol=1e-6)
    # ids agree at every rank whose score is distinct from its
    # neighbours' (a tie may order its ids either way in the reference)
    exp_scores = [v for _, v in expected]
    for i, ((gg, _), (eg, ev), (rg, _)) in enumerate(zip(got, expected,
                                                         ref)):
        ambiguous = (
            (i > 0 and abs(exp_scores[i - 1] - ev) < 1e-12)
            or (i + 1 < len(exp_scores)
                and abs(exp_scores[i + 1] - ev) < 1e-12))
        if not ambiguous:
            assert gg == eg == rg, (i, got, expected, ref)
    # the port orders a tie by ascending global id
    for (g1, v1), (g2, v2) in zip(got, got[1:]):
        assert v1 > v2 or (v1 == v2 and g1 < g2)


def test_sharded_hybrid_rrf_replica_mesh():
    """A 4-shard x 2-replica grid splits the query batch over the
    replicas: each query equals its answer on a 4 x 1 grid, and the
    reference's on its own 4 x 2 mesh."""
    rng = np.random.default_rng(11)
    jsegs, psegs = build_both(rng, n_shards=4, docs_per_shard=50)
    jindex, jpfs = jax_sharded.build_sharded_index(
        jax_sharded.make_mesh(n_shards=4, n_replicas=2), jsegs, "body",
        with_vectors="vec")
    pindex, _ = sharded.build_sharded_index(
        sharded.make_mesh(n_shards=4, n_replicas=2, devices=CPU8), psegs,
        "body", with_vectors="vec")
    single, _ = sharded.build_sharded_index(
        sharded.make_mesh(n_shards=4, devices=CPU8), psegs, "body",
        with_vectors="vec")
    sel, wsel = selections(jpfs, jindex, ["alpha"], [1.0], q=2)
    queries = rng.standard_normal((2, 8)).astype(np.float32)
    vals, gids = host(*sharded.sharded_hybrid_rrf(pindex, sel, wsel,
                                                  queries, k=5))
    assert vals.shape == (2, 5) and gids.shape == (2, 5)
    assert np.isfinite(vals).any()
    assert (vals[0] > 0).any() and (vals[1] > 0).any()
    sv, sg = host(*sharded.sharded_hybrid_rrf(single, sel, wsel, queries,
                                              k=5))
    assert gids.tolist() == sg.tolist()
    np.testing.assert_array_equal(vals, sv)
    rv, rg = host(*jax_sharded.sharded_hybrid_rrf(jindex, sel, wsel,
                                                  queries, k=5))
    np.testing.assert_allclose(vals, rv, rtol=1e-6)
    with pytest.raises(ValueError):
        sharded.sharded_bm25_topk(pindex, sel[:, :1], wsel[:, :1], k=5)


def test_sharded_bm25_gid_overflow_host_fallback(both, monkeypatch):
    """Ids past 2^31 come back exact: the port's global ids are int64 on
    the device (the reference merges on the host past its int32
    ceiling, forced here as its test forces it)."""
    jsegs, jindex, jpfs, psegs, pindex, ppfs = both
    terms = ["alpha", "gamma"]
    idfs = global_idfs(jpfs, terms)
    sel, wsel = selections(jpfs, jindex, terms, idfs)
    monkeypatch.setattr(pindex, "gid_stride", BIG_STRIDE)
    vals, gids = host(*sharded.sharded_bm25_topk(pindex, sel, wsel, k=10))
    assert gids.dtype == np.int64
    expected = bm25_oracle(jpfs, jindex.n_docs_padded, jindex.avg_len,
                           terms, idfs, 10, stride=BIG_STRIDE)
    assert max(g for g, _ in expected) >= 1 << 31
    assert gids[0].tolist() == [g for g, _ in expected]
    np.testing.assert_allclose(vals[0], [v for _, v in expected],
                               rtol=2e-5)
    monkeypatch.setattr(jax_sharded, "GID_INT32_LIMIT", 1)
    rv, rg = host(*jax_sharded.sharded_bm25_topk(jindex, sel, wsel, k=10))
    nd = jindex.n_docs_padded
    assert gids[0].tolist() == [(g // nd) * BIG_STRIDE + g % nd
                                for g in rg[0].tolist()]
    np.testing.assert_allclose(vals[0], rv[0], rtol=1e-6)


def test_sharded_knn_gid_overflow_host_fallback(both, monkeypatch):
    jsegs, jindex, jpfs, psegs, pindex, ppfs = both
    queries = np.random.default_rng(3).standard_normal((2, 8)).astype(
        np.float32)
    monkeypatch.setattr(pindex, "gid_stride", BIG_STRIDE)
    vals, gids = host(*sharded.sharded_knn_topk(pindex, queries, k=5))
    assert gids.dtype == np.int64
    monkeypatch.setattr(jax_sharded, "GID_INT32_LIMIT", 1)
    rv, rg = host(*jax_sharded.sharded_knn_topk(jindex, queries, k=5))
    nd = jindex.n_docs_padded
    for qi in range(2):
        expected = knn_oracle(psegs, pindex.n_docs_padded, queries[qi], 5,
                              stride=BIG_STRIDE)
        np.testing.assert_allclose(vals[qi], [v for _, v in expected],
                                   rtol=1e-4, atol=1e-5)
        assert gids[qi].tolist() == [g for g, _ in expected]
        assert gids[qi].tolist() == [(g // nd) * BIG_STRIDE + g % nd
                                     for g in rg[qi].tolist()]
