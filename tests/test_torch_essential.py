"""The port's θ-warm essential ops (elasticsearch_tpu_torch/ops/fastpath.py
``bm25_essential_topk_batch``, ``bm25_essential_dense_topk_batch``)
against the reference's functions of the same names on the same cohort.

Inputs: the segments of tests/test_fastpath_dense.py (hot terms of high
df plus rare terms) and the 2M corpus's generator at a few thousand
docs, each with a MaxScore split whose non-essential bound is the true
largest contribution (``build_term_impacts``). Tolerances:
- float32 rail (the reference under x64 off ranks in float32 too): ok
  flags equal; on certified rows ids and order equal and values within
  rtol 1e-6 (the lanes' float32 contributions differ from XLA's in the
  last bit, as in tests/test_torch_fastpath_lanes.py);
- float64 rail (serving): certified rows equal the port's v1 lane on
  the whole query: ids and order exact, values exact. Where the
  reference's float32 ranking and the port's float64 ranking can order
  two docs differently (a constructed tie below), this is the
  comparison that holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import fastpath as jfp
from elasticsearch_tpu_torch.corpus import build_corpus
from elasticsearch_tpu_torch.ops import fastpath as tfp
from elasticsearch_tpu_torch.ops.plan import build_term_impacts, unpack_ids

BLOCK = 128
K1, B = 1.2, 0.75
Q, NB, K = 4, 64, 10


def dense_segment(seed, n_docs=600, n_hot=2, n_rare=3):
    """The segment shape of tests/test_fastpath_dense.py build_segment:
    ``n_hot`` terms of df 60-100 % of the docs, then rare terms of df
    8-40, tf 1-5, block layout with the reserved zero block last."""
    rng = np.random.default_rng(seed)
    bd, bt, tbs, nb, dfs = [], [], [], [], []
    nxt = 0
    for i in range(n_hot + n_rare):
        df = (int(rng.integers(int(n_docs * 0.6), n_docs)) if i < n_hot
              else int(rng.integers(8, 40)))
        docs = np.sort(rng.choice(n_docs, df, replace=False)).astype(np.int32)
        tfs = rng.integers(1, 6, df).astype(np.float32)
        nblk = -(-df // BLOCK)
        pad = nblk * BLOCK - df
        bd.append(np.concatenate([docs, np.zeros(pad, np.int32)])
                  .reshape(nblk, BLOCK))
        bt.append(np.concatenate([tfs, np.zeros(pad, np.float32)])
                  .reshape(nblk, BLOCK))
        tbs.append(nxt)
        nb.append(nblk)
        dfs.append(df)
        nxt += nblk
    lens = rng.integers(5, 80, n_docs).astype(np.float32)
    return _seg(np.concatenate(bd), np.concatenate(bt), np.asarray(tbs),
                np.asarray(nb), np.asarray(dfs), lens)


def corpus_segment(seed, n_docs=4000):
    """The 2M corpus's generator (corpus.py build_corpus) at a few
    thousand docs."""
    c = build_corpus(np.random.default_rng(seed), n_docs=n_docs, vocab=300)
    return _seg(c["block_docids"], c["block_tfs"], c["tbs"][:-1], c["nb"],
                c["df"], c["lens"])


def _seg(bd, bt, tbs, nb, dfs, lens):
    """Block arrays padded with zero blocks (the first is the reserved
    one) to a multiple of 256, so the reference compiles few shapes; the
    term impacts and the dense table of the two hottest terms."""
    tb = bd.shape[0]
    zeros = -(-(tb + 1) // 256) * 256 - tb
    bd = np.concatenate([bd, np.zeros((zeros, BLOCK), np.int32)])
    bt = np.concatenate([bt, np.zeros((zeros, BLOCK), np.float32)])
    n = len(lens)
    idf = np.log1p((n - dfs + 0.5) / (dfs + 0.5))
    max_tf = bt[:tb].max(axis=1)
    ml = np.where(bt[:tb] > 0, lens[bd[:tb]], np.inf).min(axis=1)
    min_len = np.where(np.isfinite(ml), ml, 0.0)
    avg = float(lens.astype(np.float64).mean())
    imp = build_term_impacts(tbs, nb, max_tf, min_len, idf, avg, K1, B)
    maxc = np.zeros(len(nb))
    maxc[nb > 0] = imp.ub_desc[tbs[nb > 0]]
    hot = [int(t) for t in np.argsort(-dfs)[:2]]
    dense = np.zeros((len(hot), n), np.float16)
    for row, t in enumerate(hot):
        s = int(tbs[t]) * BLOCK
        d, f = bd.reshape(-1)[s:s + dfs[t]], bt.reshape(-1)[s:s + dfs[t]]
        dense[row, d] = f
    return dict(bd=bd, bt=bt, tbs=tbs, nb=nb, dfs=dfs, lens=lens, idf=idf,
                avg=avg, maxc=maxc, zero=tb, hot=hot, dense=dense, n=n)


def split_cohort(seg, queries, mids=None, masks=None, dtype=np.float64,
                 nb=NB):
    """The essential selection and NE descriptors of ``queries`` [(ess,
    ne)], padded to Q rows of ``nb`` blocks."""
    sel = np.full((Q, nb), seg["zero"], np.int32)
    ws = np.zeros((Q, nb), dtype)
    ns = np.zeros((Q, tfp.NE_SLOTS), np.int32)
    nl = np.zeros((Q, tfp.NE_SLOTS), np.int32)
    nr = np.full((Q, tfp.NE_SLOTS), -1, np.int32)
    ni = np.zeros((Q, tfp.NE_SLOTS), dtype)
    bound = np.zeros(Q, dtype)
    for qi, (ess, ne) in enumerate(queries):
        pos = 0
        for t in ess:
            c = int(seg["nb"][t])
            sel[qi, pos:pos + c] = np.arange(seg["tbs"][t], seg["tbs"][t] + c)
            ws[qi, pos:pos + c] = seg["idf"][t]
            pos += c
        for i, t in enumerate(ne):
            ns[qi, i] = seg["tbs"][t] * BLOCK
            nl[qi, i] = seg["dfs"][t]
            nr[qi, i] = seg["hot"].index(t) if t in seg["hot"] else -1
            ni[qi, i] = seg["idf"][t]
        bound[qi] = sum(float(seg["maxc"][t]) for t in ne)
    if masks is None:
        masks = np.ones((tfp.F_SLOTS, seg["n"]), bool)
    if mids is None:
        mids = np.zeros(Q, np.int32)
    return dict(sel=sel, ws=ws, ns=ns, nl=nl, nr=nr, ni=ni, bound=bound,
                masks=masks, mids=np.asarray(mids, np.int32))


def ref_ops(seg, c, k=K):
    j = jnp.asarray
    f32 = np.float32
    common = (j(seg["bd"]), j(seg["bt"]))
    binary = np.asarray(jfp.bm25_essential_topk_batch(
        *common, j(seg["bd"].reshape(-1)), j(seg["bt"].reshape(-1)),
        j(c["sel"]), j(c["ws"].astype(f32)), j(seg["lens"]), j(c["masks"]),
        j(c["mids"]), j(c["ns"]), j(c["nl"]), j(c["ni"].astype(f32)),
        j(c["bound"].astype(f32)), f32(seg["avg"]), K1, B, k))
    dense = np.asarray(jfp.bm25_essential_dense_topk_batch(
        *common, j(seg["dense"]), j(c["sel"]), j(c["ws"].astype(f32)),
        j(seg["lens"]), j(c["masks"]), j(c["mids"]), j(c["nr"]),
        j(c["ni"].astype(f32)), j(c["bound"].astype(f32)), f32(seg["avg"]),
        K1, B, k))
    return binary, dense


def port_ops(seg, c, dtype, k=K):
    t = torch.from_numpy
    avg = float(np.float32(seg["avg"])) if dtype == torch.float32 \
        else seg["avg"]
    bd, bt = t(seg["bd"]), t(seg["bt"])
    tail = (t(seg["lens"]), t(c["masks"]), t(c["mids"]))
    binary = tfp.bm25_essential_topk_batch(
        bd, bt, bd.view(-1), bt.view(-1), t(c["sel"]), t(c["ws"]).to(dtype),
        *tail, t(c["ns"]), t(c["nl"]), t(c["ni"]).to(dtype),
        t(c["bound"]).to(dtype), avg, K1, B, k, score_dtype=dtype).numpy()
    dense = tfp.bm25_essential_dense_topk_batch(
        bd, bt, t(seg["dense"]), t(c["sel"]), t(c["ws"]).to(dtype), *tail,
        t(c["nr"]), t(c["ni"]).to(dtype), t(c["bound"]).to(dtype), avg, K1,
        B, k, score_dtype=dtype).numpy()
    return binary, dense


def port_v1(seg, queries, dtype, mids=None, masks=None, k=K):
    """The port's v1 lane on each whole query (essential + NE terms)."""
    sel = np.full((Q, 2 * NB), seg["zero"], np.int32)
    ws = np.zeros((Q, 2 * NB))
    for qi, (ess, ne) in enumerate(queries):
        pos = 0
        for t in list(ess) + list(ne):
            c = int(seg["nb"][t])
            sel[qi, pos:pos + c] = np.arange(seg["tbs"][t], seg["tbs"][t] + c)
            ws[qi, pos:pos + c] = seg["idf"][t]
            pos += c
    if masks is None:
        masks = np.ones((tfp.F_SLOTS, seg["n"]), bool)
    mids = np.zeros(Q, np.int32) if mids is None else np.asarray(mids,
                                                                 np.int32)
    t = torch.from_numpy
    return tfp.bm25_topk_total_batch(
        t(seg["bd"]), t(seg["bt"]), t(sel), t(ws).to(dtype), t(seg["lens"]),
        t(masks), t(mids), seg["avg"], K1, B, k, score_dtype=dtype).numpy()


def assert_matches_reference(got, ref, k=K):
    """ok flags equal; certified rows: ids and order exact, values within
    rtol 1e-6."""
    np.testing.assert_array_equal(got[:, 2 * k], ref[:, 2 * k])
    for qi in np.nonzero(got[:, 2 * k] == 1)[0]:
        np.testing.assert_array_equal(unpack_ids(got[qi, k:2 * k]),
                                      unpack_ids(ref[qi, k:2 * k]))
        np.testing.assert_allclose(got[qi, :k], ref[qi, :k], rtol=1e-6,
                                   atol=0)


def assert_certified_rows_equal_v1(got, v1, k=K):
    """Each certified row holds v1's hits in the same order (both rank
    in the rail dtype, lowest docid first among ties)."""
    for qi in np.nonzero(got[:, 2 * k] == 1)[0]:
        np.testing.assert_array_equal(got[qi, k:2 * k], v1[qi, k:2 * k])
        np.testing.assert_array_equal(got[qi, :k], v1[qi, :k])


def dense_queries(seg):
    h0, h1 = seg["hot"]
    r = [t for t in range(len(seg["nb"])) if t not in seg["hot"]]
    return [(r, [h0]), (r, [h0, h1]), (r, [h1]), (r[:2], [h0])]


def assert_admissible(queries, seg, v1, k=K):
    """The test data's own precondition, as the serving front admits a
    split: the NE bounds sum below 0.9 x the exact kth (v1's), so no doc
    outside the essential union can enter the top k."""
    for qi, (_, ne) in enumerate(queries):
        bound = sum(float(seg["maxc"][t]) for t in ne)
        assert bound < 0.9 * float(v1[qi, k - 1]), (qi, bound)


def corpus_queries(seg, seed):
    """Four queries of the corpus, each a few rare terms (essential)
    plus the two hottest (non-essential)."""
    rng = np.random.default_rng(seed)
    rare = np.nonzero((seg["dfs"] > 20) & (seg["nb"] <= 4))[0]
    return [([int(t) for t in rng.choice(rare, 3, replace=False)],
             list(seg["hot"])) for _ in range(Q)]


CASES = [("dense", 0), ("dense", 1), ("dense", 2), ("corpus", 3),
         ("corpus", 4)]


def case(kind, seed):
    if kind == "dense":
        seg = dense_segment(seed)
        return seg, dense_queries(seg)
    seg = corpus_segment(seed)
    return seg, corpus_queries(seg, seed)


@pytest.mark.parametrize("kind,seed", CASES)
def test_essential_ops_match_reference_f32(kind, seed):
    seg, queries = case(kind, seed)
    c = split_cohort(seg, queries)
    rb, rd = ref_ops(seg, c)
    pb, pd = port_ops(seg, c, torch.float32)
    assert_matches_reference(pb, rb)
    assert_matches_reference(pd, rd)
    assert pb[:, 2 * K].all()           # the true bound certifies these


@pytest.mark.parametrize("kind,seed", CASES)
def test_essential_f64_certified_rows_match_v1(kind, seed):
    seg, queries = case(kind, seed)
    c = split_cohort(seg, queries)
    pb, pd = port_ops(seg, c, torch.float64)
    v1 = port_v1(seg, queries, torch.float64)
    assert_admissible(queries, seg, v1)
    assert pb[:, 2 * K].all() and pd[:, 2 * K].all()
    assert_certified_rows_equal_v1(pb, v1)
    assert_certified_rows_equal_v1(pd, v1)
    np.testing.assert_array_equal(pb, pd)


def tie_segment():
    """Two docs whose float64 scores differ but share one float32 value:
    docs 2 and 3 hold the essential term 0 at tf 1 and equal lengths;
    doc 3 also holds the non-essential term 1, whose weight is so small
    that its contribution moves doc 3's float64 score and not its
    float32 one. float32 ranking with docid ties puts doc 2 first,
    float64 ranking doc 3."""
    n = 512
    lens = np.full(n, 10.0, np.float32)
    # term 0 (essential): docs 2 and 3; term 1 (non-essential): every
    # doc but 2 and 5..9
    d0 = np.array([2, 3], np.int32)
    d1 = np.array([d for d in range(n) if d not in (2, 5, 6, 7, 8, 9)],
                  np.int32)
    bd, bt, tbs, nb, dfs = [], [], [], [], []
    nxt = 0
    for d in (d0, d1):
        nblk = -(-len(d) // BLOCK)
        pad = nblk * BLOCK - len(d)
        bd.append(np.concatenate([d, np.zeros(pad, np.int32)])
                  .reshape(nblk, BLOCK))
        bt.append(np.concatenate([np.ones(len(d), np.float32),
                                  np.zeros(pad, np.float32)])
                  .reshape(nblk, BLOCK))
        tbs.append(nxt)
        nb.append(nblk)
        dfs.append(len(d))
        nxt += nblk
    seg = _seg(np.concatenate(bd), np.concatenate(bt), np.asarray(tbs),
               np.asarray(nb), np.asarray(dfs), lens)
    # a tiny weight for the NE term: its contribution is below half an
    # ulp of term 0's float32 score, but not of its float64 score; every
    # posting has tf 1 at the average length, so each term's largest
    # contribution is idf / (1 + k1)
    seg["idf"] = np.array([seg["idf"][0], seg["idf"][0] * 1e-9])
    seg["maxc"] = seg["idf"] / (1.0 + K1)
    return seg


def test_float64_ranking_where_float32_ties():
    """The one place the port does not copy the reference: its ranking
    dtype. Docs 2 and 3 share a float32 score; at float64 doc 3 is ahead
    (its NE contribution). The reference orders 2, 3 (float32, docid);
    the port at float64 orders 3, 2, as its v1 lane does."""
    seg = tie_segment()
    queries = [([0], [1])] * Q
    k = 2
    c = split_cohort(seg, queries)
    pb, pd = port_ops(seg, c, torch.float64, k=k)
    v1 = port_v1(seg, queries, torch.float64, k=k)
    rb, _ = ref_ops(seg, c, k=k)
    assert pb[0, 2 * k] == 1 and rb[0, 2 * k] == 1
    assert pb[0, 0] == pb[0, 1]                       # one float32 value
    assert unpack_ids(rb[0, k:2 * k]).tolist() == [2, 3]
    assert unpack_ids(pb[0, k:2 * k]).tolist() == [3, 2]
    assert_certified_rows_equal_v1(pb, v1, k=k)
    assert_certified_rows_equal_v1(pd, v1, k=k)


def test_unused_slots_are_inert():
    """No NE term at all: both ops are the essential union alone, equal
    to each other and to v1 on the essential terms."""
    seg = dense_segment(7)
    r = [t for t in range(len(seg["nb"])) if t not in seg["hot"]]
    queries = [(r[:2], [])] * 2 + [(r, [])] * 2
    c = split_cohort(seg, queries)
    pb, pd = port_ops(seg, c, torch.float64)
    np.testing.assert_array_equal(pb, pd)
    assert pb[:, 2 * K].all()
    assert_certified_rows_equal_v1(pb, port_v1(seg, queries, torch.float64))
    rb, rd = ref_ops(seg, c)
    assert_matches_reference(port_ops(seg, c, torch.float32)[0], rb)


def test_mask_rows_and_dead_docs():
    """Rows 1 and 3 read a mask row with dead docs (the low half live
    only, and a random fifth dead in it): no hit outside it, equal to
    the reference at float32 and to v1 on the same row at float64."""
    seg = dense_segment(11)
    rng = np.random.default_rng(11)
    masks = np.ones((tfp.F_SLOTS, seg["n"]), bool)
    masks[3] = False
    masks[3, :seg["n"] // 2] = rng.random(seg["n"] // 2) < 0.8
    mids = [0, 3, 0, 3]
    queries = dense_queries(seg)
    c = split_cohort(seg, queries, mids=mids, masks=masks)
    v1 = port_v1(seg, queries, torch.float64, mids=mids, masks=masks)
    assert_admissible(queries, seg, v1)
    rb, rd = ref_ops(seg, c)
    pb, pd = port_ops(seg, c, torch.float32)
    assert_matches_reference(pb, rb)
    assert_matches_reference(pd, rd)
    b64, d64 = port_ops(seg, c, torch.float64)
    assert_certified_rows_equal_v1(b64, v1)
    assert_certified_rows_equal_v1(d64, v1)
    for qi in (1, 3):
        ids = unpack_ids(b64[qi, K:2 * K])
        live = np.isfinite(b64[qi, :K])
        assert live.any() and masks[3][ids[live]].all()


def test_wide_bound_refused():
    """A non-essential bound that beats every kth, over an essential
    union of more than CAND docs (so the overflow bound is finite):
    ok = 0 on both ops of both packages."""
    nd = int(tfp.CAND * 1.5)
    seed = 13
    while True:
        seg = dense_segment(seed, n_docs=nd, n_hot=2, n_rare=1)
        if seg["dfs"][0] > tfp.CAND:
            break
        seed += 1
    c = split_cohort(seg, [([0], [1])] * Q, nb=256)
    c["bound"][:] = 1e6
    rb, rd = ref_ops(seg, c, k=10)
    pb, pd = port_ops(seg, c, torch.float64, k=10)
    p32 = port_ops(seg, c, torch.float32, k=10)
    for out in (rb, rd, pb, pd, *p32):
        assert not out[:, 2 * 10].any()
