"""The θ-warm essential ops, the θ-warm lane and the plan path's
pruning on the card.

- Both essential ops (ops/fastpath.py ``bm25_essential_topk_batch``,
  ``bm25_essential_dense_topk_batch``) at Q = 32 on the card equal the
  same op on the card with the plain contribution twin in place of the
  kernel: the packed rows bit-equal at float64 (the kernel's float64
  contributions equal the twin's bit for bit, and the rest is the same
  PyTorch ops), and the kernel launched once per call.
- A θ-warm repeat through a ``FastPathServer`` on CUDA: the essential
  lane answers it, equal to the cold answer.
- Block-max window pruning (search/plan.py) on the card, on the corpus
  generator's docs as time-ordered logs around an incident (corpus.py
  ``with_incident_terms``) at a size whose selections pass
  PRUNE_MIN_BLOCKS: every incident term's bind prunes, and the pruned
  hits equal the exact ask's (ids, order, scores bit for bit), which
  hold the float64 oracle's total and top k (a missed oracle doc ties
  the kth score within rtol 1e-5, the plan path's float32 rule).
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.corpus import (build_corpus, exact_topk,
                                            segment_from_corpus, term_name,
                                            with_incident_terms)
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.ops import fastpath as tfp
from elasticsearch_tpu_torch.ops.bm25_contrib import (
    gather_bm25_contrib, gather_bm25_contrib_plain)
from elasticsearch_tpu_torch.ops.plan import build_term_impacts
from elasticsearch_tpu_torch.search import fastpath as srv
from elasticsearch_tpu_torch.search import plan as tplan
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.search.searcher import ShardSearcher

pytestmark = pytest.mark.cuda

K1, B = 1.2, 0.75
Q, NB, K = 32, 256, 1000


def cohort(seed=3, n_docs=40000):
    """The corpus generator at 40K docs; 32 queries of three mid-df
    terms (essential) and the two hottest (non-essential), the NE bound
    their block-max maxima, half the rows on a mask row with dead docs."""
    c = build_corpus(np.random.default_rng(seed), n_docs=n_docs, vocab=3000)
    tb = c["block_docids"].shape[0]
    bd = np.concatenate([c["block_docids"], np.zeros((1, 128), np.int32)])
    bt = np.concatenate([c["block_tfs"], np.zeros((1, 128), np.float32)])
    df, nb, starts, lens = c["df"], c["nb"], c["tbs"][:-1], c["lens"]
    idf = np.log1p((n_docs - df + 0.5) / (df + 0.5))
    max_tf = bt[:tb].max(axis=1)
    ml = np.where(bt[:tb] > 0, lens[bd[:tb]], np.inf).min(axis=1)
    imp = build_term_impacts(starts, nb, max_tf,
                             np.where(np.isfinite(ml), ml, 0.0), idf,
                             float(lens.mean()), K1, B)
    hot = [int(t) for t in np.argsort(-df)[:2]]
    dense = np.zeros((2, n_docs), np.float16)
    for row, t in enumerate(hot):
        s = int(starts[t]) * 128
        dense[row, bd.reshape(-1)[s:s + df[t]]] = bt.reshape(-1)[s:s + df[t]]
    rng = np.random.default_rng(seed)
    mids_pool = np.nonzero((df >= 600) & (df <= 1500))[0]
    sel = np.full((Q, NB), tb, np.int32)
    ws = np.zeros((Q, NB))
    ns = np.zeros((Q, tfp.NE_SLOTS), np.int32)
    nl = np.zeros((Q, tfp.NE_SLOTS), np.int32)
    nr = np.full((Q, tfp.NE_SLOTS), -1, np.int32)
    ni = np.zeros((Q, tfp.NE_SLOTS))
    bound = np.zeros(Q)
    for qi in range(Q):
        pos = 0
        for t in rng.choice(mids_pool, 3, replace=False):
            sel[qi, pos:pos + nb[t]] = np.arange(starts[t], starts[t] + nb[t])
            ws[qi, pos:pos + nb[t]] = idf[t]
            pos += nb[t]
        for i, t in enumerate(hot):
            ns[qi, i], nl[qi, i], nr[qi, i] = starts[t] * 128, df[t], i
            ni[qi, i] = idf[t]
            bound[qi] += imp.ub_desc[starts[t]]
    masks = np.ones((tfp.F_SLOTS, n_docs), bool)
    masks[1] = rng.random(n_docs) < 0.8
    mids = (np.arange(Q) % 2).astype(np.int32)
    return dict(bd=bd, bt=bt, lens=lens, avg=float(lens.mean()), sel=sel,
                ws=ws, ns=ns, nl=nl, nr=nr, ni=ni, bound=bound, dense=dense,
                masks=masks, mids=mids)


def run(d, dev, op):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    f64 = torch.float64
    bd, bt = t(d["bd"]), t(d["bt"])
    tail = (t(d["lens"]), t(d["masks"]), t(d["mids"]))
    if op == "binary":
        out = tfp.bm25_essential_topk_batch(
            bd, bt, bd.view(-1), bt.view(-1), t(d["sel"]), t(d["ws"]), *tail,
            t(d["ns"]), t(d["nl"]), t(d["ni"]), t(d["bound"]), d["avg"], K1,
            B, K, score_dtype=f64)
    else:
        out = tfp.bm25_essential_dense_topk_batch(
            bd, bt, t(d["dense"]), t(d["sel"]), t(d["ws"]), *tail,
            t(d["nr"]), t(d["ni"]), t(d["bound"]), d["avg"], K1, B, K,
            score_dtype=f64)
    return out.cpu().numpy()


@pytest.mark.parametrize("op", ["binary", "dense"])
def test_essential_op_on_card_equals_plain_twin(cuda_device, monkeypatch,
                                                op):
    d = cohort()
    before = gather_bm25_contrib.launches
    got = run(d, cuda_device, op)
    assert gather_bm25_contrib.launches == before + 1
    monkeypatch.setattr(tfp, "gather_bm25_contrib",
                        gather_bm25_contrib_plain)
    want = run(d, cuda_device, op)
    np.testing.assert_array_equal(got, want)
    assert got[:, 2 * K].all()          # every row certified


def test_theta_warm_repeat_on_card(cuda_device):
    c = build_corpus(np.random.default_rng(5), n_docs=20000, vocab=3000)
    df = c["df"]
    mids = [int(t) for t in np.nonzero((df >= 300) & (df <= 600))[0]]
    q = sorted(mids[:4] + [int(np.argmax(df))])
    fp = srv.FastPathServer(cuda_device, DeviceSegmentCache(cuda_device))
    fp.start()
    try:
        reg = fp.register("idx", segment_from_corpus(c), "title", K1, B)
        cold = fp.search(reg, q, 1000)
        warm = fp.search(reg, q, 1000)
        assert fp.serving_stats()["dispatch"] == {"v2m:1024": 1,
                                                  "ess:256": 1}
        np.testing.assert_array_equal(cold[0], warm[0])
        np.testing.assert_array_equal(cold[1], warm[1])
        assert cold[2] == warm[2]
        ids, _, total = exact_topk(c, q, 1000)
        assert warm[2] == total and set(warm[1].tolist()) == set(ids.tolist())
    finally:
        assert fp.stop()


def test_plan_prune_on_card(cuda_device, monkeypatch):
    c = with_incident_terms(
        build_corpus(np.random.default_rng(4), n_docs=400000, vocab=20000),
        np.random.default_rng(9))
    pruned_binds = []
    orig = tplan._prune_fields

    def counted(*a, **kw):
        out, pruned = orig(*a, **kw)
        pruned_binds.append(pruned)
        return out, pruned

    monkeypatch.setattr(tplan, "_prune_fields", counted)
    # the incident terms hold about 210 blocks each at 400K docs
    monkeypatch.setattr(tplan, "PRUNE_MIN_BLOCKS", 128)
    srch = ShardSearcher([segment_from_corpus(c)],
                         DocumentMapper({"properties": {"title":
                                                        {"type": "text"}}}),
                         DeviceSegmentCache(cuda_device))
    for t in range(20000, len(c["df"])):
        for k in (10, 1000):
            q = parse_query({"match": {"title": term_name(t)}})
            exact = srch.query_phase(q, k, track_total_hits=True)
            pruned = srch.query_phase(q, k, track_total_hits=10000)
            assert pruned.total_lower_bound, (t, k)
            assert [d.docid for d in pruned.docs] == \
                [d.docid for d in exact.docs]
            np.testing.assert_array_equal([d.score for d in pruned.docs],
                                          [d.score for d in exact.docs])
            ids, sc, total = exact_topk(c, [t], k)
            assert exact.total_hits == total
            # the plan path ranks float32 sums: an oracle doc it misses
            # ties the kth score within float32 rounding
            missing = ~np.isin(ids, [d.docid for d in exact.docs])
            assert np.all(np.abs(sc[missing] - sc[-1]) <= 1e-5 * sc[-1])
    assert len(pruned_binds) == 16 and all(pruned_binds)
