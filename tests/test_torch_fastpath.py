"""The port's cohort launch ``bm25_topk_total_merge_batch``
(elasticsearch_tpu_torch/ops/fastpath.py) against the reference's
function of the same name on the same slotted cohort (Q = 4, NB = 64,
16 slots): at float32 the packed [values | ids | total] rows agree, ids
and totals exactly and values within rtol 1e-6, tie-heavy inputs
included. At float64 the port agrees with a numpy float64 oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops.fastpath import F_SLOTS as JAX_F_SLOTS
from elasticsearch_tpu.ops.fastpath import \
    bm25_topk_total_merge_batch as jax_batch
from elasticsearch_tpu_torch.corpus import build_corpus
from elasticsearch_tpu_torch.ops.fastpath import (
    F_SLOTS, bm25_topk_total_merge_batch)
from elasticsearch_tpu_torch.ops.plan import unpack_ids

Q, NB, N_SLOTS, K = 4, 64, 16, 50
K1, B = 1.2, 0.75


def make_cohort(seed, n_docs=3000, equal_lens=False):
    """A seeded corpus in block layout (+ the reserved zero block) and a
    slotted selection: each term instance starts on a slot boundary."""
    rng = np.random.default_rng(seed)
    c = build_corpus(rng, n_docs=n_docs, vocab=400)
    lens = c["lens"]
    if equal_lens:      # scores then depend on tf and idf only: ties
        lens = np.full_like(lens, 12.0)
    tb = c["block_docids"].shape[0]
    bd = np.concatenate([c["block_docids"], np.zeros((1, 128), np.int32)])
    bt = np.concatenate([c["block_tfs"], np.zeros((1, 128), np.float32)])
    df, nb, starts = c["df"], c["nb"], c["tbs"]
    idf = np.log1p((n_docs - df + 0.5) / (df + 0.5))
    slot = NB // N_SLOTS
    sel = np.full((Q, NB), tb, np.int32)
    ws = np.zeros((Q, NB), np.float64)
    queries = []
    for qi in range(Q):
        pos, terms = 0, []
        for t in rng.permutation(np.nonzero(nb > 0)[0]):
            need = -(-int(nb[t]) // slot) * slot
            if pos + need > NB or len(terms) == 6:
                continue
            sel[qi, pos:pos + nb[t]] = np.arange(starts[t], starts[t] + nb[t])
            ws[qi, pos:pos + nb[t]] = idf[t]
            pos += need
            terms.append(int(t))
        queries.append(terms)
    masks = np.ones((F_SLOTS, n_docs), bool)
    masks[1] = rng.random(n_docs) < 0.8            # a row with dead docs
    mids = np.array([0, 1, 0, 1], np.int32)
    return dict(bd=bd, bt=bt, sel=sel, ws=ws, lens=lens.astype(np.float32),
                masks=masks, mids=mids, queries=queries, corpus=c, idf=idf)


def run_port(d, dtype, avg):
    t = torch.from_numpy
    return bm25_topk_total_merge_batch(
        t(d["bd"]), t(d["bt"]), t(d["sel"]),
        t(d["ws"]).to(dtype), t(d["lens"]), t(d["masks"]), t(d["mids"]),
        avg, N_SLOTS, K1, B, K, score_dtype=dtype).numpy()


@pytest.mark.parametrize("seed,equal_lens", [(0, False), (1, False),
                                             (2, True), (3, True)])
def test_packed_rows_match_reference_f32(seed, equal_lens):
    assert F_SLOTS == JAX_F_SLOTS
    d = make_cohort(seed, equal_lens=equal_lens)
    avg = float(np.float32(d["lens"].mean()))
    ref = np.asarray(jax_batch(
        jnp.asarray(d["bd"]), jnp.asarray(d["bt"]), jnp.asarray(d["sel"]),
        jnp.asarray(d["ws"].astype(np.float32)), jnp.asarray(d["lens"]),
        jnp.asarray(d["masks"]), jnp.asarray(d["mids"]), np.float32(avg),
        N_SLOTS, K1, B, K))
    got = run_port(d, torch.float32, avg)
    assert got.shape == ref.shape == (Q, 2 * K + 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, K:], ref[:, K:])   # ids + totals
    np.testing.assert_allclose(got[:, :K], ref[:, :K], rtol=1e-6, atol=0)
    if equal_lens:      # the inputs really are tie-heavy at the cut
        vals = got[:, :K]
        assert any(len(np.unique(v[np.isfinite(v)])) < K // 2 for v in vals)


def oracle(d, qi, avg):
    """float64 per-doc BM25 over the query's terms, live docs of its mask
    row only: (ids by (score desc, docid asc) [:K], scores, total)."""
    c = d["corpus"]
    lens = d["lens"].astype(np.float64)
    scores = np.zeros(len(lens))
    for t in d["queries"][qi]:
        lo, hi = c["group_start"][t], c["group_start"][t + 1]
        docs, tf = c["doc_ids"][lo:hi], c["tf"][lo:hi].astype(np.float64)
        scores[docs] += d["idf"][t] * tf / (
            tf + K1 * (1 - B + B * lens[docs] / avg))
    scores[~d["masks"][d["mids"][qi]]] = 0.0
    matched = np.nonzero(scores > 0)[0]
    top = matched[np.lexsort((matched, -scores[matched]))][:K]
    return top, scores[top], len(matched)


@pytest.mark.parametrize("seed", [4, 5])
def test_f64_rail_matches_numpy_oracle(seed):
    d = make_cohort(seed)
    avg = float(d["lens"].astype(np.float64).mean())
    got = run_port(d, torch.float64, avg)
    for qi in range(Q):
        ids, scores, total = oracle(d, qi, avg)
        n = len(ids)
        assert int(got[qi, 2 * K]) == total
        np.testing.assert_array_equal(unpack_ids(got[qi, K:K + n]), ids)
        np.testing.assert_allclose(got[qi, :n], scores.astype(np.float32),
                                   rtol=1e-7, atol=0)
        assert np.isneginf(got[qi, n:K]).all()
        assert (unpack_ids(got[qi, K + n:2 * K]) == 0x7FFFFFFF).all()


def test_rail_dtype_follows_score_dtype():
    d = make_cohort(6)
    avg = float(d["lens"].mean())
    a = run_port(d, torch.float32, avg)
    b = run_port(d, torch.float64, avg)
    np.testing.assert_array_equal(a[:, 2 * K], b[:, 2 * K])
    np.testing.assert_allclose(a[:, :K], b[:, :K], rtol=1e-6)
