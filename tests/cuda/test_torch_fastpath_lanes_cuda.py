"""The v1 and v2 cohort launches (ops/fastpath.py
``bm25_topk_total_batch``, ``bm25_candidates_rerank_batch``) on the card
against the same launches on the CPU, where the kernel wrappers run
their twins: ids, totals and v2's certificate exact, values within rtol
1e-7. The cohort mixes a mask row with dead docs, a term given twice and
a union wider than v2's candidate set (a finite certificate bound)."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.ops.fastpath import (
    CAND_V2, F_SLOTS, MAX_T, bm25_candidates_rerank_batch,
    bm25_topk_total_batch)
from elasticsearch_tpu_torch.ops.merge import merge_sorted_slots

pytestmark = pytest.mark.cuda

K1, B = 1.2, 0.75
ND, Q, NB, N_SLOTS, K = 8192, 4, 64, 16, 60


def segment(rng, n_terms=8):
    """Per-term docid-ascending postings in consecutive 128-wide blocks,
    then the reserved zero block."""
    bd, bt, starts, nbs, dfs = [], [], [], [], []
    nxt = 0
    for _ in range(n_terms):
        df = int(rng.integers(900, 1500))
        docs = np.sort(rng.choice(ND, df, replace=False)).astype(np.int32)
        nb = -(-df // 128)
        d = np.zeros(nb * 128, np.int32)
        f = np.zeros(nb * 128, np.float32)
        d[:df], f[:df] = docs, rng.integers(1, 6, df)
        bd.append(d.reshape(nb, 128))
        bt.append(f.reshape(nb, 128))
        starts.append(nxt)
        nbs.append(nb)
        dfs.append(df)
        nxt += nb
    bd.append(np.zeros((1, 128), np.int32))
    bt.append(np.zeros((1, 128), np.float32))
    return (np.concatenate(bd), np.concatenate(bt), np.array(starts),
            np.array(nbs), np.array(dfs), nxt)


def inputs(seed):
    rng = np.random.default_rng(seed)
    bd, bt, starts, nbs, dfs, zero = segment(rng)
    idf = np.log1p((ND - dfs + 0.5) / (dfs + 0.5))
    queries = [[0, 1, 2, 3, 4], [5, 5, 6], [7], [1, 3, 5, 7]]
    slot = NB // N_SLOTS
    sel = {s: np.full((Q, NB), zero, np.int32) for s in (True, False)}
    ws = {s: np.zeros((Q, NB)) for s in (True, False)}
    ts = np.zeros((Q, MAX_T), np.int32)
    tl = np.zeros((Q, MAX_T), np.int32)
    ti = np.zeros((Q, MAX_T))
    for qi, terms in enumerate(queries):
        for slotted in (True, False):
            pos = 0
            for t in terms:
                sel[slotted][qi, pos:pos + nbs[t]] = \
                    np.arange(starts[t], starts[t] + nbs[t])
                ws[slotted][qi, pos:pos + nbs[t]] = idf[t]
                pos += -(-nbs[t] // slot) * slot if slotted else nbs[t]
        for i, t in enumerate(terms):
            ts[qi, i], tl[qi, i], ti[qi, i] = starts[t] * 128, dfs[t], idf[t]
    lens = rng.integers(1, 50, ND).astype(np.float32)
    masks = np.ones((F_SLOTS, ND), bool)
    masks[1] = rng.random(ND) < 0.8
    mids = np.array([0, 1, 0, 1], np.int32)
    return dict(bd=bd, bt=bt, sel=sel, ws=ws, ts=ts, tl=tl, ti=ti,
                lens=lens, masks=masks, mids=mids)


def run_v1(d, dev, dtype):
    def t(a):
        return torch.from_numpy(a).to(dev)

    return bm25_topk_total_batch(
        t(d["bd"]), t(d["bt"]), t(d["sel"][False]),
        t(d["ws"][False]).to(dtype), t(d["lens"]), t(d["masks"]),
        t(d["mids"]), float(d["lens"].mean()), K1, B, K,
        score_dtype=dtype).cpu().numpy()


def run_v2(d, dev, dtype):
    def t(a):
        return torch.from_numpy(a).to(dev)

    return bm25_candidates_rerank_batch(
        t(d["bd"]), t(d["bt"]), t(d["bd"]).view(-1), t(d["bt"]).view(-1),
        t(d["sel"][True]), t(d["ws"][True]).to(torch.float32), t(d["lens"]),
        t(d["masks"]), t(d["mids"]), t(d["ts"]), t(d["tl"]),
        t(d["ti"]).to(dtype), float(d["lens"].mean()), N_SLOTS, K1, B, K,
        score_dtype=dtype).cpu().numpy()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_v1_cohort_on_card_equals_cpu(cuda_device, dtype):
    d = inputs(5)
    before = gather_bm25_contrib.launches
    got = run_v1(d, cuda_device, dtype)
    assert gather_bm25_contrib.launches == before + 1
    want = run_v1(d, torch.device("cpu"), dtype)
    np.testing.assert_array_equal(got[:, K:], want[:, K:])
    np.testing.assert_allclose(got[:, :K], want[:, :K], rtol=1e-7, atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_v2_cohort_on_card_equals_cpu(cuda_device, dtype):
    d = inputs(6)
    before = (gather_bm25_contrib.launches, merge_sorted_slots.launches)
    got = run_v2(d, cuda_device, dtype)
    assert (gather_bm25_contrib.launches, merge_sorted_slots.launches) \
        == (before[0] + 1, before[1] + 1)
    want = run_v2(d, torch.device("cpu"), dtype)
    np.testing.assert_array_equal(got[:, K:], want[:, K:])
    np.testing.assert_allclose(got[:, :K], want[:, :K], rtol=1e-7, atol=0)
    assert (got[:, 2 * K] > CAND_V2).any()      # a finite bound
    assert got[:, 2 * K + 1].all()
