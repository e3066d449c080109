"""Seeded synthetic corpus and query log (the recipe of the reference
repository's ``bench.py`` ``build_corpus`` / ``make_queries``), built
straight into the postings-block layout, plus the float64 oracle the
serving path is held against.

At the defaults: 2M docs, a 100K-term vocabulary, lognormal doc lengths
around 40 tokens clipped to [5, 200], Zipf(1.07) term draws, and term
burstiness 0.35 (each token repeats the previous token of its doc with
that probability, giving tf a heavy tail). Queries have 1-8 terms drawn
across three document-frequency bands; the commonest terms are dropped
until a query's selection fits ``max_blocks``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from elasticsearch_tpu_torch.index.segment import (BLOCK_SIZE, Segment,
                                                   segment_from_numpy)

N_DOCS = 2_000_000
VOCAB = 100_000
AVG_LEN = 40
BURST = 0.35
ZIPF = 1.07


def build_corpus(rng: np.random.Generator, n_docs: int = N_DOCS,
                 vocab: int = VOCAB, avg_len: int = AVG_LEN,
                 burst: float = BURST) -> Dict[str, np.ndarray]:
    """Postings in block layout: ``block_docids``/``block_tfs``
    [TB, 128] (no reserved zero block), ``tbs`` [vocab + 1] block starts,
    ``nb``, ``df``, ``lens`` float32 [n_docs], and the flat
    ``doc_ids``/``tf`` grouped by term with ``group_start``."""
    lens = np.clip(rng.lognormal(np.log(avg_len), 0.4, n_docs),
                   5, 200).astype(np.int32)
    total = int(lens.sum())
    u = rng.random(total)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -ZIPF)
    cdf /= cdf[-1]
    terms = np.searchsorted(cdf, u).astype(np.int64)
    del u
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    if burst > 0:
        copy = rng.random(total) < burst
        doc_start = np.zeros(total, bool)
        doc_start[0] = True
        doc_start[np.cumsum(lens)[:-1]] = True
        copy &= ~doc_start
        src = np.where(~copy, np.arange(total), 0)
        np.maximum.accumulate(src, out=src)
        terms = terms[src]
        del copy, doc_start, src
    keys = terms * n_docs + doc_of
    del terms, doc_of
    uniq, tf = np.unique(keys, return_counts=True)
    del keys
    term_of = (uniq // n_docs).astype(np.int32)
    doc_ids = (uniq % n_docs).astype(np.int32)
    del uniq
    tf = tf.astype(np.float32)
    n_postings = len(doc_ids)

    df = np.bincount(term_of, minlength=vocab)
    nb = (df + BLOCK_SIZE - 1) // BLOCK_SIZE
    tbs = np.zeros(vocab + 1, np.int64)
    np.cumsum(nb, out=tbs[1:])
    total_blocks = int(tbs[-1])
    group_start = np.zeros(vocab + 1, np.int64)
    np.cumsum(df, out=group_start[1:])
    rank_in_term = np.arange(n_postings, dtype=np.int64) \
        - group_start[term_of]
    dest = tbs[term_of] * BLOCK_SIZE + rank_in_term
    del rank_in_term, term_of
    block_docids = np.zeros(total_blocks * BLOCK_SIZE, np.int32)
    block_tfs = np.zeros(total_blocks * BLOCK_SIZE, np.float32)
    block_docids[dest] = doc_ids
    block_tfs[dest] = tf
    del dest
    return dict(block_docids=block_docids.reshape(total_blocks, BLOCK_SIZE),
                block_tfs=block_tfs.reshape(total_blocks, BLOCK_SIZE),
                tbs=tbs, nb=nb, df=df, lens=lens.astype(np.float32),
                doc_ids=doc_ids, tf=tf, group_start=group_start)


def term_name(t: int) -> str:
    return f"t{t:06d}"


def make_queries(rng: np.random.Generator, df: np.ndarray,
                 n_docs: int = N_DOCS, n_queries: int = 256,
                 max_blocks: int = 4096) -> List[List[int]]:
    """``n_queries`` sorted term-id lists of 1-8 distinct terms drawn
    across df bands (rare-ish, mid, common)."""
    bands = [
        np.nonzero((df > 200) & (df <= n_docs // 100))[0],
        np.nonzero((df > n_docs // 100) & (df <= n_docs // 20))[0],
        np.nonzero(df > n_docs // 20)[0],
    ]
    bands = [b for b in bands if len(b) > 0]
    if not bands:
        bands = [np.nonzero(df > 0)[0]]
    nb = (df + BLOCK_SIZE - 1) // BLOCK_SIZE
    queries = []
    for _ in range(n_queries):
        n_terms = int(rng.integers(1, 9))
        terms = []
        for _ in range(n_terms):
            band = bands[min(int(rng.integers(0, len(bands))),
                             len(bands) - 1)]
            terms.append(int(rng.choice(band)))
        q = sorted(set(terms))
        while len(q) > 1 and sum(int(nb[t]) for t in q) > max_blocks:
            q.remove(max(q, key=lambda t: int(nb[t])))
        queries.append(q)
    return queries


def segment_from_corpus(corpus: Dict[str, np.ndarray], field: str = "title",
                        name: str = "corpus0") -> Segment:
    """The corpus as one port Segment over a text field of the terms
    ``t000000 ...`` (ids are the docids as text; no ``_source``)."""
    vocab = len(corpus["df"])
    return segment_from_numpy(dict(
        terms=[term_name(i) for i in range(vocab)],
        doc_freq=corpus["df"], term_block_start=corpus["tbs"][:-1], term_block_count=corpus["nb"],
        block_docids=corpus["block_docids"], block_tfs=corpus["block_tfs"],
        field_lengths=corpus["lens"]), name=name, field=field)


def exact_topk(corpus: Dict[str, np.ndarray], terms: List[int], k: int,
               k1: float = 1.2, b: float = 0.75):
    """Dense float64 BM25 over every doc: (docids of the top k by
    (score desc, docid asc), their float64 scores, total matches)."""
    lens = corpus["lens"]
    n = len(lens)
    avg = float(lens.sum(dtype=np.float64)) / float((lens > 0).sum())
    gs, d_all, tf_all, df = (corpus["group_start"], corpus["doc_ids"],
                             corpus["tf"], corpus["df"])
    scores = np.zeros(n, np.float64)
    for t in terms:
        lo, hi = int(gs[t]), int(gs[t + 1])
        d = d_all[lo:hi]
        f = tf_all[lo:hi].astype(np.float64)
        w = np.log(1.0 + (n - df[t] + 0.5) / (df[t] + 0.5))
        norm = k1 * (1.0 - b + b * lens[d].astype(np.float64) / avg)
        scores[d] += w * f / (f + norm)
    matched = np.nonzero(scores > 0)[0]
    order = matched[np.lexsort((matched, -scores[matched]))][:k]
    return order, scores[order], len(matched)
