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

``logs_columns`` gives the corpus read as time-ordered logs
(``with_incident_terms``) the numeric columns of a web server's access
log, the shape of Rally's ``http_logs`` track: ``@timestamp`` (a date),
``status`` and ``bytes``.

``unit_vectors`` and ``knn_query_vectors`` make the dense_vector data of
the kNN configurations (the reference bench's recipe): seeded unit
vectors, generated in row chunks on a torch device, and queries that are
a random doc plus 0.25 of Gaussian noise, normalized.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

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


def with_incident_terms(corpus: Dict[str, np.ndarray],
                        rng: np.random.Generator, n_terms: int = 8,
                        span: int = 16) -> Dict[str, np.ndarray]:
    """The corpus as time-ordered logs around an incident (docid order is
    ingestion order): ``n_terms`` new terms, ids ``vocab ..
    vocab + n_terms - 1``. Each doc of the incident window (the first
    n_docs // ``span``) holds one of them 4-8 times; each later doc holds
    one of them once, with probability 1/2; a doc's length grows by what
    it gained. The docs of the window hold every incident term's best
    scores, so block-max window pruning (search/plan.py) can drop the
    windows after it. Returns a new corpus dict; ``corpus`` is kept."""
    n = len(corpus["lens"])
    vocab = len(corpus["df"])
    term = rng.integers(0, n_terms, n)
    tf = np.where(np.arange(n) < n // span, rng.integers(4, 9, n),
                  rng.random(n) < 0.5).astype(np.float32)
    docs = np.nonzero(tf > 0)[0]
    docs = docs[np.argsort(term[docs], kind="stable")]   # by term, docid
    t_new, f_new = term[docs], tf[docs]
    df_new = np.bincount(t_new, minlength=n_terms)
    nb_new = (df_new + BLOCK_SIZE - 1) // BLOCK_SIZE
    tbs_new = np.zeros(n_terms + 1, np.int64)
    np.cumsum(nb_new, out=tbs_new[1:])
    gs_new = np.zeros(n_terms + 1, np.int64)
    np.cumsum(df_new, out=gs_new[1:])
    dest = (tbs_new[t_new] * BLOCK_SIZE
            + np.arange(len(docs), dtype=np.int64) - gs_new[t_new])
    bd = np.zeros(int(tbs_new[-1]) * BLOCK_SIZE, np.int32)
    bt = np.zeros(int(tbs_new[-1]) * BLOCK_SIZE, np.float32)
    bd[dest] = docs
    bt[dest] = f_new
    base_blocks = corpus["block_docids"].shape[0]
    base_post = int(corpus["group_start"][-1])
    return dict(
        block_docids=np.concatenate(
            [corpus["block_docids"], bd.reshape(-1, BLOCK_SIZE)]),
        block_tfs=np.concatenate(
            [corpus["block_tfs"], bt.reshape(-1, BLOCK_SIZE)]),
        tbs=np.concatenate([corpus["tbs"], base_blocks + tbs_new[1:]]),
        nb=np.concatenate([corpus["nb"], nb_new]),
        df=np.concatenate([corpus["df"], df_new]),
        lens=corpus["lens"] + tf,
        doc_ids=np.concatenate([corpus["doc_ids"],
                                docs.astype(np.int32)]),
        tf=np.concatenate([corpus["tf"], f_new]),
        group_start=np.concatenate([corpus["group_start"],
                                    base_post + gs_new[1:]]))


# 2026-01-01T00:00:00Z in epoch milliseconds
LOGS_T0_MS = 1_767_225_600_000
DAY_MS = 86_400_000


def logs_columns(n_docs: int, rng: np.random.Generator,
                 span: int = 16) -> Dict[str, Dict[str, np.ndarray]]:
    """Seeded access-log columns for ``n_docs`` docs in ingestion
    (docid) order, as ``segment_from_numpy``'s ``numerics``:

    - ``@timestamp`` (epoch ms, float64): 24 h from LOGS_T0_MS, docid
      order is time order, each doc at its even share of the day plus a
      seeded jitter below one share, so timestamps strictly increase;
    - ``status``: 200 for about 90 % of docs, else 304, 404 or 500; in
      the incident window (the first ``n_docs // span`` docs, as
      ``with_incident_terms``) about 30 % are 500;
    - ``bytes``: lognormal response sizes (median about 3 KB), missing
      (NaN) on about 2 % of docs."""
    share = DAY_MS // n_docs
    ts = (LOGS_T0_MS + (np.arange(n_docs, dtype=np.int64) * DAY_MS)
          // n_docs + rng.integers(0, max(share, 1), n_docs))
    status = np.where(rng.random(n_docs) < 0.9, 200,
                      rng.choice([304, 404, 500], n_docs))
    incident = (np.arange(n_docs) < n_docs // span) \
        & (rng.random(n_docs) < 0.3)
    status = np.where(incident, 500, status)
    size = np.round(rng.lognormal(8.0, 1.2, n_docs))
    size[rng.random(n_docs) < 0.02] = np.nan
    return {"@timestamp": {"values": ts.astype(np.float64)},
            "status": {"values": status.astype(np.float64)},
            "bytes": {"values": size}}


LOGS_MAPPINGS = {"properties": {"title": {"type": "text"},
                                "@timestamp": {"type": "date"},
                                "status": {"type": "integer"},
                                "bytes": {"type": "long"}}}


def unit_vectors(n: int, dims: int, seed: int, device="cpu",
                 chunk: int = 1 << 18) -> np.ndarray:
    """float32 [n, dims] host array of seeded unit vectors (Gaussian
    rows, each divided by its norm), drawn in row chunks of ``chunk`` by
    a ``torch.Generator`` on ``device`` and copied into the host array as
    they come, so only the result is ever whole. The stream depends on
    the device type: the same seed gives other vectors on CUDA than on
    the CPU."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = np.empty((n, dims), np.float32)
    host = torch.from_numpy(out)
    for lo in range(0, n, chunk):
        rows = torch.randn((min(chunk, n - lo), dims), generator=gen,
                           device=device)
        rows /= torch.linalg.vector_norm(rows, dim=1, keepdim=True)
        host[lo:lo + rows.shape[0]].copy_(rows)
    return out


def knn_query_vectors(vectors: np.ndarray, n: int,
                      rng: np.random.Generator,
                      noise: float = 0.25) -> np.ndarray:
    """float32 [n, dims]: each a random row of ``vectors`` plus ``noise``
    times a standard Gaussian, normalized (the reference bench's kNN
    queries)."""
    dims = vectors.shape[1]
    out = np.empty((n, dims), np.float32)
    for i in range(n):
        q = vectors[rng.integers(len(vectors))] + noise * \
            rng.standard_normal(dims).astype(np.float32)
        out[i] = q / np.linalg.norm(q)
    return out


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


# plan-path documents and query bodies: the shapes of the reference's
# plan tests (tests/test_plan.py), on text fields `title` and `body`, a
# keyword field `tag` and a numeric field `views`
PLAN_MAPPINGS = {"properties": {"title": {"type": "text"},
                                "body": {"type": "text"},
                                "tag": {"type": "keyword"},
                                "views": {"type": "long"}}}
PLAN_VOCAB = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
              "theta", "iota", "kappa", "wolf", "fox", "dog", "cat", "bird",
              "fish", "tree", "rock", "lake", "hill"]
PLAN_TAGS = ["red", "green", "blue", "yellow"]
# the reference's plan test cases, in order; the ones holding a `range`
# clause put a dense factor into the plan launch
PLAN_CASES = [
    {"match": {"title": "alpha wolf"}},
    {"match": {"body": {"query": "alpha beta gamma", "operator": "and"}}},
    {"match": {"body": {"query": "alpha beta gamma delta",
                        "minimum_should_match": 2}}},
    {"match": {"body": {"query": "alpha beta gamma delta",
                        "minimum_should_match": "75%"}}},
    {"term": {"tag": "red"}},
    {"term": {"title": "fox"}},
    {"terms": {"tag": ["red", "blue"]}},
    {"multi_match": {"query": "wolf lake", "fields": ["title", "body"]}},
    {"multi_match": {"query": "wolf lake", "fields": ["title", "body"],
                     "type": "most_fields"}},
    {"multi_match": {"query": "wolf lake", "fields": ["title", "body"],
                     "tie_breaker": 0.3}},
    {"dis_max": {"queries": [{"match": {"title": "alpha"}},
                             {"match": {"body": "wolf fox"}}],
                 "tie_breaker": 0.5}},
    {"constant_score": {"filter": {"term": {"tag": "green"}}, "boost": 2.0}},
    {"bool": {"must": [{"match": {"title": "alpha beta"}}],
              "filter": [{"term": {"tag": "red"}}]}},
    {"bool": {"must": [{"match": {"body": "wolf"}}],
              "must_not": [{"term": {"tag": "blue"}}]}},
    {"bool": {"should": [{"match": {"title": "alpha"}},
                         {"match": {"body": "fox dog"}}],
              "minimum_should_match": 1}},
    {"bool": {"should": [{"match": {"title": "alpha"}},
                         {"match": {"body": "fox"}},
                         {"term": {"tag": "red"}}],
              "minimum_should_match": 2}},
    {"bool": {"must": [{"match": {"body": "lake hill rock"}}],
              "filter": [{"range": {"views": {"gte": 20, "lt": 80}}}]}},
    {"bool": {"must": [{"match": {"title": "wolf"}},
                       {"match": {"body": "alpha"}}],
              "filter": [{"term": {"tag": "red"}},
                         {"range": {"views": {"gte": 10}}}],
              "must_not": [{"term": {"tag": "yellow"}},
                           {"range": {"views": {"gte": 95}}}]}},
    {"bool": {"must": [{"match": {"title": "fox"}}],
              "should": [{"match": {"body": "alpha"}},
                         {"match": {"body": "beta"}}]}},
    {"bool": {"filter": [{"match": {"body": {"query": "alpha beta",
                                             "operator": "and"}}}]}},
    {"match": {"title": {"query": "wolf fox", "boost": 2.5}}},
    {"bool": {"must": [{"match": {"title": "wolf"}},
                       {"range": {"views": {"gte": 5}}}]}},
]


def plan_doc(rng: np.random.Generator) -> Dict[str, str]:
    """A document of the shape of the reference's plan test fixture."""
    return {"title": " ".join(rng.choice(PLAN_VOCAB,
                                         int(rng.integers(1, 8)))),
            "body": " ".join(rng.choice(PLAN_VOCAB,
                                        int(rng.integers(2, 20)))),
            "tag": str(rng.choice(PLAN_TAGS)),
            "views": int(rng.integers(0, 100))}


def segment_from_corpus(corpus: Dict[str, np.ndarray], field: str = "title",
                        name: str = "corpus0", numerics=None,
                        vectors=None) -> Segment:
    """The corpus as one port Segment over a text field of the terms
    ``t000000 ...`` (ids are the docids as text; no ``_source``), with
    the numeric columns ``numerics`` (``logs_columns``) and the vector
    fields ``vectors`` (``segment_from_numpy``'s form) when given; the
    block-max metadata is computed from the blocks
    (index/segment.py ``block_max_meta``)."""
    vocab = len(corpus["df"])
    postings = dict(
        terms=[term_name(i) for i in range(vocab)],
        doc_freq=corpus["df"], term_block_start=corpus["tbs"][:-1],
        term_block_count=corpus["nb"],
        block_docids=corpus["block_docids"], block_tfs=corpus["block_tfs"],
        field_lengths=corpus["lens"])
    return segment_from_numpy({"fields": {field: postings},
                               "numerics": numerics, "vectors": vectors},
                              name=name)


def dense_scores(corpus: Dict[str, np.ndarray], terms: List[int],
                 k1: float = 1.2, b: float = 0.75) -> np.ndarray:
    """float64 BM25 of every doc [n_docs] for the query ``terms``."""
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
    return scores


def docs_with_all(corpus: Dict[str, np.ndarray], terms) -> np.ndarray:
    """bool [n_docs]: the docs that hold every term of ``terms``."""
    keep = np.ones(len(corpus["lens"]), bool)
    gs = corpus["group_start"]
    for t in terms:
        has = np.zeros_like(keep)
        has[corpus["doc_ids"][int(gs[t]):int(gs[t + 1])]] = True
        keep &= has
    return keep


def exact_topk(corpus: Dict[str, np.ndarray], terms: List[int], k: int,
               k1: float = 1.2, b: float = 0.75, keep=None):
    """Dense float64 BM25 over every doc (only the docs of ``keep``, a
    bool mask, when given): (docids of the top k by (score desc, docid
    asc), their float64 scores, total matches)."""
    scores = dense_scores(corpus, terms, k1, b)
    if keep is not None:
        scores = np.where(keep, scores, 0.0)
    matched = np.nonzero(scores > 0)[0]
    total = len(matched)
    key = scores[matched]
    if total > k:       # only the docs at or above the kth value
        at = total - k
        kth = np.partition(key, at)[at]
        matched, key = matched[key >= kth], key[key >= kth]
    order = matched[np.lexsort((matched, -key))][:k]
    return order, scores[order], total
