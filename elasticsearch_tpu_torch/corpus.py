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

``shard_corpus`` cuts the corpus into one shard's documents, with the
shard's own statistics (chip_smoke's 5-shard "bench5").

``unit_vectors`` and ``knn_query_vectors`` make the dense_vector data of
the kNN configurations (the reference bench's recipe): seeded unit
vectors, generated in row chunks on a torch device, and queries that are
a random doc plus 0.25 of Gaussian noise, normalized.
"""

from __future__ import annotations

from typing import Any, Dict, List

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
    ``doc_ids``/``tf`` grouped by term with ``group_start``, and
    ``stream``: int32 [sum of lens], every doc's term ids in position
    order, doc after doc (``corpus_streams`` lays it out as token
    streams)."""
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
    stream = terms.astype(np.int32)
    keys = terms * n_docs + doc_of
    del terms, doc_of
    uniq, tf = np.unique(keys, return_counts=True)
    del keys
    term_of = (uniq // n_docs).astype(np.int32)
    doc_ids = (uniq % n_docs).astype(np.int32)
    del uniq
    tf = tf.astype(np.float32)
    corpus = _block_layout(term_of, doc_ids, tf, vocab)
    corpus.update(lens=lens.astype(np.float32), stream=stream)
    return corpus


def _block_layout(term_of: np.ndarray, doc_ids: np.ndarray, tf: np.ndarray,
                  vocab: int) -> Dict[str, np.ndarray]:
    """Postings grouped by term (docids ascending within a term) in the
    corpus's block layout."""
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
                tbs=tbs, nb=nb, df=df, doc_ids=doc_ids, tf=tf,
                group_start=group_start)


def shard_corpus(corpus: Dict[str, np.ndarray],
                 docs: np.ndarray) -> Dict[str, np.ndarray]:
    """The corpus of the docs ``docs`` alone (ascending docids of
    ``corpus``), renumbered 0.. in their order, in the same layout
    (without ``stream``): one shard's documents, with the shard's own
    statistics. Its ``ids`` are the docs' ids in ``corpus`` as text."""
    docs = np.asarray(docs, np.int64)
    new_of = np.full(len(corpus["lens"]), -1, np.int64)
    new_of[docs] = np.arange(len(docs))
    vocab = len(corpus["df"])
    term_of = np.repeat(np.arange(vocab, dtype=np.int32), corpus["df"])
    keep = new_of[corpus["doc_ids"]] >= 0
    sub = _block_layout(term_of[keep],
                        new_of[corpus["doc_ids"][keep]].astype(np.int32),
                        corpus["tf"][keep], vocab)
    sub.update(lens=corpus["lens"][docs], ids=[str(d) for d in docs])
    return sub


def corpus_streams(corpus: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The corpus's token streams (``build_corpus``'s ``stream``), as
    ``segment_from_numpy``'s ``streams`` entry: ``tokens`` int32
    [n_docs, longest doc] (-1 pad) and ``lengths`` int32 [n_docs].
    Filled in row chunks, so no temporary grows with the corpus."""
    lens = corpus["lens"].astype(np.int64)
    n = len(lens)
    width = int(lens.max()) if n else 0
    tokens = np.full((n, width), -1, np.int32)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    stream = corpus["stream"]
    chunk = 1 << 16
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        ln = lens[lo:hi]
        rows = np.repeat(np.arange(lo, hi), ln)
        cols = np.arange(int(ln.sum())) - np.repeat(starts[lo:hi]
                                                    - starts[lo], ln)
        tokens[rows, cols] = stream[starts[lo]:starts[hi]]
    return {"tokens": tokens, "lengths": lens.astype(np.int32)}


def stream_sources(streams: Dict[str, np.ndarray], field: str = "title",
                   chunk: int = 1 << 16) -> List[bytes]:
    """Each doc's ``_source``, ``{"<field>": "<its terms, spaced>"}``,
    from ``corpus_streams``' rows (no holes), built a chunk of rows at a
    time from a table of the term names."""
    tokens, lengths = streams["tokens"], streams["lengths"].astype(np.int64)
    vocab = int(tokens.max()) + 1 if tokens.size else 0
    width = len(term_name(max(vocab - 1, 0))) + 1
    names = np.frombuffer("".join(term_name(t) + " " for t in range(vocab))
                          .encode(), np.uint8).reshape(vocab, width)
    pre, suf = f'{{"{field}":"'.encode(), b'"}'
    out: List[bytes] = []
    for lo in range(0, len(lengths), chunk):
        rows, ln = tokens[lo:lo + chunk], lengths[lo:lo + chunk]
        flat = names[rows[rows >= 0]].tobytes()
        ends = np.cumsum(ln * width)
        starts = ends - ln * width
        out.extend(pre + flat[a:max(a, b - 1)] + suf
                   for a, b in zip(starts.tolist(), ends.tolist()))
    return out


def rank_feature_columns(n_docs: int, rng: np.random.Generator,
                         field: str = "ml.tokens", n_keys: int = 256,
                         per_doc: int = 24, zipf: float = ZIPF,
                         chunk: int = 1 << 16):
    """A seeded ``rank_features`` field as ``segment_from_numpy``'s
    ``numerics``: ``n_keys`` keys ``{field}.k000`` ..., each doc holding
    ``per_doc`` distinct keys drawn by Zipf(``zipf``) weight (without
    replacement: the first ``per_doc`` finishers of an exponential race,
    each key's time Exp(1) over its weight, which is the Gumbel top-k
    of the log weights) with a weight in (0, 4]; a key a doc lacks is
    missing (NaN). Learned-sparse expansions (ELSER) give each document
    a few dozen weighted tokens."""
    inv_w = (np.arange(1, n_keys + 1, dtype=np.float64) ** zipf).astype(
        np.float32)
    values = np.full((n_keys, n_docs), np.nan, np.float64)
    for lo in range(0, n_docs, chunk):
        hi = min(n_docs, lo + chunk)
        race = rng.standard_exponential((hi - lo, n_keys), np.float32)
        race *= inv_w
        keys = np.argpartition(race, per_doc - 1, axis=1)[:, :per_doc]
        w = 4.0 * (1.0 - rng.random((hi - lo, per_doc)))   # (0, 4]
        rows = np.repeat(np.arange(lo, hi), per_doc)
        values[keys.reshape(-1), rows] = w.reshape(-1)
    return {f"{field}.k{k:03d}": {"values": values[k]}
            for k in range(n_keys)}


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


def bench_cat(n: int, seed: int = 99, n_cats: int = 500):
    """The reference bench's skewed ``cat`` keyword column (its
    match+terms-agg row's field), drawn as it draws it: the first draw
    of ``n`` uniforms of ``default_rng(seed)``, squared and scaled, so
    low ords are the most frequent. (int32 ords [n], the terms
    ``c000`` ... in ord order), ``segment_from_numpy``'s ``keywords``
    entry's ``ords`` and ``terms``."""
    rng = np.random.default_rng(seed)
    ords = np.minimum(rng.random(n) ** 2 * n_cats,
                      n_cats - 1).astype(np.int32)
    return ords, [f"c{i:03d}" for i in range(n_cats)]


def bench_feat(n: int, seed: int = 99) -> np.ndarray:
    """float64 [n]: the reference bench's ``feat`` doc values (its
    script_score row's column), drawn as it draws them: the second draw
    of ``n`` uniforms of ``default_rng(seed)``, whose first makes the
    ``cat`` column (``bench_cat``), uniform in [0, 1)."""
    rng = np.random.default_rng(seed)
    rng.random(n)
    return rng.random(n)


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


def keyword_postings(ords: np.ndarray, terms: List[str]) -> Dict[str, Any]:
    """The postings of a single-valued keyword column (int32 ``ords``
    [n_docs], -1 where a doc has none; the sorted ``terms``), as the
    SegmentWriter builds a keyword field's: tf 1, field length 1 where a
    doc has a value; ``segment_from_numpy``'s ``fields`` entry. The term
    and filter queries on the field (and the plan path's filter
    conversion) read them."""
    n_terms = len(terms)
    docs = np.nonzero(ords >= 0)[0]
    o = ords[docs]
    order = np.argsort(o, kind="stable")
    docs, o = docs[order], o[order].astype(np.int64)
    df = np.bincount(o, minlength=n_terms).astype(np.int64)
    nb = -(-df // 128)
    tbs = np.concatenate([[0], np.cumsum(nb)])
    block_docids = np.zeros((int(tbs[-1]), 128), np.int32)
    block_tfs = np.zeros((int(tbs[-1]), 128), np.float32)
    j = np.arange(len(docs)) - np.repeat(np.cumsum(df) - df, df)
    block_docids[tbs[o] + j // 128, j % 128] = docs
    block_tfs[tbs[o] + j // 128, j % 128] = 1.0
    return dict(terms=list(terms), doc_freq=df, term_block_start=tbs[:-1],
                term_block_count=nb, block_docids=block_docids,
                block_tfs=block_tfs,
                field_lengths=(ords >= 0).astype(np.float32))


def segment_from_corpus(corpus: Dict[str, np.ndarray], field: str = "title",
                        name: str = "corpus0", numerics=None,
                        vectors=None, keywords=None,
                        streams=None, sources=None,
                        fields=None, ids=None) -> Segment:
    """The corpus as one port Segment over a text field of the terms
    ``t000000 ...`` (ids are the docids as text; no ``_source``), with
    the numeric columns ``numerics`` (``logs_columns``), the vector
    fields ``vectors``, the keyword columns ``keywords`` and the text
    field's token streams ``streams`` (``corpus_streams``), the docs'
    ``sources`` (``stream_sources``), more postings ``fields``
    (``keyword_postings``) and the docs' ``ids`` (a shard's,
    ``shard_corpus``) (``segment_from_numpy``'s forms) when given; the
    block-max metadata is computed from the blocks
    (index/segment.py ``block_max_meta``)."""
    vocab = len(corpus["df"])
    postings = dict(
        terms=[term_name(i) for i in range(vocab)],
        doc_freq=corpus["df"], term_block_start=corpus["tbs"][:-1],
        term_block_count=corpus["nb"],
        block_docids=corpus["block_docids"], block_tfs=corpus["block_tfs"],
        field_lengths=corpus["lens"])
    return segment_from_numpy({"fields": {field: postings, **(fields or {})},
                               "numerics": numerics, "vectors": vectors,
                               "keywords": keywords,
                               "streams": streams and {field: streams},
                               "sources": sources,
                               "ids": ids}, name=name)


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
    return topk_of_scores(scores, k)


def topk_of_scores(scores: np.ndarray, k: int):
    """(docids of the top k of the docs scoring above 0 by (score desc,
    docid asc), their scores, the count of docs above 0)."""
    matched = np.nonzero(scores > 0)[0]
    total = len(matched)
    key = scores[matched]
    if total > k:       # only the docs at or above the kth value
        at = total - k
        kth = np.partition(key, at)[at]
        matched, key = matched[key >= kth], key[key >= kth]
    order = matched[np.lexsort((matched, -key))][:k]
    return order, scores[order], total


# ---------------------------------------------------------------------------
# the field-type deployments (chip_smoke phase 12)
# ---------------------------------------------------------------------------

# Rally's geopoint track: the geonames points of allCountries.txt
GEOPOINT_DOCS = 60_844_404
GEO_CITIES = 4000


def geo_points(n: int, rng: np.random.Generator,
               n_cities: int = GEO_CITIES):
    """float64 (lat, lon, city) [n]: points clustered like populated
    places. City centres spread over the inhabited latitudes, city sizes
    Zipf(1.1); each point lies Gaussian around its city with a spread
    from 0.02 degrees (a small town) to 0.5 (the largest city), and 5 %
    anywhere (a rural tail, city -1)."""
    c_lat = np.degrees(np.arcsin(rng.uniform(-0.8, 0.95, n_cities)))
    c_lon = rng.uniform(-180.0, 180.0, n_cities)
    w = 1.0 / np.arange(1, n_cities + 1) ** 1.1
    w /= w.sum()
    spread_of = 0.02 + 0.48 * np.sqrt(w / w[0])
    city = np.searchsorted(np.cumsum(w), rng.random(n) * (1 - 1e-12))
    spread = spread_of[city]
    lat = c_lat[city] + rng.standard_normal(n) * spread
    lon = c_lon[city] + rng.standard_normal(n) * spread
    del spread
    rural = rng.random(n) < 0.05
    k = int(rural.sum())
    lat[rural] = np.degrees(np.arcsin(rng.uniform(-0.8, 0.95, k)))
    lon[rural] = rng.uniform(-180.0, 180.0, k)
    city[rural] = -1
    np.clip(lat, -89.9, 89.9, out=lat)
    lon = (lon + 180.0) % 360.0 - 180.0
    return lat, lon, city


def geo_columns(field: str, lat: np.ndarray, lon: np.ndarray):
    """A geo_point field's two columns, ``segment_from_numpy``'s
    ``numerics`` entries (``{field}.lat``, ``{field}.lon``)."""
    return {f"{field}.lat": {"values": lat}, f"{field}.lon": {"values": lon}}


def envelope_columns(field: str, lat: np.ndarray, lon: np.ndarray,
                     half: np.ndarray):
    """A geo_shape field of envelopes ``half`` degrees around each point:
    its four bounding-box columns (``{field}.min_lat`` ... ``.max_lon``)
    as the mapper derives them."""
    return {f"{field}.min_lat": {"values": lat - half},
            f"{field}.min_lon": {"values": lon - half},
            f"{field}.max_lat": {"values": lat + half},
            f"{field}.max_lon": {"values": lon + half}}


COUNTRY_CODES = [a + b for a in "ABCDEFGHIKLMNPRSTUVZ"
                 for b in "ABCDEFGHILMNORSTUZ"][:250]


def ip_column(n: int, rng: np.random.Generator, n_nets: int = 5000):
    """float64 [n] client addresses as ``ip`` numbers (``int(ip)``),
    drawn Zipf(1.07) over ``n_nets`` /16 networks as http_logs' clients
    cluster, each host uniform within its network; and the networks
    (int64 [n_nets], each the /16 prefix as a number)."""
    first = rng.integers(1, 224, n_nets)
    first = np.where(first == 127, 128, first)
    nets = first * 256 + rng.integers(0, 256, n_nets)
    w = 1.0 / np.arange(1, n_nets + 1) ** ZIPF
    pick = np.searchsorted(np.cumsum(w / w.sum()), rng.random(n)
                           * (1 - 1e-12))
    ip = (nets[pick] << 16) + rng.integers(0, 1 << 16, n)
    return ip.astype(np.float64), nets.astype(np.int64)


def postings_from_pairs(doc_of: np.ndarray, term_of: np.ndarray,
                        n_docs: int, terms: List[str],
                        keyword: bool = False) -> Dict[str, Any]:
    """A field's postings from its (doc, term id) occurrences, as the
    SegmentWriter builds them: a text field's tf is the count and its
    length the number of tokens; a keyword field's tf is 1 per distinct
    value and its length the number of values.
    ``segment_from_numpy``'s ``fields`` entry."""
    doc_of = np.asarray(doc_of, np.int64)
    term_of = np.asarray(term_of, np.int64)
    uniq, tf = np.unique(term_of * n_docs + doc_of, return_counts=True)
    t, d = uniq // n_docs, uniq % n_docs
    if keyword:
        tf = np.ones_like(tf)
    df = np.bincount(t, minlength=len(terms)).astype(np.int64)
    nb = -(-df // BLOCK_SIZE)
    tbs = np.concatenate([[0], np.cumsum(nb)])
    block_docids = np.zeros((int(tbs[-1]), BLOCK_SIZE), np.int32)
    block_tfs = np.zeros((int(tbs[-1]), BLOCK_SIZE), np.float32)
    j = np.arange(len(d)) - np.repeat(np.cumsum(df) - df, df)
    block_docids[tbs[t] + j // BLOCK_SIZE, j % BLOCK_SIZE] = d
    block_tfs[tbs[t] + j // BLOCK_SIZE, j % BLOCK_SIZE] = tf
    return dict(terms=list(terms), doc_freq=df, term_block_start=tbs[:-1],
                term_block_count=nb, block_docids=block_docids,
                block_tfs=block_tfs,
                field_lengths=np.bincount(doc_of, minlength=n_docs)
                .astype(np.float32))


def multi_numeric(doc_of: np.ndarray, values: np.ndarray,
                  n_docs: int) -> Dict[str, Any]:
    """A multi-valued numeric column from (doc, value) pairs in document
    order, as the SegmentWriter builds it: each doc's first value, its
    values sorted; ``segment_from_numpy``'s ``numerics`` entry."""
    doc_of = np.asarray(doc_of, np.int64)
    counts = np.bincount(doc_of, minlength=n_docs)
    offsets = np.zeros(n_docs + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    first = np.full(n_docs, np.nan)
    has = counts > 0
    first[has] = values[offsets[:-1][has]]
    order = np.lexsort((values, doc_of))
    return {"values": first, "offsets": offsets,
            "all_values": np.asarray(values, np.float64)[order]}


def multi_keyword(doc_of: np.ndarray, term_of: np.ndarray, n_docs: int,
                  terms: List[str]) -> Dict[str, Any]:
    """A multi-valued keyword column from (doc, term id) pairs over the
    sorted ``terms``: each doc's distinct ords ascending, its first ord
    the smallest; ``segment_from_numpy``'s ``keywords`` entry."""
    uniq = np.unique(np.asarray(doc_of, np.int64) * len(terms)
                     + np.asarray(term_of, np.int64))
    d, t = uniq // len(terms), (uniq % len(terms)).astype(np.int32)
    counts = np.bincount(d, minlength=n_docs)
    offsets = np.zeros(n_docs + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    ords = np.full(n_docs, -1, np.int32)
    has = counts > 0
    ords[has] = t[offsets[:-1][has]]
    return {"terms": list(terms), "ords": ords, "offsets": offsets,
            "all_ords": t}


QA_USERS = 5000
QA_WORDS = 2000
QA_T0_MS = 1_577_836_800_000     # 2020-01-01T00:00:00Z


def qa_answers(n_questions: int, rng: np.random.Generator):
    """Rally's nested track shape (StackOverflow questions with their
    answers): 0-5 answers a question, each with a ``user`` drawn
    Zipf(1.07) over ``QA_USERS``, a ``date`` (epoch ms over four years),
    a ``score`` in [-5, 50) and a ``text`` of 2-6 words drawn Zipf over
    ``QA_WORDS``. Arrays over the answers in question order:
    ``doc`` int64, ``user`` int64, ``date`` float64, ``score`` int64,
    ``text`` int32 [A, 6] (-1 pad), ``text_len`` int64; ``n_ans`` [n]."""
    n_ans = rng.integers(0, 6, n_questions)
    doc = np.repeat(np.arange(n_questions), n_ans)
    a = len(doc)
    wu = 1.0 / np.arange(1, QA_USERS + 1) ** ZIPF
    user = np.searchsorted(np.cumsum(wu / wu.sum()),
                           rng.random(a) * (1 - 1e-12))
    date = (QA_T0_MS + rng.integers(0, 4 * 365 * DAY_MS, a)).astype(
        np.float64)
    score = rng.integers(-5, 50, a)
    ww = 1.0 / np.arange(1, QA_WORDS + 1) ** ZIPF
    text_len = rng.integers(2, 7, a)
    text = np.searchsorted(np.cumsum(ww / ww.sum()),
                           rng.random((a, 6)) * (1 - 1e-12)).astype(np.int32)
    text[np.arange(6)[None, :] >= text_len[:, None]] = -1
    return dict(doc=doc, user=user, date=date, score=score, text=text,
                text_len=text_len, n_ans=n_ans)


def qa_user(u: int) -> str:
    return f"user{u:05d}"


def qa_word(w: int) -> str:
    return f"w{w:04d}"


def qa_answer_objects(ans) -> List[Dict[str, Any]]:
    """Each answer as its ``_source`` object."""
    out = []
    for u, dt, s, row, ln in zip(ans["user"], ans["date"], ans["score"],
                                 ans["text"], ans["text_len"]):
        out.append({"user": qa_user(int(u)), "date": int(dt),
                    "score": int(s),
                    "text": " ".join(qa_word(int(w)) for w in row[:ln])})
    return out


# English-like text for the analysis slice: inflected forms of a stem
# list (run, runs, running, runner, ...), the English stop words at about
# their natural share of running text, and a few of each kind of word an
# analysis chain treats apart: HTML markup, accented forms, hyphenated
# and camel-case words. Every filter of ANALYSIS_SETTINGS changes some
# token of it.
EN_STEMS = (
    "run walk jump talk play work read write build cook clean open close "
    "start stop move turn help call look watch listen learn teach drive "
    "ride swim climb paint draw sing dance travel visit plan test check "
    "fix print load save send share store search sort count measure "
    "connect report market manage process produce design develop deploy "
    "control monitor balance charge change create deliver explore follow "
    "gather govern hunt index judge keep launch limit mark mount need "
    "order pack pass post press pull push rain rest roll rush seal shift "
    "sign sink skip smell spark stack stand step stock stream strike "
    "surf switch tag track trade train treat trust value view vote wash "
    "wave wish yield zoom act add aim air ask back bank base bear beat "
    "bend bill bind blow board boat bond book boot bound bowl brand break "
    "bridge brush burn camp care carry cast catch cause cover crash cross "
    "crowd cycle damage deal debate defend demand depend doubt dream dress "
    "drill drop dump earn edit end enter escape expect export fail fall "
    "fear feed fill film find fire fish flash float flow fold force form "
    "frame fund garden glow grab grant grip ground grow guard guess guide "
    "hand handle harm head heat hold hope host house hurt import increase "
    "interest iron join kick kill kiss land last laugh lead lean lift "
    "light link list live lock log love mail match mean meet mind mix "
    "name nation note offer operate own park part pay pick place point "
    "pour power price print profit protect prove quote race rate reach "
    "record reduce relate remain rent repair repeat reply rescue respect "
    "return review ring rock root rule sail scale score screen season "
    "seat sense serve settle shape shine shock shop show sight sleep slide "
    "smile smoke snow sound space spell spend spin spot spread spring "
    "state station stay steer stick storm strain stress string study "
    "style suit supply support surface survey swing table taste tax "
    "tear tend term thank thread throw tie time tip title touch tour "
    "trace train trap travel trick trip trouble turn type unit use vary "
    "visit voice wait wake want warm warn waste water wear weigh whistle "
    "wind wire wonder word wrap").split()
EN_SUFFIXES = ("", "s", "ed", "ing", "er", "ers", "ly", "ness", "ful",
               "ation", "ations", "ational", "ive", "ize", "izes", "ized",
               "ment", "ments", "able", "ity")
EN_STOP = ("a", "an", "and", "are", "as", "at", "be", "but", "by", "for",
           "if", "in", "into", "is", "it", "no", "not", "of", "on", "or",
           "such", "that", "the", "their", "then", "there", "these",
           "they", "this", "to", "was", "will", "with")
EN_ACCENTED = ("café", "naïve", "crème", "brûlée", "résumé", "façade",
               "über", "jalapeño", "déjà", "coöperate", "fiancée",
               "piñata", "garçon", "señor", "smörgåsbord", "Zürich",
               "Ångström", "élan", "rôle", "soufflé")
EN_HYPHENATED = ("state-of-the-art", "well-known", "long-term",
                 "high-quality", "real-time", "open-source", "up-to-date",
                 "end-to-end", "follow-up", "run-time", "e-mail",
                 "check-in", "log-in", "start-up", "sign-off")
EN_CAMEL = ("PowerShot", "iPhone", "XMLHttp", "WiFi500", "DataStream",
            "PowerPoint", "JavaScript", "YouTube", "MacBook", "PlayStation",
            "eBay", "SmartPhone", "OpenSearch", "HttpClient", "GPUs2024")
EN_MARKUP = ("<b>{}</b>", "<i>{}</i>", "<em>{}</em>", "<p>{}</p>",
             "{} &amp;", "&lt;{}&gt;")
EN_STOP_SHARE = 0.30
EN_SPECIAL_SHARE = 0.02      # each of accented, hyphenated, camel, markup


def english_forms() -> List[str]:
    """The inflected word forms: every stem with every suffix (a doubled
    final e dropped), in a fixed order."""
    out = []
    seen = set()
    for stem in EN_STEMS:
        for suf in EN_SUFFIXES:
            w = (stem[:-1] if stem.endswith("e") and suf[:1] in "aeiy"
                 and suf else stem) + suf
            if w not in seen:
                seen.add(w)
                out.append(w)
    return out


def english_text(rng: np.random.Generator, n_words: np.ndarray,
                 forms: List[str]) -> List[str]:
    """One text of ``n_words[i]`` words for each i: Zipf-drawn forms, stop
    words at EN_STOP_SHARE, and each special kind at EN_SPECIAL_SHARE;
    the first word of a text capitalized and a period at its end."""
    total = int(n_words.sum())
    ranks = rng.zipf(1.1, total) - 1
    words = np.asarray(forms, dtype=object)[ranks % len(forms)]
    kind = rng.random(total)
    stop = kind < EN_STOP_SHARE
    words[stop] = np.asarray(EN_STOP, dtype=object)[
        rng.integers(0, len(EN_STOP), int(stop.sum()))]
    lo = EN_STOP_SHARE
    for pool in (EN_ACCENTED, EN_HYPHENATED, EN_CAMEL):
        sel = (kind >= lo) & (kind < lo + EN_SPECIAL_SHARE)
        words[sel] = np.asarray(pool, dtype=object)[
            rng.integers(0, len(pool), int(sel.sum()))]
        lo += EN_SPECIAL_SHARE
    sel = np.nonzero((kind >= lo) & (kind < lo + EN_SPECIAL_SHARE))[0]
    fmt = rng.integers(0, len(EN_MARKUP), len(sel))
    for i, f in zip(sel.tolist(), fmt.tolist()):
        words[i] = EN_MARKUP[f].format(words[i])
    out = []
    pos = 0
    for n in n_words.tolist():
        ws = words[pos:pos + n].tolist()
        pos += n
        if ws:
            ws[0] = ws[0][:1].upper() + ws[0][1:]
        out.append(" ".join(ws) + ".")
    return out


def english_docs(n_docs: int, rng: np.random.Generator,
                 body_words: int = 24) -> List[Dict[str, str]]:
    """``n_docs`` documents of ``title`` (3-8 words), ``body`` (lognormal
    around ``body_words``, clipped to [4, 96]) and ``tags`` (1-4 forms
    and camel-case words, space-separated)."""
    forms = english_forms()
    titles = english_text(rng, rng.integers(3, 9, n_docs), forms)
    lens = np.clip(np.round(rng.lognormal(np.log(body_words), 0.5, n_docs)),
                   4, 96).astype(np.int64)
    bodies = english_text(rng, lens, forms)
    tag_pool = np.asarray(forms[:200] + list(EN_CAMEL), dtype=object)
    n_tags = rng.integers(1, 5, n_docs)
    tag_words = tag_pool[rng.integers(0, len(tag_pool), int(n_tags.sum()))]
    ends = np.cumsum(n_tags)
    tags = [" ".join(tag_words[e - n:e].tolist())
            for e, n in zip(ends.tolist(), n_tags.tolist())]
    return [{"title": t, "body": b, "tags": g}
            for t, b, g in zip(titles, bodies, tags)]


# the analyzed index of the analysis slice: `title` standard, `body`
# english with a synonym search analyzer, `body.exact` a custom chain of
# every kind of component, `tags` whitespace
ANALYSIS_SYNONYMS = ["run, jog", "quick, fast, rapid", "build, construct",
                     "big, large", "search => find"]
ANALYSIS_STOPWORDS = ["the", "a", "an", "of", "to", "in", "and", "is"]
ANALYSIS_SETTINGS = {"index": {"analysis": {
    "char_filter": {"amp": {"type": "mapping",
                            "mappings": ["& => and", "ä => ae"]}},
    "filter": {"en_syn": {"type": "synonym", "synonyms": ANALYSIS_SYNONYMS},
               "few_stop": {"type": "stop",
                            "stopwords": ANALYSIS_STOPWORDS}},
    "analyzer": {
        "english_syn": {"type": "custom", "tokenizer": "standard",
                        "filter": ["lowercase", "stop", "en_syn",
                                   "porter_stem"]},
        "exact": {"type": "custom", "char_filter": ["html_strip", "amp"],
                  "tokenizer": "pattern",
                  "filter": ["lowercase", "asciifolding", "few_stop",
                             "word_delimiter_graph", "porter_stem"]}}}}}
ANALYSIS_MAPPINGS = {"properties": {
    "title": {"type": "text"},
    "body": {"type": "text", "analyzer": "english",
             "search_analyzer": "english_syn",
             "fields": {"exact": {"type": "text", "analyzer": "exact"}}},
    "tags": {"type": "text", "analyzer": "whitespace"}}}
