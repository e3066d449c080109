"""Immutable segments (counterpart of elasticsearch_tpu/index/segment.py),
reduced to what the `_search` slices read: text and keyword postings,
doc lengths, numeric doc values, dense vectors, ids, `_source` and the
live mask.

- **Postings as padded blocks.** Each text field's postings are
  concatenated into blocks of ``BLOCK_SIZE`` (128): ``block_docids
  [num_blocks, 128] int32`` and ``block_tfs [num_blocks, 128] float32``.
  Padding carries ``tf = 0`` and ``docid = 0`` and scores exactly 0. A
  term's blocks are ``term_block_start/term_block_count``; a term's last
  block is padded rather than shared, so block gathers never mix terms.
- **Block-max metadata**: ``block_max_tf [num_blocks]`` (the largest
  tf of each block) and ``block_min_len [num_blocks]`` (the smallest
  field length over each block's real postings, 0 for a block with
  none) bound every contribution a block can make; the impact-ordered
  selection, the θ-warm essential lanes and the plan path's window
  pruning read them.
- **Keyword postings** have tf = 1 per distinct value and a field length
  equal to the number of values, as the reference builds them.
- **Numeric doc values** (numbers, booleans, dates as epoch millis):
  ``values`` float64 [n_docs] (a doc's first value, NaN where missing),
  ``missing`` bool [n_docs], and the ragged multi-values
  ``offsets``/``all_values`` (each doc's values sorted).
- **Keyword doc values** (sorted-set ordinals, Lucene's
  SortedSetDocValues): ``terms`` (the sorted distinct values), ``ords``
  int32 [n_docs] (a doc's first ord, -1 where missing) and the ragged
  ``offsets``/``all_ords`` (each doc's distinct ords ascending), for
  every keyword field and dynamic ``.keyword`` subfield; the terms
  aggregation reads them.
- **Dense vectors**: ``vectors`` float32 [n_docs, dims] (zero rows where
  a doc has none), ``has_value`` bool [n_docs], the field's ``dims`` and
  ``similarity``. This float32 host copy is what the kNN path's exact
  re-rank reads; the device holds the slab (ops/device.py).
- **Token streams** (``TokenStreams``, text fields only): each doc's
  term ids by position, ``tokens [n_docs, max_len] int32`` (-1 pad and
  holes, at most ``MAX_STREAM_LEN`` positions) and ``lengths [n_docs]``;
  the positional queries verify their candidates on them. They stay on
  the host: nothing uploads them and no breaker charges them.
- **Completions** (``CompletionValues``, ``completion`` fields): the
  suggestion inputs sorted, with their weights, docs and category
  contexts, and a max-weight segment tree over them: the completion
  suggester's weighted prefix index. Host only.
- **Deletes as masks**: ``live[n_docs] bool``, replaced (never mutated)
  on delete, with ``live_version`` bumped so device caches can key on it.

Docids are segment-local dense int32.
"""

from __future__ import annotations

import bisect
import heapq
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

BLOCK_SIZE = 128


@dataclass
class PostingsField:
    """Inverted index for one field, in padded-block layout."""

    field: str
    terms: List[str]                      # sorted
    doc_freq: np.ndarray                  # int32 [num_terms]
    total_term_freq: np.ndarray           # int64 [num_terms]
    term_block_start: np.ndarray          # int32 [num_terms]
    term_block_count: np.ndarray          # int32 [num_terms]
    block_docids: np.ndarray              # int32 [num_blocks, BLOCK_SIZE]
    block_tfs: np.ndarray                 # float32 [num_blocks, BLOCK_SIZE]
    block_max_tf: np.ndarray              # float32 [num_blocks]
    block_min_len: np.ndarray             # float32 [num_blocks]
    field_lengths: np.ndarray             # float32 [n_docs] (0 where absent)
    sum_total_term_freq: int
    sum_doc_freq: int
    doc_count: int                        # docs with this field

    _term_index: Optional[Dict[str, int]] = dc_field(default=None, repr=False)

    @property
    def term_index(self) -> Dict[str, int]:
        if self._term_index is None:
            self._term_index = {t: i for i, t in enumerate(self.terms)}
        return self._term_index

    def term_id(self, term: str) -> int:
        return self.term_index.get(term, -1)

    @property
    def num_blocks(self) -> int:
        return self.block_docids.shape[0]

    @property
    def avg_field_length(self) -> float:
        return self.sum_total_term_freq / max(1, self.doc_count)


@dataclass
class TokenStreams:
    """Per-doc positional token-id streams of one text field:
    ``tokens[n_docs, max_len]`` int32 term ids (into the field's
    ``PostingsField.terms``), -1 padded, each token at its position
    (a position gap stays a -1 hole). A stream longer than
    ``MAX_STREAM_LEN`` is cut there (the positions only: postings and
    norms see the whole stream). Positional queries check candidates
    with shifted equality over these rows (search/phrase.py,
    search/intervals.py)."""

    field: str
    tokens: np.ndarray    # int32 [n_docs, max_len], -1 pad
    lengths: np.ndarray   # int32 [n_docs] indexed (maybe cut) length


MAX_STREAM_LEN = 512


@dataclass
class NumericDocValues:
    field: str
    values: np.ndarray      # float64 [n_docs] (first value if multi)
    missing: np.ndarray     # bool [n_docs]
    # ragged multi-values
    offsets: np.ndarray     # int64 [n_docs + 1]
    all_values: np.ndarray  # float64 [total]

    def get(self, docid: int) -> List[float]:
        return [float(v) for v in
                self.all_values[self.offsets[docid]: self.offsets[docid + 1]]]


@dataclass
class KeywordDocValues:
    """Sorted-set ordinals (analogue of Lucene SortedSetDocValues)."""

    field: str
    terms: List[str]        # sorted unique terms
    ords: np.ndarray        # int32 [n_docs] first ord, -1 = missing
    offsets: np.ndarray     # int64 [n_docs + 1] into all_ords
    all_ords: np.ndarray    # int32 [total]

    def get(self, docid: int) -> List[str]:
        return [self.terms[o] for o in
                self.all_ords[self.offsets[docid]: self.offsets[docid + 1]]]


@dataclass
class VectorValues:
    field: str
    vectors: np.ndarray     # float32 [n_docs, dims]
    has_value: np.ndarray   # bool [n_docs]
    dims: int
    similarity: str = "cosine"
    # (live version, count) of the last live_count
    _live_count: Optional[Tuple[int, int]] = dc_field(
        default=None, repr=False, compare=False)

    def live_count(self, live: np.ndarray, version: int) -> int:
        """Docs with a vector among the ``live`` ones, counted once per
        live ``version`` (a full pass over n_docs otherwise)."""
        cached = self._live_count
        if cached is None or cached[0] != version:
            cached = (version, int(np.count_nonzero(
                self.has_value & live[: len(self.has_value)])))
            self._live_count = cached
        return cached[1]


@dataclass
class StoredFields:
    offsets: np.ndarray     # int64 [n_docs + 1]
    data: bytes
    ids: List[str]

    def source(self, docid: int) -> bytes:
        return self.data[self.offsets[docid]: self.offsets[docid + 1]]


class CompletionValues:
    """Weighted prefix index of a ``completion`` field (the reference's
    FST replacement): the inputs SORTED (a prefix is one bisect range)
    and an implicit segment tree of the max weight over that order, so
    the top k of a prefix pop in O(log n) each by splitting ranges at
    their argmax."""

    def __init__(self, field: str, inputs: List[str],
                 weights: np.ndarray, doc_of: np.ndarray,
                 contexts: Optional[List[frozenset]] = None):
        order = sorted(range(len(inputs)), key=lambda i: inputs[i])
        self.field = field
        self.inputs = [inputs[i] for i in order]
        self.weights = np.asarray(weights, np.float64)[order]
        self.doc_of = np.asarray(doc_of, np.int32)[order]
        self.contexts = ([contexts[i] for i in order]
                         if contexts is not None else None)
        n = len(self.inputs)
        # tree[1] is the root's max; leaves at [size, size + n)
        self._size = 1
        while self._size < max(1, n):
            self._size *= 2
        tree = np.full(2 * self._size, -np.inf, np.float64)
        if n:
            tree[self._size:self._size + n] = self.weights
        for i in range(self._size - 1, 0, -1):
            tree[i] = max(tree[2 * i], tree[2 * i + 1])
        self._tree = tree

    def __len__(self):
        return len(self.inputs)

    def _range_argmax(self, lo: int, hi: int) -> int:
        """Index of the max weight in [lo, hi): a tree descent."""
        best_v, best_i = -np.inf, -1
        nodes: List[tuple] = [(1, 0, self._size)]
        while nodes:
            node, nlo, nhi = nodes.pop()
            if nhi <= lo or hi <= nlo or self._tree[node] <= best_v:
                continue
            if nhi - nlo == 1:
                best_v, best_i = self._tree[node], nlo
                continue
            mid = (nlo + nhi) // 2
            # the larger child last, so it pops first and prunes more
            kids = [(2 * node, nlo, mid), (2 * node + 1, mid, nhi)]
            kids.sort(key=lambda kd: self._tree[kd[0]])
            nodes.extend(kids)
        return best_i

    def top_k(self, prefix: str, k: int,
              context_filter: Optional[frozenset] = None,
              live: Optional[np.ndarray] = None) -> List[int]:
        """Indices of the k heaviest entries under ``prefix`` (weight
        desc, input asc), of live docs and, with ``context_filter``,
        carrying every context in it. A heap of ranges split at their
        argmax; past a budget of skipped entries, an exact linear pass
        over the prefix range."""
        lo = bisect.bisect_left(self.inputs, prefix)
        hi = bisect.bisect_left(self.inputs, prefix + "\U0010FFFF\U0010FFFF")
        if lo >= hi:
            return []

        def ok(i):
            if live is not None and not live[self.doc_of[i]]:
                return False
            if context_filter:
                ctx = self.contexts[i] if self.contexts else frozenset()
                return context_filter <= ctx
            return True

        out: List[int] = []
        first = self._range_argmax(lo, hi)
        heap = [(-self.weights[first], self.inputs[first], first, lo, hi)]
        budget = max(10 * k, 4096)
        while heap and len(out) < k and budget > 0:
            _negw, _text, i, rlo, rhi = heapq.heappop(heap)
            if ok(i):
                out.append(i)
            else:
                budget -= 1
            for slo, shi in ((rlo, i), (i + 1, rhi)):
                if slo < shi:
                    j = self._range_argmax(slo, shi)
                    if j >= 0:
                        heapq.heappush(heap, (-self.weights[j],
                                              self.inputs[j], j, slo, shi))
        if budget <= 0 and len(out) < k:
            cand = [i for i in range(lo, hi) if ok(i)]
            cand.sort(key=lambda i: (-self.weights[i], self.inputs[i]))
            out = cand[:k]
        return out


def _completions_of(field: str, entries) -> CompletionValues:
    """``field``'s CompletionValues from its (input, weight, docid,
    contexts) entries; no contexts are kept when no entry has one."""
    ctxs = [cx for _i, _w, _d, cx in entries]
    return CompletionValues(
        field, [i for i, _w, _d, _c in entries],
        np.asarray([w for _i, w, _d, _c in entries], np.float64),
        np.asarray([d for _i, _w, d, _c in entries], np.int64),
        ctxs if any(ctxs) else None)


class Segment:
    def __init__(self, name: str, n_docs: int,
                 postings: Dict[str, PostingsField], stored: StoredFields,
                 live: Optional[np.ndarray] = None,
                 numerics: Optional[Dict[str, NumericDocValues]] = None,
                 vectors: Optional[Dict[str, VectorValues]] = None,
                 keywords: Optional[Dict[str, KeywordDocValues]] = None,
                 streams: Optional[Dict[str, TokenStreams]] = None,
                 completions: Optional[Dict[str, CompletionValues]] = None):
        self.name = name
        self.n_docs = n_docs
        self.postings = postings
        self.streams = streams or {}
        self.numerics = numerics or {}
        self.keywords = keywords or {}
        self.vectors = vectors or {}
        self.completions = completions or {}
        self.stored = stored
        self.live = live if live is not None else np.ones(n_docs, dtype=bool)
        self.live_version = 0  # bumps on delete; device caches key on it
        # set by the engine that replaced it (a merge or an install)
        self.retired = False
        self._id_map: Optional[Dict[str, int]] = None

    @property
    def id_map(self) -> Dict[str, int]:
        if self._id_map is None:
            self._id_map = {i: d for d, i in enumerate(self.stored.ids)}
        return self._id_map

    def delete(self, docid: int) -> None:
        """Soft delete — flips the live mask (immutable arrays elsewhere)."""
        live = self.live.copy()
        live[docid] = False
        self.live = live
        self.live_version += 1

    def docid_for(self, doc_id: str) -> int:
        d = self.id_map.get(doc_id, -1)
        if d >= 0 and not self.live[d]:
            return -1
        return d


class SegmentWriter:
    """Accumulates parsed documents, then builds an immutable Segment."""

    def __init__(self):
        self._docs: List[Any] = []  # ParsedDocument

    def add(self, parsed) -> int:
        self._docs.append(parsed)
        return len(self._docs) - 1

    def __len__(self):
        return len(self._docs)

    @property
    def docs(self):
        return self._docs

    def build(self, name: str) -> Segment:
        docs = self._docs
        n = len(docs)
        # postings: text fields (tf = within-doc term count) and keyword
        # fields (tf = 1 per distinct value, length = number of values)
        field_term_docs: Dict[str, Dict[str, List[Tuple[int, float]]]] = {}
        field_lengths: Dict[str, np.ndarray] = {}
        for docid, d in enumerate(docs):
            for f, toks in d.text_tokens.items():
                per = field_term_docs.setdefault(f, {})
                counts: Dict[str, int] = {}
                for t in toks:
                    counts[t.term] = counts.get(t.term, 0) + 1
                for term, tf in counts.items():
                    per.setdefault(term, []).append((docid, float(tf)))
                field_lengths.setdefault(
                    f, np.zeros(n, np.float32))[docid] = len(toks)
            for f, terms in d.keyword_terms.items():
                per = field_term_docs.setdefault(f, {})
                for term in set(terms):
                    per.setdefault(term, []).append((docid, 1.0))
                field_lengths.setdefault(
                    f, np.zeros(n, np.float32))[docid] = len(terms)
        postings = {
            f: _build_postings_field(f, term_docs, field_lengths[f], n)
            for f, term_docs in field_term_docs.items()
        }
        streams = {f: _build_streams(f, docs, postings[f].term_index)
                   for f in sorted({f for d in docs for f in d.text_tokens})}
        # numeric doc values
        numerics = {}
        for f in {f for d in docs for f in d.numeric_values}:
            values = np.full(n, np.nan, np.float64)
            missing = np.ones(n, bool)
            offsets = np.zeros(n + 1, np.int64)
            all_vals: List[float] = []
            for docid, d in enumerate(docs):
                vs = d.numeric_values.get(f, [])
                if vs:
                    values[docid] = vs[0]
                    missing[docid] = False
                    all_vals.extend(sorted(vs))
                offsets[docid + 1] = len(all_vals)
            numerics[f] = NumericDocValues(f, values, missing, offsets,
                                           np.asarray(all_vals, np.float64))
        # keyword ordinals: each doc's distinct values, ascending
        keywords = {}
        for f in {f for d in docs for f in d.keyword_terms}:
            uniq = sorted({t for d in docs
                           for t in d.keyword_terms.get(f, [])})
            tindex = {t: i for i, t in enumerate(uniq)}
            ords = np.full(n, -1, np.int32)
            offsets = np.zeros(n + 1, np.int64)
            all_ords: List[int] = []
            for docid, d in enumerate(docs):
                terms = sorted(set(d.keyword_terms.get(f, [])))
                if terms:
                    ords[docid] = tindex[terms[0]]
                    all_ords.extend(tindex[t] for t in terms)
                offsets[docid + 1] = len(all_ords)
            keywords[f] = KeywordDocValues(f, uniq, ords, offsets,
                                           np.asarray(all_ords, np.int32))
        vectors = {}
        for f in sorted({f for d in docs for f in d.vectors}):
            dims = next(d.vectors[f].shape[0] for d in docs if f in d.vectors)
            sim = next((d.vector_similarity.get(f, "cosine") for d in docs
                        if f in d.vectors), "cosine")
            arr = np.zeros((n, dims), np.float32)
            has = np.zeros(n, bool)
            for docid, d in enumerate(docs):
                v = d.vectors.get(f)
                if v is not None:
                    arr[docid] = v
                    has[docid] = True
            vectors[f] = VectorValues(f, arr, has, dims, sim)
        offsets = np.zeros(n + 1, np.int64)
        chunks = []
        ids = []
        total = 0
        for docid, d in enumerate(docs):
            chunks.append(d.source)
            total += len(d.source)
            offsets[docid + 1] = total
            ids.append(d.doc_id)
        stored = StoredFields(offsets, b"".join(chunks), ids)
        completions = {
            f: _completions_of(f, [(i, w, docid, cx)
                                   for docid, d in enumerate(docs)
                                   for i, w, cx in
                                   d.completion_entries.get(f, [])])
            for f in sorted({f for d in docs for f in d.completion_entries})}
        return Segment(name, n, postings, stored, numerics=numerics,
                       vectors=vectors, keywords=keywords, streams=streams,
                       completions=completions)


def _build_streams(f: str, docs, tindex: Dict[str, int]) -> TokenStreams:
    """One text field's token streams: each token at its position, up to
    ``MAX_STREAM_LEN``; on a shared position the first token written
    keeps the slot."""
    n = len(docs)
    max_len = min(MAX_STREAM_LEN,
                  max((ts[-1].position + 1 for d in docs
                       if (ts := d.text_tokens.get(f))), default=0))
    toks = np.full((n, max_len), -1, np.int32)
    lengths = np.zeros(n, np.int32)
    for docid, d in enumerate(docs):
        length = 0
        for t in d.text_tokens.get(f) or ():
            if t.position >= max_len:
                break
            if toks[docid, t.position] < 0:
                toks[docid, t.position] = tindex[t.term]
            length = max(length, t.position + 1)
        lengths[docid] = length
    return TokenStreams(f, toks, lengths)


def _build_postings_field(field: str, term_docs: Dict[str, Any],
                          field_lengths: np.ndarray,
                          n_docs: int) -> PostingsField:
    """term_docs values are either a list of (docid, tf) tuples (writer
    path) or a list of (docids_array, tfs_array) chunks (merge path) —
    both docid-ascending."""
    terms = sorted(term_docs)
    num_terms = len(terms)
    doc_freq = np.zeros(num_terms, np.int32)
    ttf = np.zeros(num_terms, np.int64)
    tbs = np.zeros(num_terms, np.int32)
    tbc = np.zeros(num_terms, np.int32)

    blocks_d: List[np.ndarray] = []
    blocks_t: List[np.ndarray] = []
    next_block = 0
    for tid, term in enumerate(terms):
        plist = term_docs[term]
        if plist and isinstance(plist[0], tuple) and np.isscalar(plist[0][0]):
            docids = np.asarray([p[0] for p in plist], np.int32)
            tfs = np.asarray([p[1] for p in plist], np.float32)
        else:
            docids = np.concatenate([c[0] for c in plist]).astype(np.int32)
            tfs = np.concatenate([c[1] for c in plist]).astype(np.float32)
        doc_freq[tid] = len(docids)
        ttf[tid] = int(tfs.sum())
        nb = (len(docids) + BLOCK_SIZE - 1) // BLOCK_SIZE
        tbs[tid] = next_block
        tbc[tid] = nb
        next_block += nb
        pad = nb * BLOCK_SIZE - len(docids)
        if pad:
            # tf=0 padding scores exactly 0; docid 0 is a harmless target
            docids = np.concatenate([docids, np.zeros(pad, np.int32)])
            tfs = np.concatenate([tfs, np.zeros(pad, np.float32)])
        blocks_d.append(docids.reshape(nb, BLOCK_SIZE))
        blocks_t.append(tfs.reshape(nb, BLOCK_SIZE))

    if blocks_d:
        block_docids = np.concatenate(blocks_d, axis=0)
        block_tfs = np.concatenate(blocks_t, axis=0)
    else:
        block_docids = np.zeros((0, BLOCK_SIZE), np.int32)
        block_tfs = np.zeros((0, BLOCK_SIZE), np.float32)
    max_tf, min_len = block_max_meta(block_docids, block_tfs, field_lengths)
    return PostingsField(
        field=field, terms=terms, doc_freq=doc_freq, total_term_freq=ttf,
        term_block_start=tbs, term_block_count=tbc,
        block_docids=block_docids, block_tfs=block_tfs,
        block_max_tf=max_tf, block_min_len=min_len,
        field_lengths=field_lengths,
        sum_total_term_freq=int(ttf.sum()),
        sum_doc_freq=int(doc_freq.sum()),
        doc_count=int((field_lengths > 0).sum()))


def block_max_meta(block_docids: np.ndarray, block_tfs: np.ndarray,
                   field_lengths: np.ndarray, chunk: int = 1 << 16):
    """(block_max_tf, block_min_len), float32 [num_blocks] each: the
    largest tf of each block, and the smallest field length over the
    block's real postings (tf > 0), 0 for a block without any. Built in
    chunks of blocks so a corpus of millions of docs needs no
    [num_blocks, 128] temporary."""
    nb = block_docids.shape[0]
    max_tf = np.zeros(nb, np.float32)
    min_len = np.zeros(nb, np.float32)
    for lo in range(0, nb, chunk):
        tf = block_tfs[lo:lo + chunk]
        max_tf[lo:lo + chunk] = tf.max(axis=1)
        lens = np.where(tf > 0, field_lengths[block_docids[lo:lo + chunk]],
                        np.inf).min(axis=1)
        min_len[lo:lo + chunk] = np.where(np.isfinite(lens), lens, 0.0)
    return max_tf, min_len


def merge_segments(name: str, segments: List[Segment]) -> Segment:
    """Merge segments, dropping deleted docs and remapping docids: per-
    segment old -> new docid maps, then concatenation of per-term
    postings in segment order (docids stay ascending because new ids are
    assigned in segment order)."""
    maps: List[np.ndarray] = []
    new_n = 0
    for seg in segments:
        m = np.full(seg.n_docs, -1, np.int64)
        live_ids = np.nonzero(seg.live)[0]
        m[live_ids] = np.arange(new_n, new_n + len(live_ids))
        new_n += len(live_ids)
        maps.append(m)

    postings: Dict[str, PostingsField] = {}
    for f in sorted({f for s in segments for f in s.postings}):
        term_docs: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
        field_lengths = np.zeros(new_n, np.float32)
        for seg, m in zip(segments, maps):
            pf = seg.postings.get(f)
            if pf is None:
                continue
            keep = m >= 0
            field_lengths[m[keep]] = pf.field_lengths[keep]
            for tid, term in enumerate(pf.terms):
                start = int(pf.term_block_start[tid])
                count = int(pf.term_block_count[tid])
                docids = pf.block_docids[start: start + count].reshape(-1)
                tfs = pf.block_tfs[start: start + count].reshape(-1)
                mask = (tfs > 0) & seg.live[docids]
                if not mask.any():
                    continue
                term_docs.setdefault(term, []).append(
                    (m[docids[mask]].astype(np.int64), tfs[mask]))
        postings[f] = _build_postings_field(f, term_docs, field_lengths,
                                            new_n)

    numerics = {f: _merge_numerics(f, segments, maps, new_n)
                for f in sorted({f for s in segments for f in s.numerics})}
    keywords = {f: _merge_keywords(f, segments, maps, new_n)
                for f in sorted({f for s in segments for f in s.keywords})}

    vectors: Dict[str, VectorValues] = {}
    for f in sorted({f for s in segments for f in s.vectors}):
        first = next(s.vectors[f] for s in segments if f in s.vectors)
        arr = np.zeros((new_n, first.dims), np.float32)
        has = np.zeros(new_n, bool)
        for seg, m in zip(segments, maps):
            vv = seg.vectors.get(f)
            if vv is None:
                continue
            keep = seg.live
            arr[m[keep]] = vv.vectors[keep]
            has[m[keep]] = vv.has_value[keep]
        vectors[f] = VectorValues(f, arr, has, first.dims, first.similarity)

    streams = {f: _merge_streams(f, segments, maps, new_n, postings[f])
               for f in sorted({f for s in segments for f in s.streams})
               if f in postings}

    offsets = np.zeros(new_n + 1, np.int64)
    chunks: List[bytes] = []
    ids: List[str] = []
    total = 0
    for seg, m in zip(segments, maps):
        for old in np.nonzero(seg.live)[0]:
            src = seg.stored.source(int(old))
            chunks.append(src)
            total += len(src)
            offsets[int(m[old]) + 1] = total
            ids.append(seg.stored.ids[int(old)])
    stored = StoredFields(offsets, b"".join(chunks), ids)
    # completions: the live docs' entries, remapped
    completions = {}
    for f in sorted({f for s in segments for f in s.completions}):
        entries = []
        for seg, m in zip(segments, maps):
            cv = seg.completions.get(f)
            if cv is None:
                continue
            for i in range(len(cv)):
                old = int(cv.doc_of[i])
                if seg.live[old]:
                    entries.append((cv.inputs[i], float(cv.weights[i]),
                                    int(m[old]),
                                    cv.contexts[i] if cv.contexts is not None
                                    else frozenset()))
        completions[f] = _completions_of(f, entries)
    return Segment(name, new_n, postings, stored, numerics=numerics,
                   vectors=vectors, keywords=keywords, streams=streams,
                   completions=completions)


def _merge_streams(f: str, segments: List[Segment], maps: List[np.ndarray],
                   new_n: int, pf_new: PostingsField) -> TokenStreams:
    """One field's token streams of a merge: the live docs' rows in
    new-docid order, each old term id remapped to the merged
    dictionary's (a term only deleted docs held maps to -1, and so does
    the -1 pad, through the remap's extra last slot)."""
    max_len = max(s.streams[f].tokens.shape[1]
                  for s in segments if f in s.streams)
    toks = np.full((new_n, max_len), -1, np.int32)
    lengths = np.zeros(new_n, np.int32)
    new_index = pf_new.term_index
    for seg, m in zip(segments, maps):
        ts = seg.streams.get(f)
        if ts is None:
            continue
        old_terms = seg.postings[f].terms
        remap = np.fromiter((new_index.get(t, -1) for t in old_terms),
                            np.int32, count=len(old_terms))
        remap = np.concatenate([remap, np.asarray([-1], np.int32)])
        live_ids = np.nonzero(seg.live)[0]
        width = ts.tokens.shape[1]
        toks[m[live_ids], :width] = remap[ts.tokens[live_ids]]
        lengths[m[live_ids]] = ts.lengths[live_ids]
    return TokenStreams(f, toks, lengths)


def _merge_numerics(f: str, segments: List[Segment], maps: List[np.ndarray],
                    new_n: int) -> NumericDocValues:
    """One numeric column of a merge: the live docs' first values,
    missing flags and value lists, in new-docid order (new ids ascend
    with segment order, so concatenating the segments' live slices in
    order lays the values out by new docid)."""
    values = np.full(new_n, np.nan, np.float64)
    missing = np.ones(new_n, bool)
    counts = np.zeros(new_n, np.int64)
    chunks: List[np.ndarray] = []
    for seg, m in zip(segments, maps):
        nv = seg.numerics.get(f)
        if nv is None:
            continue
        old = np.nonzero(seg.live)[0]
        new = m[old]
        lo, lens = nv.offsets[old], nv.offsets[old + 1] - nv.offsets[old]
        has = lens > 0
        values[new[has]] = nv.values[old[has]]
        missing[new[has]] = False
        counts[new] = lens
        # every live doc's value list, in order: its run lo .. lo+len-1
        run_start = np.cumsum(lens) - lens
        chunks.append(nv.all_values[np.repeat(lo - run_start, lens)
                                    + np.arange(int(lens.sum()))])
    offsets = np.zeros(new_n + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    all_values = (np.concatenate(chunks) if chunks
                  else np.zeros(0, np.float64))
    return NumericDocValues(f, values, missing, offsets, all_values)


def _merge_keywords(f: str, segments: List[Segment], maps: List[np.ndarray],
                    new_n: int) -> KeywordDocValues:
    """One keyword column of a merge: the term dictionary of the values
    the live docs hold, and each live doc's ords remapped into it in
    new-docid order. Both dictionaries are sorted, so the remap keeps
    each doc's ords ascending."""
    # per segment: (column, live old docids, their new ids, their value
    # counts, the positions of their values in all_ords)
    parts = []
    used = set()
    for seg, m in zip(segments, maps):
        kv = seg.keywords.get(f)
        if kv is None:
            continue
        old = np.nonzero(seg.live)[0]
        lens = kv.offsets[old + 1] - kv.offsets[old]
        run_start = np.cumsum(lens) - lens
        pos = (np.repeat(kv.offsets[old] - run_start, lens)
               + np.arange(int(lens.sum())))
        used.update(kv.terms[int(o)] for o in np.unique(kv.all_ords[pos]))
        parts.append((kv, old, m[old], lens, pos))
    uniq = sorted(used)
    tindex = {t: i for i, t in enumerate(uniq)}
    ords = np.full(new_n, -1, np.int32)
    counts = np.zeros(new_n, np.int64)
    chunks: List[np.ndarray] = []
    for kv, old, new, lens, pos in parts:
        remap = np.asarray([tindex.get(t, -1) for t in kv.terms], np.int32)
        has = lens > 0
        ords[new[has]] = remap[kv.ords[old[has]]]
        counts[new] = lens
        chunks.append(remap[kv.all_ords[pos]])
    offsets = np.zeros(new_n + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    all_ords = (np.concatenate(chunks).astype(np.int32) if chunks
                else np.zeros(0, np.int32))
    return KeywordDocValues(f, uniq, ords, offsets, all_ords)


def segment_from_numpy(arrays: Dict[str, Any], name: str = "imported",
                       field: Optional[str] = None) -> Segment:
    """Build a Segment from plain numpy arrays — how an index built
    elsewhere (a reference segment's arrays, a generated corpus) enters
    the port without importing the code that built it.

    ``arrays["fields"]`` maps each field name to that field's postings
    arrays: ``terms`` (sorted list of str), ``doc_freq``,
    ``term_block_start``, ``term_block_count``, ``block_docids``
    [TB, 128], ``block_tfs`` [TB, 128], ``field_lengths`` [n_docs] and
    optionally ``total_term_freq``. For a segment of one field those
    arrays may sit in ``arrays`` itself, the field named by ``field=``
    (or ``arrays["field"]``, default "body"). Optional for the segment:
    ``ids`` (list of str, default the docid as text), ``live`` [n_docs]
    bool, ``sources`` (list of bytes) and ``numerics``, which maps each
    numeric field to its doc values: ``values`` float64 [n_docs] (a
    doc's first value) and optionally ``missing`` bool [n_docs] (default
    where ``values`` is NaN) and ``offsets`` [n_docs + 1] /
    ``all_values`` (default one value per doc that has one); and
    ``vectors``, which maps each dense_vector field to ``vectors``
    float32 [n_docs, dims] (kept as given, not copied, when already
    float32 and contiguous: it is the host copy the exact re-rank
    reads), and optionally ``has_value`` bool [n_docs] (default all) and
    ``similarity`` (default "cosine"); and ``keywords``, which maps each
    keyword field to its doc values: ``terms`` (the sorted distinct
    values), ``ords`` int32 [n_docs] (a doc's first ord, -1 where it has
    none) and optionally ``offsets`` [n_docs + 1] / ``all_ords`` (each
    doc's distinct ords ascending; default one value per doc that has
    one); and ``streams``, which maps each text field with postings to
    its token streams: ``tokens`` int32 [n_docs, max_len] of term ids
    into that field's ``terms`` (-1 pad, at most ``MAX_STREAM_LEN``
    wide; kept as given when already int32 and contiguous) and
    ``lengths`` int32 [n_docs] (each row's last token position + 1); and
    ``completions``, which maps each completion field to ``inputs``
    (list of str), ``weights`` [n_entries], ``doc_of`` [n_entries] (each
    entry's docid) and optionally ``contexts`` (a frozenset of
    "name=value" per entry). A segment of vectors alone needs no
    postings."""
    fields = arrays.get("fields")
    if fields is None:
        fields = ({field or arrays.get("field") or "body": arrays}
                  if "block_docids" in arrays else {})
    postings = {f: _postings_from_numpy(f, a) for f, a in fields.items()}
    numerics = {f: _numerics_from_numpy(f, a)
                for f, a in (arrays.get("numerics") or {}).items()}
    vectors = {f: _vectors_from_numpy(f, a)
               for f, a in (arrays.get("vectors") or {}).items()}
    keywords = {f: _keywords_from_numpy(f, a)
                for f, a in (arrays.get("keywords") or {}).items()}
    streams = {f: _streams_from_numpy(f, a, postings.get(f))
               for f, a in (arrays.get("streams") or {}).items()}
    sizes = ({len(pf.field_lengths) for pf in postings.values()}
             | {len(nv.values) for nv in numerics.values()}
             | {len(vv.has_value) for vv in vectors.values()}
             | {len(kv.ords) for kv in keywords.values()}
             | {len(ts.lengths) for ts in streams.values()})
    if len(sizes) != 1:
        raise ValueError(f"fields disagree on the doc count: {sorted(sizes)}")
    n = sizes.pop()
    ids = arrays.get("ids")
    ids = [str(i) for i in range(n)] if ids is None else list(ids)
    sources = arrays.get("sources")
    if sources is None:
        stored = StoredFields(np.zeros(n + 1, np.int64), b"", ids)
    else:
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(s) for s in sources], out=offsets[1:])
        stored = StoredFields(offsets, b"".join(sources), ids)
    live = arrays.get("live")
    completions = {
        f: CompletionValues(f, list(a["inputs"]), a["weights"], a["doc_of"],
                            a.get("contexts"))
        for f, a in (arrays.get("completions") or {}).items()}
    return Segment(name, n, postings, stored,
                   None if live is None else np.asarray(live, bool).copy(),
                   numerics=numerics, vectors=vectors, keywords=keywords,
                   streams=streams, completions=completions)


def _streams_from_numpy(fname: str, arrays: Dict[str, Any],
                        pf: Optional[PostingsField]) -> TokenStreams:
    if pf is None:
        raise ValueError(f"streams of [{fname}]: the field has no postings")
    tokens = np.ascontiguousarray(arrays["tokens"], np.int32)
    if tokens.ndim != 2 or tokens.shape[1] > MAX_STREAM_LEN:
        raise ValueError(f"streams of [{fname}]: tokens must be [n_docs, "
                         f"max_len] with max_len <= {MAX_STREAM_LEN}")
    if len(tokens) and tokens.shape[1] and (
            tokens.min() < -1 or tokens.max() >= len(pf.terms)):
        raise ValueError(f"streams of [{fname}]: term ids must be in "
                         f"[-1, {len(pf.terms)})")
    lengths = np.asarray(arrays["lengths"], np.int32)
    if lengths.shape != (len(tokens),):
        raise ValueError(f"streams of [{fname}]: lengths must be [n_docs]")
    return TokenStreams(fname, tokens, lengths)


def _keywords_from_numpy(fname: str, arrays: Dict[str, Any]) \
        -> KeywordDocValues:
    terms = list(arrays["terms"])
    ords = np.asarray(arrays["ords"], np.int32)
    if ords.ndim != 1 or (len(ords) and (ords.min() < -1
                                         or ords.max() >= len(terms))):
        raise ValueError(f"keyword field [{fname}]: ords must be [n_docs] "
                         f"in [-1, {len(terms)})")
    if arrays.get("offsets") is None:
        offsets = np.zeros(len(ords) + 1, np.int64)
        np.cumsum(ords >= 0, out=offsets[1:])
        all_ords = ords[ords >= 0]
    else:
        offsets = np.asarray(arrays["offsets"], np.int64)
        all_ords = np.asarray(arrays["all_ords"], np.int32)
        if offsets.shape != (len(ords) + 1,) \
                or offsets[-1] != len(all_ords):
            raise ValueError(f"keyword field [{fname}]: offsets must be "
                             f"[n_docs + 1] ending at len(all_ords)")
    return KeywordDocValues(fname, terms, ords, offsets, all_ords)


def _vectors_from_numpy(fname: str, arrays: Dict[str, Any]) -> VectorValues:
    vecs = np.ascontiguousarray(arrays["vectors"], np.float32)
    if vecs.ndim != 2:
        raise ValueError(f"vector field [{fname}]: vectors must be "
                         f"[n_docs, dims]")
    has = arrays.get("has_value")
    has = (np.ones(len(vecs), bool) if has is None
           else np.asarray(has, bool))
    if has.shape != (len(vecs),):
        raise ValueError(f"vector field [{fname}]: has_value must be "
                         f"[n_docs]")
    return VectorValues(fname, vecs, has, int(vecs.shape[1]),
                        arrays.get("similarity", "cosine"))


def _numerics_from_numpy(fname: str, arrays: Dict[str, Any]) \
        -> NumericDocValues:
    values = np.asarray(arrays["values"], np.float64)
    missing = arrays.get("missing")
    missing = (np.isnan(values) if missing is None
               else np.asarray(missing, bool))
    if missing.shape != values.shape:
        raise ValueError(f"numeric field [{fname}]: missing and values "
                         f"differ in shape")
    if arrays.get("offsets") is None:
        offsets = np.zeros(len(values) + 1, np.int64)
        np.cumsum(~missing, out=offsets[1:])
        all_values = values[~missing]
    else:
        offsets = np.asarray(arrays["offsets"], np.int64)
        all_values = np.asarray(arrays["all_values"], np.float64)
    return NumericDocValues(fname, values, missing, offsets, all_values)


def _postings_from_numpy(fname: str, arrays: Dict[str, Any]) -> PostingsField:
    block_docids = np.ascontiguousarray(arrays["block_docids"], np.int32)
    block_tfs = np.ascontiguousarray(arrays["block_tfs"], np.float32)
    if block_docids.ndim != 2 or block_docids.shape[1] != BLOCK_SIZE \
            or block_tfs.shape != block_docids.shape:
        raise ValueError("block arrays must be [num_blocks, 128]")
    lengths = np.asarray(arrays["field_lengths"], np.float32)
    doc_freq = np.asarray(arrays["doc_freq"], np.int32)
    starts = np.asarray(arrays["term_block_start"], np.int64)
    counts = np.asarray(arrays["term_block_count"], np.int64)
    ttf = arrays.get("total_term_freq")
    if ttf is None:     # each term's tf sum over its blocks
        csum = np.concatenate([[0.0], np.cumsum(
            block_tfs.sum(axis=1, dtype=np.float64))])
        ttf = csum[starts + counts] - csum[starts]
    ttf = np.asarray(ttf, np.int64)
    if arrays.get("block_max_tf") is not None \
            and arrays.get("block_min_len") is not None:
        max_tf = np.asarray(arrays["block_max_tf"], np.float32)
        min_len = np.asarray(arrays["block_min_len"], np.float32)
        if max_tf.shape != (block_docids.shape[0],) \
                or min_len.shape != max_tf.shape:
            raise ValueError("block_max_tf/block_min_len must be [num_blocks]")
    else:
        max_tf, min_len = block_max_meta(block_docids, block_tfs, lengths)
    return PostingsField(
        field=fname, terms=list(arrays["terms"]), doc_freq=doc_freq,
        total_term_freq=ttf,
        term_block_start=starts.astype(np.int32),
        term_block_count=counts.astype(np.int32),
        block_docids=block_docids, block_tfs=block_tfs,
        block_max_tf=max_tf, block_min_len=min_len,
        field_lengths=lengths,
        sum_total_term_freq=int(ttf.sum()),
        sum_doc_freq=int(doc_freq.sum()),
        doc_count=int((lengths > 0).sum()))
