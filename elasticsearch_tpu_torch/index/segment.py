"""Immutable segments (counterpart of elasticsearch_tpu/index/segment.py),
reduced to what the `_search` BM25 slice reads: text postings, doc
lengths, ids, `_source` and the live mask.

- **Postings as padded blocks.** Each text field's postings are
  concatenated into blocks of ``BLOCK_SIZE`` (128): ``block_docids
  [num_blocks, 128] int32`` and ``block_tfs [num_blocks, 128] float32``.
  Padding carries ``tf = 0`` and ``docid = 0`` and scores exactly 0. A
  term's blocks are ``term_block_start/term_block_count``; a term's last
  block is padded rather than shared, so block gathers never mix terms.
- **Deletes as masks**: ``live[n_docs] bool``.

Docids are segment-local dense int32.
"""

from __future__ import annotations

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
class StoredFields:
    offsets: np.ndarray     # int64 [n_docs + 1]
    data: bytes
    ids: List[str]

    def source(self, docid: int) -> bytes:
        return self.data[self.offsets[docid]: self.offsets[docid + 1]]


class Segment:
    def __init__(self, name: str, n_docs: int,
                 postings: Dict[str, PostingsField], stored: StoredFields,
                 live: Optional[np.ndarray] = None):
        self.name = name
        self.n_docs = n_docs
        self.postings = postings
        self.stored = stored
        self.live = live if live is not None else np.ones(n_docs, dtype=bool)
        self._id_map: Optional[Dict[str, int]] = None

    @property
    def id_map(self) -> Dict[str, int]:
        if self._id_map is None:
            self._id_map = {i: d for d, i in enumerate(self.stored.ids)}
        return self._id_map

    def delete(self, docid: int) -> None:
        """Soft delete — flips the live mask (immutable arrays elsewhere)."""
        self.live = self.live.copy()
        self.live[docid] = False

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
        # text postings: tf = within-doc term count
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
        postings = {
            f: _build_postings_field(f, term_docs, field_lengths[f], n)
            for f, term_docs in field_term_docs.items()
        }
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
        return Segment(name, n, postings, stored)


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
    return PostingsField(
        field=field, terms=terms, doc_freq=doc_freq, total_term_freq=ttf,
        term_block_start=tbs, term_block_count=tbc,
        block_docids=block_docids, block_tfs=block_tfs,
        field_lengths=field_lengths,
        sum_total_term_freq=int(ttf.sum()),
        sum_doc_freq=int(doc_freq.sum()),
        doc_count=int((field_lengths > 0).sum()))


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
    return Segment(name, new_n, postings, stored)


def segment_from_numpy(arrays: Dict[str, Any], name: str = "imported",
                       field: Optional[str] = None) -> Segment:
    """Build a Segment from plain numpy arrays — how an index built
    elsewhere (a reference segment's arrays, a generated corpus) enters
    the port without importing the code that built it.

    ``arrays`` holds one field's postings: ``terms`` (sorted list of
    str), ``doc_freq``, ``term_block_start``, ``term_block_count``,
    ``block_docids`` [TB, 128], ``block_tfs`` [TB, 128] and
    ``field_lengths`` [n_docs]; optionally ``total_term_freq``, ``ids``
    (list of str, default the docid as text), ``live`` [n_docs] bool,
    ``field`` (the field name) and ``sources`` (list of bytes)."""
    fname = field or arrays.get("field") or "body"
    block_docids = np.ascontiguousarray(arrays["block_docids"], np.int32)
    block_tfs = np.ascontiguousarray(arrays["block_tfs"], np.float32)
    if block_docids.ndim != 2 or block_docids.shape[1] != BLOCK_SIZE \
            or block_tfs.shape != block_docids.shape:
        raise ValueError("block arrays must be [num_blocks, 128]")
    lengths = np.asarray(arrays["field_lengths"], np.float32)
    n = len(lengths)
    doc_freq = np.asarray(arrays["doc_freq"], np.int32)
    starts = np.asarray(arrays["term_block_start"], np.int64)
    counts = np.asarray(arrays["term_block_count"], np.int64)
    ttf = arrays.get("total_term_freq")
    if ttf is None:     # each term's tf sum over its blocks
        csum = np.concatenate([[0.0], np.cumsum(
            block_tfs.sum(axis=1, dtype=np.float64))])
        ttf = csum[starts + counts] - csum[starts]
    pf = PostingsField(
        field=fname, terms=list(arrays["terms"]), doc_freq=doc_freq,
        total_term_freq=np.asarray(ttf, np.int64),
        term_block_start=starts.astype(np.int32),
        term_block_count=counts.astype(np.int32),
        block_docids=block_docids, block_tfs=block_tfs,
        field_lengths=lengths,
        sum_total_term_freq=int(lengths.sum(dtype=np.float64)),
        sum_doc_freq=int(doc_freq.sum()),
        doc_count=int((lengths > 0).sum()))
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
    return Segment(name, n, {fname: pf}, stored,
                   None if live is None else np.asarray(live, bool).copy())
