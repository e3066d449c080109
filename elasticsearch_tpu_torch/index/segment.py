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
- **On disk** (``Segment.save``/``Segment.load``): a directory of
  ``meta.json`` (the format version, the name, per-field statistics),
  ``arrays.npz`` (every array above, keyed ``p~field~...``,
  ``n~field~...``, ``k~``, ``v~``, ``s~``, ``c~``, ``stored~`` and
  ``live``) and ``stored.bin`` (the ``_source`` bytes): the same files
  as elasticsearch_tpu/index/segment.py writes, so each package opens
  the other's segments.

Docids are segment-local dense int32.
"""

from __future__ import annotations

import bisect
import heapq
import itertools
import json
import operator
import os
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.analysis.tokenizers import TermRun

BLOCK_SIZE = 128

# the on-disk segment format's generation (the reference's): a segment
# written by a newer one is refused
SEGMENT_FORMAT_VERSION = 1


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

    @property
    def live_doc_count(self) -> int:
        return int(self.live.sum())

    def ram_bytes(self) -> int:
        """The host bytes of the live mask, the stored fields, the
        postings, the numeric columns and the vectors (the reference's
        sum: a rollover's ``max_size`` reads it)."""
        total = (self.live.nbytes + self.stored.offsets.nbytes
                 + len(self.stored.data))
        for pf in self.postings.values():
            total += (pf.block_docids.nbytes + pf.block_tfs.nbytes
                      + pf.block_max_tf.nbytes + pf.block_min_len.nbytes
                      + pf.field_lengths.nbytes + pf.doc_freq.nbytes
                      + pf.term_block_start.nbytes
                      + pf.term_block_count.nbytes)
        for nv in self.numerics.values():
            total += nv.values.nbytes + nv.all_values.nbytes
        for vv in self.vectors.values():
            total += vv.vectors.nbytes
        return total

    # ------------------------------------------------------------------ I/O
    @staticmethod
    def _encode_strings(strings: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Strings -> (utf-8 blob, offsets); newline-safe."""
        encoded = [s.encode("utf-8") for s in strings]
        offsets = np.zeros(len(encoded) + 1, np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        blob = np.frombuffer(b"".join(encoded), dtype=np.uint8)
        return blob, offsets

    @staticmethod
    def _decode_strings(blob: np.ndarray, offsets: np.ndarray) -> List[str]:
        raw = blob.tobytes()
        return [raw[offsets[i]:offsets[i + 1]].decode("utf-8")
                for i in range(len(offsets) - 1)]

    def save(self, directory: str) -> None:
        """Write the segment's three files into ``directory``."""
        os.makedirs(directory, exist_ok=True)
        arrays: Dict[str, np.ndarray] = {"live": self.live}
        meta: Dict[str, Any] = {
            "format_version": SEGMENT_FORMAT_VERSION,
            "name": self.name, "n_docs": self.n_docs,
            "postings": {}, "numerics": [], "keywords": {}, "vectors": {},
        }
        for f, pf in self.postings.items():
            key = f"p~{f}"
            arrays[f"{key}~doc_freq"] = pf.doc_freq
            arrays[f"{key}~ttf"] = pf.total_term_freq
            arrays[f"{key}~tbs"] = pf.term_block_start
            arrays[f"{key}~tbc"] = pf.term_block_count
            arrays[f"{key}~bd"] = pf.block_docids
            arrays[f"{key}~bt"] = pf.block_tfs
            arrays[f"{key}~bmt"] = pf.block_max_tf
            arrays[f"{key}~bml"] = pf.block_min_len
            arrays[f"{key}~fl"] = pf.field_lengths
            arrays[f"{key}~terms"], arrays[f"{key}~terms_off"] = \
                self._encode_strings(pf.terms)
            meta["postings"][f] = {
                "sum_total_term_freq": int(pf.sum_total_term_freq),
                "sum_doc_freq": int(pf.sum_doc_freq),
                "doc_count": int(pf.doc_count),
            }
        for f, nv in self.numerics.items():
            key = f"n~{f}"
            arrays[f"{key}~v"] = nv.values
            arrays[f"{key}~m"] = nv.missing
            arrays[f"{key}~o"] = nv.offsets
            arrays[f"{key}~av"] = nv.all_values
            meta["numerics"].append(f)
        for f, kv in self.keywords.items():
            key = f"k~{f}"
            arrays[f"{key}~ords"] = kv.ords
            arrays[f"{key}~o"] = kv.offsets
            arrays[f"{key}~ao"] = kv.all_ords
            arrays[f"{key}~terms"], arrays[f"{key}~terms_off"] = \
                self._encode_strings(kv.terms)
            meta["keywords"][f] = {}
        for f, vv in self.vectors.items():
            key = f"v~{f}"
            arrays[f"{key}~vec"] = vv.vectors
            arrays[f"{key}~has"] = vv.has_value
            meta["vectors"][f] = {"dims": int(vv.dims),
                                  "similarity": vv.similarity}
        meta["streams"] = []
        for f, ts in self.streams.items():
            key = f"s~{f}"
            arrays[f"{key}~tok"] = ts.tokens
            arrays[f"{key}~len"] = ts.lengths
            meta["streams"].append(f)
        meta["completions"] = {}
        for f, cv in self.completions.items():
            key = f"c~{f}"
            arrays[f"{key}~in"], arrays[f"{key}~in_off"] = \
                self._encode_strings(cv.inputs)
            arrays[f"{key}~w"] = cv.weights
            arrays[f"{key}~d"] = cv.doc_of
            if cv.contexts is not None:
                ctx_strs = ["\x1f".join(sorted(c)) for c in cv.contexts]
                arrays[f"{key}~ctx"], arrays[f"{key}~ctx_off"] = \
                    self._encode_strings(ctx_strs)
            meta["completions"][f] = {
                "has_contexts": cv.contexts is not None}
        arrays["stored~offsets"] = self.stored.offsets
        arrays["stored~ids"], arrays["stored~ids_off"] = \
            self._encode_strings(self.stored.ids)
        np.savez(os.path.join(directory, "arrays.npz"), **arrays)
        with open(os.path.join(directory, "stored.bin"), "wb") as fh:
            fh.write(self.stored.data)
        with open(os.path.join(directory, "meta.json"), "w") as fh:
            json.dump(meta, fh)

    @classmethod
    def load(cls, directory: str) -> "Segment":
        """The segment ``save`` (of either package) wrote into
        ``directory``; a newer format is an IOError."""
        with open(os.path.join(directory, "meta.json")) as fh:
            meta = json.load(fh)
        fmt = int(meta.get("format_version", 1))
        if fmt > SEGMENT_FORMAT_VERSION:
            raise IOError(
                f"segment [{directory}] was written by a NEWER build "
                f"(format {fmt} > supported {SEGMENT_FORMAT_VERSION}); "
                f"downgrades are not supported")
        with open(os.path.join(directory, "stored.bin"), "rb") as fh:
            data = fh.read()
        with np.load(os.path.join(directory, "arrays.npz")) as npz:
            z = {k: npz[k] for k in npz.files}
        dec = cls._decode_strings
        postings = {}
        for f, m in meta["postings"].items():
            key = f"p~{f}"
            postings[f] = PostingsField(
                field=f,
                terms=dec(z[f"{key}~terms"], z[f"{key}~terms_off"]),
                doc_freq=z[f"{key}~doc_freq"],
                total_term_freq=z[f"{key}~ttf"],
                term_block_start=z[f"{key}~tbs"],
                term_block_count=z[f"{key}~tbc"],
                block_docids=z[f"{key}~bd"], block_tfs=z[f"{key}~bt"],
                block_max_tf=z[f"{key}~bmt"],
                block_min_len=z[f"{key}~bml"],
                field_lengths=z[f"{key}~fl"],
                sum_total_term_freq=m["sum_total_term_freq"],
                sum_doc_freq=m["sum_doc_freq"], doc_count=m["doc_count"])
        numerics = {}
        for f in meta["numerics"]:
            key = f"n~{f}"
            numerics[f] = NumericDocValues(
                field=f, values=z[f"{key}~v"], missing=z[f"{key}~m"],
                offsets=z[f"{key}~o"], all_values=z[f"{key}~av"])
        keywords = {}
        for f in meta["keywords"]:
            key = f"k~{f}"
            keywords[f] = KeywordDocValues(
                field=f, terms=dec(z[f"{key}~terms"], z[f"{key}~terms_off"]),
                ords=z[f"{key}~ords"], offsets=z[f"{key}~o"],
                all_ords=z[f"{key}~ao"])
        vectors = {}
        for f, m in meta["vectors"].items():
            key = f"v~{f}"
            vectors[f] = VectorValues(
                field=f, vectors=z[f"{key}~vec"], has_value=z[f"{key}~has"],
                dims=m["dims"], similarity=m["similarity"])
        streams = {}
        for f in meta.get("streams", []):
            key = f"s~{f}"
            streams[f] = TokenStreams(f, z[f"{key}~tok"], z[f"{key}~len"])
        completions = {}
        for f, m in meta.get("completions", {}).items():
            key = f"c~{f}"
            ctxs = None
            if m.get("has_contexts"):
                ctxs = [frozenset(s.split("\x1f")) if s else frozenset()
                        for s in dec(z[f"{key}~ctx"], z[f"{key}~ctx_off"])]
            completions[f] = CompletionValues(
                f, dec(z[f"{key}~in"], z[f"{key}~in_off"]), z[f"{key}~w"],
                z[f"{key}~d"], ctxs)
        stored = StoredFields(
            offsets=z["stored~offsets"], data=data,
            ids=dec(z["stored~ids"], z["stored~ids_off"]))
        return cls(meta["name"], meta["n_docs"], postings, stored,
                   live=z["live"].astype(bool), numerics=numerics,
                   vectors=vectors, keywords=keywords, streams=streams,
                   completions=completions)


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
        # postings: text fields (tf = within-doc term count, with token
        # streams) and keyword fields (tf = 1 per distinct value, length
        # = number of values)
        postings: Dict[str, PostingsField] = {}
        streams: Dict[str, TokenStreams] = {}
        for f in sorted({f for d in docs for f in d.text_tokens}):
            postings[f], streams[f] = _build_text_field(f, docs)
        for f in {f for d in docs for f in d.keyword_terms}:
            postings[f] = _build_keyword_field(f, docs)
        # the fields in the order the documents first name them
        order = dict.fromkeys(f for d in docs for f in (
            *d.text_tokens, *d.keyword_terms))
        postings = {f: postings[f] for f in order}
        streams = {f: streams[f] for f in sorted(streams)}
        # numeric doc values
        numerics = {}
        for f in {f for d in docs for f in d.numeric_values}:
            # each doc's values: the first as given, all of them sorted
            per = [d.numeric_values.get(f) or () for d in docs]
            counts = np.fromiter(map(len, per), np.int64, n)
            offsets = np.zeros(n + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            all_vals = np.fromiter(
                itertools.chain.from_iterable(map(sorted, per)),
                np.float64, int(offsets[-1]))
            missing = counts == 0
            values = np.full(n, np.nan, np.float64)
            values[~missing] = np.fromiter(
                (vs[0] for vs in per if vs), np.float64,
                int((~missing).sum()))
            numerics[f] = NumericDocValues(f, values, missing, offsets,
                                           all_vals)
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
        chunks = [d.source for d in docs]
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(np.fromiter(map(len, chunks), np.int64, n),
                  out=offsets[1:])
        stored = StoredFields(offsets, b"".join(chunks),
                              [d.doc_id for d in docs])
        completions = {
            f: _completions_of(f, [(i, w, docid, cx)
                                   for docid, d in enumerate(docs)
                                   for i, w, cx in
                                   d.completion_entries.get(f, [])])
            for f in sorted({f for d in docs for f in d.completion_entries})}
        return Segment(name, n, postings, stored, numerics=numerics,
                       vectors=vectors, keywords=keywords, streams=streams,
                       completions=completions)


def _build_text_field(f: str, docs) -> Tuple[PostingsField, TokenStreams]:
    """One text field's postings and token streams from its tokens, in
    array ops: terms sorted, docids ascending within a term, tf the
    within-doc count, the field length the count of tokens emitted;
    each token at its own position (a stop word's stays a -1 hole) up
    to ``MAX_STREAM_LEN``, the first token written keeping a shared
    position (a synonym stacked on a word)."""
    n = len(docs)
    lengths = np.zeros(n, np.float32)
    flat: List[str] = []
    positions: List[int] = []
    counts = np.zeros(n, np.int64)
    term_of, pos_of = operator.itemgetter(0), operator.itemgetter(1)
    for docid, d in enumerate(docs):
        toks = d.text_tokens.get(f)
        if toks is None:
            continue
        lengths[docid] = counts[docid] = len(toks)
        if isinstance(toks, TermRun):   # positions 0 .. n-1
            flat.extend(toks.terms)
            positions.extend(range(len(toks.terms)))
        else:
            flat.extend(map(term_of, toks))
            positions.extend(map(pos_of, toks))
    terms = sorted(set(flat))
    tindex = {t: i for i, t in enumerate(terms)}
    tok_term = np.fromiter(map(tindex.__getitem__, flat), np.int64,
                           len(flat))
    tok_doc = np.repeat(np.arange(n, dtype=np.int64), counts)
    keys, tf = np.unique(tok_term * n + tok_doc, return_counts=True)
    pf = _postings_of(f, terms, keys // n, (keys % n).astype(np.int32),
                      tf, lengths)
    # the streams: a doc's last token's position bounds its row
    pos = np.asarray(positions, np.int64)
    last = np.zeros(n, np.int64)
    has = counts > 0
    last[has] = pos[np.cumsum(counts)[has] - 1] + 1
    max_len = min(MAX_STREAM_LEN, int(last.max()) if n else 0)
    keep = pos < max_len
    if not keep.all():
        # a doc's row stops at its first token past the row, as the
        # reference's loop breaks there (a later token of a smaller
        # position, a catenated word part, is not written either)
        over = np.cumsum(~keep)
        before = np.concatenate(([0], over))[np.cumsum(counts) - counts]
        keep = over == np.repeat(before, counts)
    slot = tok_doc[keep] * max_len + pos[keep]
    slot, first = np.unique(slot, return_index=True)
    tokens = np.full(n * max_len, -1, np.int32)
    tokens[slot] = tok_term[keep][first]
    row_len = np.zeros(n, np.int64)
    np.maximum.at(row_len, tok_doc[keep], pos[keep] + 1)
    return pf, TokenStreams(f, tokens.reshape(n, max_len),
                            row_len.astype(np.int32))


def _postings_of(field: str, terms: List[str], term_of: np.ndarray,
                 doc_of: np.ndarray, tf: np.ndarray,
                 lengths: np.ndarray) -> PostingsField:
    """A PostingsField from its postings sorted by (term id, docid):
    ``term_of`` indexes the sorted ``terms``, ``doc_of`` int32, ``tf``
    the within-doc counts; each term's blocks padded with tf 0 (which
    scores exactly 0) and docid 0, so block gathers never mix terms."""
    num_terms = len(terms)
    doc_freq = np.bincount(term_of, minlength=num_terms).astype(np.int32)
    ttf = np.bincount(term_of, weights=tf,
                      minlength=num_terms).astype(np.int64)
    nb = (doc_freq.astype(np.int64) + BLOCK_SIZE - 1) // BLOCK_SIZE
    starts = np.zeros(num_terms + 1, np.int64)
    np.cumsum(nb, out=starts[1:])
    group = np.zeros(num_terms + 1, np.int64)
    np.cumsum(doc_freq, out=group[1:])
    dest = (starts[term_of] * BLOCK_SIZE
            + np.arange(len(term_of), dtype=np.int64) - group[term_of])
    total = int(starts[-1])
    block_docids = np.zeros(total * BLOCK_SIZE, np.int32)
    block_tfs = np.zeros(total * BLOCK_SIZE, np.float32)
    block_docids[dest] = doc_of
    block_tfs[dest] = tf
    block_docids = block_docids.reshape(total, BLOCK_SIZE)
    block_tfs = block_tfs.reshape(total, BLOCK_SIZE)
    max_tf, min_len = block_max_meta(block_docids, block_tfs, lengths)
    return PostingsField(
        field=field, terms=terms, doc_freq=doc_freq, total_term_freq=ttf,
        term_block_start=starts[:-1].astype(np.int32),
        term_block_count=nb.astype(np.int32),
        block_docids=block_docids, block_tfs=block_tfs,
        block_max_tf=max_tf, block_min_len=min_len, field_lengths=lengths,
        sum_total_term_freq=int(ttf.sum()),
        sum_doc_freq=int(doc_freq.sum()),
        doc_count=int((lengths > 0).sum()))


def _build_keyword_field(f: str, docs) -> PostingsField:
    """One keyword field's postings: tf 1 for each distinct value of a
    doc, the doc's length its number of values."""
    n = len(docs)
    lengths = np.zeros(n, np.float32)
    flat: List[str] = []
    counts = np.zeros(n, np.int64)
    for docid, d in enumerate(docs):
        terms = d.keyword_terms.get(f)
        if terms is None:
            continue
        lengths[docid] = len(terms)
        distinct = set(terms)
        counts[docid] = len(distinct)
        flat.extend(distinct)
    names = sorted(set(flat))
    tindex = {t: i for i, t in enumerate(names)}
    term_of = np.fromiter(map(tindex.__getitem__, flat), np.int64, len(flat))
    doc_of = np.repeat(np.arange(n, dtype=np.int64), counts)
    order = np.lexsort((doc_of, term_of))
    return _postings_of(f, names, term_of[order],
                        doc_of[order].astype(np.int32),
                        np.ones(len(flat), np.float32), lengths)


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

    postings = {f: _merge_postings(f, segments, maps, new_n)
                for f in sorted({f for s in segments for f in s.postings})}

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

    # the live docs' sources and ids in new-docid order (new ids ascend
    # with segment order)
    sizes: List[np.ndarray] = []
    data: List[np.ndarray] = []
    ids: List[str] = []
    for seg in segments:
        old = np.nonzero(seg.live)[0]
        lo = seg.stored.offsets[old]
        lens = seg.stored.offsets[old + 1] - lo
        run_start = np.cumsum(lens) - lens
        raw = np.frombuffer(seg.stored.data, np.uint8)
        data.append(raw[np.repeat(lo - run_start, lens)
                        + np.arange(int(lens.sum()))])
        sizes.append(lens)
        seg_ids = seg.stored.ids
        ids.extend(map(seg_ids.__getitem__, old.tolist()))
    offsets = np.zeros(new_n + 1, np.int64)
    if sizes:
        np.cumsum(np.concatenate(sizes), out=offsets[1:])
    stored = StoredFields(offsets, np.concatenate(data).tobytes()
                          if data else b"", ids)
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


def _merge_postings(f: str, segments: List[Segment], maps: List[np.ndarray],
                    new_n: int) -> PostingsField:
    """One postings field of a merge: the live docs' postings with their
    new docids, over the terms some live doc still holds, in the
    field's block layout (a stable sort by term keeps each term's
    docids ascending: new ids ascend with segment order)."""
    lengths = np.zeros(new_n, np.float32)
    parts = []
    for seg, m in zip(segments, maps):
        pf = seg.postings.get(f)
        if pf is None:
            continue
        keep = m >= 0
        lengths[m[keep]] = pf.field_lengths[keep]
        docids = pf.block_docids.reshape(-1)
        tfs = pf.block_tfs.reshape(-1)
        # each block's term (-1 for a block no term owns)
        count = pf.term_block_count.astype(np.int64)
        first = np.cumsum(count) - count
        block_term = np.full(pf.num_blocks, -1, np.int64)
        block_term[np.repeat(pf.term_block_start.astype(np.int64) - first,
                             count) + np.arange(int(count.sum()))] = \
            np.repeat(np.arange(len(pf.terms), dtype=np.int64), count)
        block_term = np.repeat(block_term, BLOCK_SIZE)
        real = (tfs > 0) & seg.live[docids] & (block_term >= 0)
        parts.append((pf.terms, block_term[real], m[docids[real]],
                      tfs[real]))
    used = set()
    for terms, local, _, _ in parts:
        used.update(map(terms.__getitem__, np.unique(local).tolist()))
    new_terms = sorted(used)
    tindex = {t: i for i, t in enumerate(new_terms)}
    term_of = np.concatenate(
        [np.fromiter(map(tindex.get, terms, itertools.repeat(-1)),
                     np.int64, len(terms))[local]
         for terms, local, _, _ in parts]) if parts else np.zeros(0, np.int64)
    doc_of = (np.concatenate([d for _, _, d, _ in parts]) if parts
              else np.zeros(0, np.int64))
    tf = (np.concatenate([t for _, _, _, t in parts]) if parts
          else np.zeros(0, np.float32))
    order = np.argsort(term_of, kind="stable")
    return _postings_of(f, new_terms, term_of[order],
                        doc_of[order].astype(np.int32),
                        tf[order].astype(np.float32), lengths)


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
