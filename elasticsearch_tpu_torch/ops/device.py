"""Device-resident segment state (counterpart of elasticsearch_tpu/ops/device.py).

A DeviceSegment uploads a segment's postings blocks, doc lengths and
live mask to the device once; every query then ships only its block ids
and weights.

Shape discipline:
- the doc count pads to a multiple of ``DOC_PAD`` (padded docs are dead
  in the live mask and have doc_len = avg, so no NaN or 0-division);
- one reserved all-zeros postings block sits at index ``num_blocks``:
  query block lists pad with it (weight 0) and bucket to powers of two
  (``block_bucket``), so a selection's width takes O(log) values.

Text and keyword postings upload alike (keyword postings are tf = 1).

Numeric doc values upload as float32 [n_docs_padded] columns with a bool
missing mask (NaN -> 0, padding missing), as the reference's do: range
bounds and sort keys compare in float32, so an epoch-millisecond date
(~1.8e12) is exact only to its float32 spacing of 2^17 ms.

Filter masks (the fast path's bool+filter bodies) are bool columns built
on the host from the postings and uploaded once, in an LRU of
``FILTER_MASK_CACHE_MAX`` entries per DeviceSegment.

Keyword doc values stay on the host; the terms aggregation's collector
reads a per-field ord-major docid permutation (``keyword_ord_major``),
built on first use and kept for the life of the immutable segment.

Dense vectors upload as one [n_docs_padded, dims] slab per field
(``DeviceVectors``, bfloat16 by default; padding rows are zero and have
no value), built in row chunks by ops/vector.py ``prepare_vectors``.

Accounting: every device tensor a DeviceSegment holds belongs to exactly
one of ``HBM_SLAB_CLASSES`` (``hbm_bytes_by_class``), and what it builds
lazily (filter masks, the ord-major permutations, device tables derived
from the postings, the dense-factor masks of cached bound plans) is
charged through ``hbm_sink`` (search/context.py ``DeviceSegmentCache``)
when it is built and released when it leaves, so the node's ``hbm``
breaker holds what the card holds. The reference charges only filter
masks that way: its breaker falls behind its own byte count once an
ord-major permutation is built.
"""

from __future__ import annotations

import threading
from collections import Counter, OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.index.segment import BLOCK_SIZE, Segment
from elasticsearch_tpu_torch.ops.plan import check_packed_id_limit
from elasticsearch_tpu_torch.ops.vector import prepare_vectors
from elasticsearch_tpu_torch.search import profile as _prof
from elasticsearch_tpu_torch.telemetry import flightrecorder as _flight

DOC_PAD = 1024
MIN_BLOCK_BUCKET = 8
# bound-plan cache entries per DeviceSegment (search/searcher.py)
BOUND_PLANS_MAX = 128
# filter-mask cache entries per DeviceSegment; each is one bool column
# of n_docs_padded bytes on the device and the same on the host
FILTER_MASK_CACHE_MAX = 64

# HBM slab classes: the accounting buckets of `GET /_nodes/stats`'s
# engine section (the reference's). Every device tensor of a
# DeviceSegment belongs to exactly one, so
# `sum(hbm_bytes_by_class().values()) == hbm_bytes()` by construction.
HBM_SLAB_CLASSES = ("postings", "norms", "live_mask", "vectors",
                    "doc_values", "ordinals", "filter_masks")

# device -> host copies per call site (see readback)
READBACKS: Counter = Counter()
_readback_lock = threading.Lock()


def readback(site: str, *tensors: torch.Tensor, profile: bool = True):
    """THE device-to-host funnel of the serving path: every transfer of
    a kernel's output to host memory goes through here, counts under its
    stable dotted ``site`` label in ``READBACKS``, lands in the ambient
    flight recorder (site, bytes, duration) and, with ``profile``, in an
    active ``profile: true`` recorder's readback counters. A batcher's
    cohort-wide readback passes ``profile=False``: its bytes ride each
    entry's attribution record instead of the leader's request. Returns
    the numpy array for one input, a tuple for several."""
    fr = _flight.current()
    prof_on = profile and _prof.recording()
    t_prof = _prof.now_ns() if prof_on else 0
    t_fr = fr.clock() if fr is not None else 0.0
    out = tuple(t.cpu().numpy() for t in tensors)
    with _readback_lock:
        READBACKS[site] += 1
    if fr is not None:
        fr.record_readback(site, sum(int(a.nbytes) for a in out),
                           duration_ns=int((fr.clock() - t_fr) * 1e9))
    if prof_on:
        _prof.record_readback(t_prof, *out)
    return out[0] if len(out) == 1 else out


def _tensors(obj):
    """The torch tensors in ``obj`` (a tensor, or tuples, lists and dict
    values of them; anything else holds none)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)


def tensor_bytes(obj) -> int:
    """Bytes of the tensors in ``obj`` (see ``_tensors``)."""
    return sum(int(t.nbytes) for t in _tensors(obj))


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def block_bucket(n: int) -> int:
    """Round a selected-block count up to the next power-of-two bucket."""
    b = MIN_BLOCK_BUCKET
    while b < n:
        b *= 2
    return b


def host_any_mask(pf, terms, nd: int) -> np.ndarray:
    """Host-side any-of term-presence mask over ``nd`` docs: True where
    a doc has a posting (tf > 0) of one of ``terms`` in ``pf``."""
    mask = np.zeros(nd, bool)
    rows = []
    for t in terms:
        tid = pf.term_id(t)
        if tid >= 0:
            s = int(pf.term_block_start[tid])
            rows.append(np.arange(s, s + int(pf.term_block_count[tid]),
                                  dtype=np.int64))
    if rows:
        rows = np.concatenate(rows)
        d = pf.block_docids[rows].reshape(-1)
        tf = pf.block_tfs[rows].reshape(-1)
        ok = tf > 0.0
        mask[d[ok][d[ok] < nd]] = True
    return mask


class DevicePostings:
    """One field's postings on the device, with the reserved zero block."""

    def __init__(self, pf, n_docs_padded: int, device: torch.device,
                 account=None):
        tb = pf.block_docids.shape[0]
        docids = np.concatenate(
            [pf.block_docids, np.zeros((1, BLOCK_SIZE), np.int32)], axis=0)
        tfs = np.concatenate(
            [pf.block_tfs, np.zeros((1, BLOCK_SIZE), np.float32)], axis=0)
        self.block_docids = torch.from_numpy(docids).to(device)
        self.block_tfs = torch.from_numpy(tfs).to(device)
        lens = np.zeros(n_docs_padded, np.float32)
        lens[: len(pf.field_lengths)] = pf.field_lengths
        avg = pf.avg_field_length
        lens[len(pf.field_lengths):] = avg  # padded docs: harmless norm
        self.doc_lens = torch.from_numpy(lens).to(device)
        self.zero_block = tb  # index of the reserved all-zeros block
        self.avg_len = float(avg)
        # the term dictionary stays on the host
        self.term_block_start = pf.term_block_start
        self.term_block_count = pf.term_block_count
        self.doc_freq = pf.doc_freq
        self.host = pf
        self._derived: Dict[object, object] = {}
        self._derived_lock = threading.Lock()
        # the owning DeviceSegment's ``_account`` (None: unaccounted)
        self._account = account
        self.derived_bytes = 0     # device bytes of the derived tables

    def derived(self, key, build):
        """``build()``, computed once per ``key`` and kept for the life
        of these postings: tables derived from the immutable postings
        (block bounds, the fast path's term bounds and hot-term table)
        outlive a live-mask change, which keeps this object. Device
        tensors in the result are charged when it is built (a refused
        charge raises and keeps nothing)."""
        with self._derived_lock:
            if key not in self._derived:
                value = build()
                nbytes = tensor_bytes(value)
                if nbytes and self._account is not None:
                    self._account(nbytes, f"derived[{key}]")
                self.derived_bytes += nbytes
                self._derived[key] = value
            return self._derived[key]

    def select_blocks(self, term_ids, weights) -> Tuple[np.ndarray,
                                                        np.ndarray]:
        """Host-side: term ids + per-term weights -> (block ids, per-block
        weights), padded with the zero block (weight 0) to a power-of-two
        bucket. A term id < 0 (absent here) selects nothing."""
        ids, ws = [], []
        for tid, w in zip(term_ids, weights):
            if tid < 0:
                continue
            start = int(self.term_block_start[tid])
            count = int(self.term_block_count[tid])
            ids.extend(range(start, start + count))
            ws.extend([w] * count)
        n = block_bucket(max(1, len(ids)))
        pad = n - len(ids)
        ids.extend([self.zero_block] * pad)
        ws.extend([0.0] * pad)
        return np.asarray(ids, np.int32), np.asarray(ws, np.float32)

    def block_bounds(self):
        """Per-block (first, last) docids, int64 [TB] each: a block's
        real postings are a docid-ascending prefix (tf = 0 pads sit at
        the end with docid 0), so the masked max is the last docid. The
        plan path's window pruning (search/plan.py) reads them."""
        def build():
            pf = self.host
            lo = pf.block_docids[:, 0].astype(np.int64)
            hi = np.where(pf.block_tfs > 0.0, pf.block_docids,
                          0).max(axis=1).astype(np.int64)
            return lo, hi
        return self.derived("block_bounds", build)


class DeviceVectors:
    """One dense_vector field on the device: ``vectors`` [n_docs_padded,
    dims] (``dtype``; pre-normalized for cosine), ``norms`` and
    ``sq_norms`` float32 [n_docs_padded] (the host norms and their
    float32 squares), ``has_value`` bool [n_docs_padded], ``similarity``
    and ``dims``."""

    def __init__(self, vv, n_docs_padded: int, dtype: torch.dtype,
                 device: torch.device):
        self.vectors, norms = prepare_vectors(
            vv.vectors, vv.similarity, dtype, device, n_docs_padded)
        pad = n_docs_padded - len(norms)
        norms = np.concatenate([norms, np.zeros(pad, np.float32)])
        self.norms = torch.from_numpy(norms).to(device)
        self.sq_norms = torch.from_numpy(
            (norms * norms).astype(np.float32)).to(device)
        self.has_value = torch.from_numpy(np.concatenate(
            [np.asarray(vv.has_value, bool), np.zeros(pad, bool)])).to(device)
        self.similarity = vv.similarity
        self.dims = vv.dims


class DeviceSegment:
    """A segment resident in device memory, built once per (segment,
    device); a refresh swaps whole DeviceSegments. Vector slabs take
    ``vector_dtype`` (the reference's default, bfloat16: an 8M x 768
    float32 slab would not leave room for the rest)."""

    def __init__(self, segment: Segment, device: DeviceLike = None,
                 vector_dtype: torch.dtype = torch.bfloat16):
        self.device = resolve_device(device)
        self.segment = segment
        self.name = segment.name
        self.n_docs = segment.n_docs
        self.n_docs_padded = max(DOC_PAD, round_up(segment.n_docs, DOC_PAD))
        # docids ride device->host readbacks as float32 casts, exact
        # only < 2^24: enforce at build time, not as wraparound later
        check_packed_id_limit(self.n_docs_padded,
                              f"DeviceSegment[{segment.name}]")
        # bound plans of repeated queries (search/searcher.py), keyed by
        # (query, k, allow_prune, live_version): LRU of at most
        # BOUND_PLANS_MAX; a pruned bind is never served to an exact ask
        self._bound_plans: "OrderedDict[tuple, object]" = OrderedDict()
        # key -> the device bytes a cached bound plan holds of its own
        self._bound_bytes: Dict[tuple, int] = {}
        self._bound_lock = threading.Lock()
        self.bound_plan_hits = 0
        self.bound_plan_misses = 0
        self.bound_plan_evictions = 0
        # filter masks: key -> (device bool [n_docs_padded], host copy);
        # re-entrant: a composed mask builds its parts under it
        self._filter_masks: "OrderedDict[tuple, Tuple[torch.Tensor, " \
            "np.ndarray]]" = OrderedDict()
        self._mask_lock = threading.RLock()
        self.filter_mask_hits = 0
        self.filter_mask_misses = 0
        self.filter_mask_evictions = 0
        # the accounting sink (search/context.py DeviceSegmentCache): it
        # charges the lazy builds to the node's hbm breaker; None for a
        # DeviceSegment outside a cache
        self.hbm_sink = None
        # the plan path's pruning back-off (search/plan.py _prune_fields):
        # binds left to skip, and bound passes in a row that pruned
        # nothing
        self._prune_skip = 0
        self._prune_fail = 0
        self.update_live(segment.live)
        self.postings: Dict[str, DevicePostings] = {
            f: DevicePostings(pf, self.n_docs_padded, self.device,
                              self._account)
            for f, pf in segment.postings.items()
        }
        # numeric doc values as dense device columns (range filters,
        # numeric terms, sorts)
        self.numerics: Dict[str, torch.Tensor] = {}
        self.numeric_missing: Dict[str, torch.Tensor] = {}
        for f, nv in segment.numerics.items():
            vals = np.zeros(self.n_docs_padded, np.float64)
            vals[: len(nv.values)] = np.nan_to_num(nv.values, nan=0.0)
            miss = np.ones(self.n_docs_padded, bool)
            miss[: len(nv.missing)] = nv.missing
            self.numerics[f] = torch.from_numpy(
                vals.astype(np.float32)).to(self.device)
            self.numeric_missing[f] = torch.from_numpy(miss).to(self.device)
        self.vectors: Dict[str, DeviceVectors] = {
            f: DeviceVectors(vv, self.n_docs_padded, vector_dtype,
                             self.device)
            for f, vv in segment.vectors.items()
        }
        real = np.zeros(self.n_docs_padded, bool)
        real[: self.n_docs] = True
        # the real (non-padding) docs, and the all-true [1, ND] mask row
        # the dense scorer hands the contribution kernel
        self.all_true = torch.from_numpy(real).to(self.device)
        self.all_docs_row = torch.ones((1, self.n_docs_padded),
                                       dtype=torch.bool, device=self.device)
        # keyword field -> (ord-major docids, term starts) or None
        self._kw_ord_major: Dict[str, Optional[Tuple[torch.Tensor,
                                                     np.ndarray]]] = {}
        self._kw_lock = threading.Lock()

    def keyword_ord_major(self, field: str):
        """(device docid permutation int32 [total], host term_starts
        int64 [n_terms + 1]): every keyword value position of ``field``
        sorted by ord (stably, so docids ascend within a term), the
        layout the terms collector reduces over (ops/aggs.py). Built once
        per immutable segment; None when the field has no values."""
        with self._kw_lock:
            if field in self._kw_ord_major:
                return self._kw_ord_major[field]
            kv = self.segment.keywords.get(field)
            entry = None
            if kv is not None and len(kv.all_ords):
                order = np.argsort(kv.all_ords, kind="stable")
                pos_doc = np.searchsorted(kv.offsets,
                                          np.arange(len(kv.all_ords)),
                                          side="right") - 1
                term_starts = np.searchsorted(
                    kv.all_ords[order],
                    np.arange(len(kv.terms) + 1)).astype(np.int64)
                perm = pos_doc[order].astype(np.int32)
                # charged before the upload: a refusal keeps nothing
                self._account(int(perm.nbytes), f"ordinals[{field}]")
                entry = (torch.from_numpy(perm).to(self.device),
                         term_starts)
            self._kw_ord_major[field] = entry
            return entry

    def bound_plan(self, key: tuple, make):
        """The cached bound plan under ``key``, else ``make()`` cached
        (an LRU of BOUND_PLANS_MAX). A plan's dense-factor mask that no
        other structure of the segment holds is charged while it is
        cached."""
        with self._bound_lock:
            bp = self._bound_plans.get(key)
            if bp is not None:
                self.bound_plan_hits += 1
                self._bound_plans.move_to_end(key)
                return bp
            self.bound_plan_misses += 1
        bp = make()
        mask = getattr(bp, "dense_mask", None)
        nbytes = 0
        if isinstance(mask, torch.Tensor) and \
                mask.data_ptr() not in self._held_ptrs():
            nbytes = int(mask.nbytes)
        released = 0
        with self._bound_lock:
            if key in self._bound_plans:     # a racer cached it first
                return self._bound_plans[key]
            if nbytes:
                self._account(nbytes, "bound_plan")
            self._bound_plans[key] = bp
            self._bound_bytes[key] = nbytes
            while len(self._bound_plans) > BOUND_PLANS_MAX:
                old, _ = self._bound_plans.popitem(last=False)
                released += self._bound_bytes.pop(old)
                self.bound_plan_evictions += 1
        if released:
            self._account(-released, "bound_plan")
        return bp

    def _cached_mask(self, key: tuple, make):
        """The (device, host) mask under ``key``, else ``make()`` -> host
        mask, charged, uploaded and cached (LRU of
        FILTER_MASK_CACHE_MAX). The charge comes before the upload: a
        refused one (CircuitBreakingException) leaves nothing on the
        device and nothing cached."""
        with self._mask_lock:
            hit = self._filter_masks.get(key)
            if hit is not None:
                self.filter_mask_hits += 1
                self._filter_masks.move_to_end(key)
                return hit
            self.filter_mask_misses += 1
            host = make()
            self._account(int(host.nbytes), "filter_mask")
            entry = (torch.from_numpy(host).to(self.device), host)
            self._filter_masks[key] = entry
            while len(self._filter_masks) > FILTER_MASK_CACHE_MAX:
                _k, (evicted, _h) = self._filter_masks.popitem(last=False)
                self.filter_mask_evictions += 1
                self._account(-int(evicted.nbytes), "filter_mask")
            return entry

    def filter_mask(self, field: str, terms):
        """Any-of ``terms`` presence mask of ``field``: (device bool
        [n_docs_padded], host copy), cached."""
        key = (field, tuple(sorted(set(terms))))
        dp = self.postings.get(field)
        return self._cached_mask(key, lambda: (
            host_any_mask(dp.host, key[1], self.n_docs_padded)
            if dp is not None else np.zeros(self.n_docs_padded, bool)))

    def composed_filter_mask(self, conversions):
        """AND of the filter masks of a whole filter SET (``conversions``:
        [(field, terms, negate)]), itself cached: (device, host)."""
        key = ("composed", tuple(sorted(
            (f, tuple(sorted(set(t))), bool(neg))
            for f, t, neg in conversions)))

        def make():
            host = None
            for fname, terms, negate in key[1]:
                hm = self.filter_mask(fname, terms)[1]
                hm = ~hm if negate else hm
                host = hm.copy() if host is None else (host & hm)
            return host

        return self._cached_mask(key, make)

    def update_live(self, live_host: np.ndarray) -> None:
        """Upload a new live mask (a delete replaces the segment's mask,
        of the same size; the postings stay resident)."""
        live = np.zeros(self.n_docs_padded, bool)
        live[: self.n_docs] = live_host
        self.live = torch.from_numpy(live).to(self.device)

    # ------------------------------------------------------- accounting
    def _account(self, delta: int, label: str) -> None:
        """Charge (``delta`` > 0) or release device bytes through the
        owning cache's hbm breaker; a refused charge raises
        CircuitBreakingException. No-op for a standalone segment."""
        sink = self.hbm_sink
        if sink is not None and delta:
            sink.account_filter_mask(self, delta, label)

    def _fixed_tensors(self):
        """(class, tensor) of every tensor built with the segment."""
        yield "live_mask", self.live
        yield "live_mask", self.all_true
        yield "live_mask", self.all_docs_row
        for dp in self.postings.values():
            yield "postings", dp.block_docids
            yield "postings", dp.block_tfs
            yield "norms", dp.doc_lens
        for dv in self.vectors.values():
            for t in (dv.vectors, dv.norms, dv.sq_norms, dv.has_value):
                yield "vectors", t
        for f, col in self.numerics.items():
            yield "doc_values", col
            yield "doc_values", self.numeric_missing[f]

    def _held_ptrs(self) -> set:
        """Data pointers of the tensors the segment holds outside its
        bound plans (a dense-factor mask that is one of them is not the
        plan's own)."""
        ptrs = {t.data_ptr() for _c, t in self._fixed_tensors()}
        with self._mask_lock:
            ptrs.update(m.data_ptr() for m, _h in
                        self._filter_masks.values())
        return ptrs

    def hbm_bytes_by_class(self) -> Dict[str, int]:
        """Device-resident bytes per slab class (HBM_SLAB_CLASSES):
        ``postings`` the block arrays and the device tables derived from
        them; ``norms`` the per-doc field lengths; ``live_mask`` the
        live mask and the real-doc masks beside it; ``vectors`` the
        slabs with their norms and value masks; ``doc_values`` the
        numeric columns and their missing masks; ``ordinals`` the lazy
        keyword ord-major permutations; ``filter_masks`` the cached
        filter columns and the cached bound plans' own dense-factor
        masks (so eviction visibly returns bytes)."""
        out = dict.fromkeys(HBM_SLAB_CLASSES, 0)
        for cls, t in self._fixed_tensors():
            out[cls] += int(t.nbytes)
        for dp in self.postings.values():
            out["postings"] += dp.derived_bytes
        with self._kw_lock:
            out["ordinals"] = sum(int(e[0].nbytes) for e in
                                  self._kw_ord_major.values()
                                  if e is not None)
        with self._mask_lock:
            out["filter_masks"] = sum(int(m.nbytes) for m, _h in
                                      self._filter_masks.values())
        with self._bound_lock:
            out["filter_masks"] += sum(self._bound_bytes.values())
        return out

    def hbm_bytes(self) -> int:
        """Total device-resident bytes: BY CONSTRUCTION the sum of
        ``hbm_bytes_by_class()``."""
        return sum(self.hbm_bytes_by_class().values())

    def cache_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-segment device-cache counters (the reference's filter-mask
        and bound-plan caches)."""
        with self._mask_lock:
            fm = {"hits": self.filter_mask_hits,
                  "misses": self.filter_mask_misses,
                  "evictions": self.filter_mask_evictions,
                  "entries": len(self._filter_masks),
                  "bytes": sum(int(m.nbytes) for m, _h in
                               self._filter_masks.values())}
        with self._bound_lock:
            bp = {"hits": self.bound_plan_hits,
                  "misses": self.bound_plan_misses,
                  "evictions": self.bound_plan_evictions,
                  "entries": len(self._bound_plans)}
        return {"filter_mask": fm, "bound_plan": bp}
