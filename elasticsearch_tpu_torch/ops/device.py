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

Dense vectors upload as one [n_docs_padded, dims] slab per field
(``DeviceVectors``, bfloat16 by default; padding rows are zero and have
no value), built in row chunks by ops/vector.py ``prepare_vectors``.
"""

from __future__ import annotations

import threading
from collections import Counter, OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.index.segment import BLOCK_SIZE, Segment
from elasticsearch_tpu_torch.ops.plan import check_packed_id_limit
from elasticsearch_tpu_torch.ops.vector import prepare_vectors

DOC_PAD = 1024
MIN_BLOCK_BUCKET = 8
# bound-plan cache entries per DeviceSegment (search/searcher.py)
BOUND_PLANS_MAX = 128
# filter-mask cache entries per DeviceSegment; each is one bool column
# of n_docs_padded bytes on the device and the same on the host
FILTER_MASK_CACHE_MAX = 64

# device -> host copies per call site (see readback)
READBACKS: Counter = Counter()
_readback_lock = threading.Lock()


def readback(site: str, *tensors: torch.Tensor):
    """THE device-to-host funnel of the serving path: every transfer of
    a kernel's output to host memory goes through here and counts under
    its stable dotted ``site`` label in ``READBACKS``. Returns the numpy
    array for one input, a tuple for several."""
    out = tuple(t.cpu().numpy() for t in tensors)
    with _readback_lock:
        READBACKS[site] += 1
    return out[0] if len(out) == 1 else out


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

    def __init__(self, pf, n_docs_padded: int, device: torch.device):
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

    def derived(self, key, build):
        """``build()``, computed once per ``key`` and kept for the life
        of these postings: tables derived from the immutable postings
        (block bounds, the fast path's term bounds and hot-term table)
        outlive a live-mask change, which keeps this object."""
        with self._derived_lock:
            if key not in self._derived:
                self._derived[key] = build()
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
        self._bound_lock = threading.Lock()
        # filter masks: key -> (device bool [n_docs_padded], host copy)
        self._filter_masks: "OrderedDict[tuple, Tuple[torch.Tensor, " \
            "np.ndarray]]" = OrderedDict()
        self._mask_lock = threading.Lock()
        self.filter_mask_hits = 0
        self.filter_mask_misses = 0
        self.filter_mask_evictions = 0
        # the plan path's pruning back-off (search/plan.py _prune_fields):
        # binds left to skip, and bound passes in a row that pruned
        # nothing
        self._prune_skip = 0
        self._prune_fail = 0
        self.update_live(segment.live)
        self.postings: Dict[str, DevicePostings] = {
            f: DevicePostings(pf, self.n_docs_padded, self.device)
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

    def bound_plan(self, key: tuple, make):
        """The cached bound plan under ``key``, else ``make()`` cached."""
        with self._bound_lock:
            bp = self._bound_plans.get(key)
            if bp is not None:
                self._bound_plans.move_to_end(key)
                return bp
        bp = make()
        with self._bound_lock:
            self._bound_plans[key] = bp
            while len(self._bound_plans) > BOUND_PLANS_MAX:
                self._bound_plans.popitem(last=False)
        return bp

    def _cached_mask(self, key: tuple, make):
        """The (device, host) mask under ``key``, else ``make()`` -> host
        mask, uploaded and cached (LRU of FILTER_MASK_CACHE_MAX)."""
        with self._mask_lock:
            hit = self._filter_masks.get(key)
            if hit is not None:
                self.filter_mask_hits += 1
                self._filter_masks.move_to_end(key)
                return hit
            self.filter_mask_misses += 1
        host = make()
        entry = (torch.from_numpy(host).to(self.device), host)
        with self._mask_lock:
            self._filter_masks[key] = entry
            while len(self._filter_masks) > FILTER_MASK_CACHE_MAX:
                self._filter_masks.popitem(last=False)
                self.filter_mask_evictions += 1
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
        """Upload a new live mask (a delete replaces the segment's mask;
        the postings stay resident)."""
        live = np.zeros(self.n_docs_padded, bool)
        live[: self.n_docs] = live_host
        self.live = torch.from_numpy(live).to(self.device)
