"""Search execution context (counterpart of
elasticsearch_tpu/search/context.py): shard-level term statistics and the
per-segment device state a query runs against.

Queries compile against SHARD-level statistics (Lucene computes idf and
the average field length over the whole IndexSearcher, so a score does
not depend on which segment holds the doc) and execute per segment on a
device-resident DeviceSegment.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Tuple

import torch

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.index.segment import Segment
from elasticsearch_tpu_torch.ops.device import DeviceSegment


class ShardStats:
    """Shard-level (cross-segment) field/term statistics for BM25."""

    def __init__(self, segments: List[Segment]):
        self.segments = segments
        self._field_cache: Dict[str, Tuple[int, float]] = {}
        self._df_cache: Dict[Tuple[str, str], int] = {}

    def field_stats(self, field: str) -> Tuple[int, float]:
        """(doc_count_with_field, avg_field_length) across the shard."""
        cached = self._field_cache.get(field)
        if cached is None:
            doc_count = 0
            sum_ttf = 0
            for seg in self.segments:
                pf = seg.postings.get(field)
                if pf is not None:
                    doc_count += pf.doc_count
                    sum_ttf += pf.sum_total_term_freq
            cached = (doc_count, sum_ttf / doc_count if doc_count else 1.0)
            self._field_cache[field] = cached
        return cached

    def doc_freq(self, field: str, term: str) -> int:
        key = (field, term)
        cached = self._df_cache.get(key)
        if cached is None:
            cached = 0
            for seg in self.segments:
                pf = seg.postings.get(field)
                if pf is not None:
                    tid = pf.term_id(term)
                    if tid >= 0:
                        cached += int(pf.doc_freq[tid])
            self._df_cache[key] = cached
        return cached


class SegmentContext:
    """One segment's view for query execution: its device state, the
    index's mapper and the shard's statistics."""

    def __init__(self, segment: Segment, device: DeviceSegment, mapper,
                 stats: ShardStats, k1: float = 1.2, b: float = 0.75):
        self.segment = segment
        self.device = device
        self.mapper = mapper
        self.stats = stats
        self.k1 = k1
        self.b = b

    @property
    def n_docs_padded(self) -> int:
        return self.device.n_docs_padded

    @property
    def live(self):
        return self.device.live

    def all_true(self) -> torch.Tensor:
        """Mask of all real (non-padding) docs."""
        return self.device.all_true

    def numeric_column(self, field: str):
        """(float32 column, bool missing) [n_docs_padded] of a numeric
        field; a field without doc values here is all missing."""
        col = self.device.numerics.get(field)
        if col is None:
            z = torch.zeros(self.n_docs_padded, dtype=torch.float32,
                            device=self.device.device)
            return z, torch.ones_like(z, dtype=torch.bool)
        return col, self.device.numeric_missing[field]


class DeviceSegmentCache:
    """The node's device-resident segments, least recently used first.

    Segments are immutable except their live mask, so an entry is keyed
    by segment name and holds the ``live_version`` it was built or last
    updated at: a delete re-uploads the live mask only. A new segment
    object under a known name replaces the entry; segments a merge
    retires leave through ``evict``. Vector slabs upload as
    ``vector_dtype`` (bfloat16 by default, as the reference's)."""

    def __init__(self, device: DeviceLike = None,
                 vector_dtype: torch.dtype = torch.bfloat16):
        self.device = resolve_device(device)
        self.vector_dtype = vector_dtype
        self._cache: "OrderedDict[str, Tuple[int, DeviceSegment]]" = \
            OrderedDict()
        self._lock = threading.Lock()

    def get(self, segment: Segment) -> DeviceSegment:
        with self._lock:
            entry = self._cache.get(segment.name)
            if entry is not None and entry[1].segment is segment:
                version, dev = entry
                if version != segment.live_version:
                    dev.update_live(segment.live)
                    self._cache[segment.name] = (segment.live_version, dev)
                self._cache.move_to_end(segment.name)
                return dev
            dev = DeviceSegment(segment, self.device, self.vector_dtype)
            self._cache[segment.name] = (segment.live_version, dev)
            return dev

    def evict(self, names: Iterable[str]) -> None:
        """Drop the device copies of retired segments."""
        with self._lock:
            for name in names:
                self._cache.pop(name, None)
