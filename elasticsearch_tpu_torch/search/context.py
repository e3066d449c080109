"""Search execution context (counterpart of
elasticsearch_tpu/search/context.py): shard-level term statistics and the
per-segment device state a query runs against.

Queries compile against SHARD-level statistics (Lucene computes idf and
the average field length over the whole IndexSearcher, so a score does
not depend on which segment holds the doc) and execute per segment on a
device-resident DeviceSegment.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

import torch

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.index.segment import Segment
from elasticsearch_tpu_torch.ops.device import HBM_SLAB_CLASSES, DeviceSegment

logger = logging.getLogger(__name__)


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

    def keyword_ord_column(self, field: str):
        """(float32 first-ordinal column, bool missing) [n_docs_padded]
        of a keyword field, or None (ops/device.py
        ``DeviceSegment.keyword_ord_column``): ordinals are
        segment-local, so they order docs within this segment only."""
        return self.device.keyword_ord_column(field)


class DeviceSegmentCache:
    """The node's device-resident segments, least recently used first.

    Segments are immutable except their live mask, so an entry is keyed
    by segment name and holds the ``live_version`` it was built or last
    updated at: a delete re-uploads the live mask only. A new segment
    object under a known name replaces the entry (its old charge is
    released); segments a merge retires leave through ``evict``. Vector
    slabs upload as ``vector_dtype`` (bfloat16 by default, as the
    reference's).

    Device memory is accounted to the ``hbm`` breaker once one is wired
    (``set_breaker``): a segment's bytes when it is admitted, its lazy
    builds as they are built (ops/device.py ``DeviceSegment._account``).
    An admission past the limit first evicts least-recently-used
    residents; only when that cannot free enough does the breaker trip,
    with a CircuitBreakingException (a 429) and nothing kept. Eviction
    listeners (``add_evict_listener``) hear the names evicted, so nothing
    else pins an evicted segment. They run on a thread of their own
    (``_hear``), never on the thread that evicted: that one may hold a
    segment's locks (a lazy build charges under them) or a listener's
    own (the fast path registers under its locks), and a listener that
    waited for those would deadlock. ``wait_evictions_heard`` waits for
    them.

    Lock order: a DeviceSegment's own locks, then this cache's. The
    stats read a segment's classes outside this cache's lock. The
    listeners' lock (``_heard``) is taken last and held over no call."""

    def __init__(self, device: DeviceLike = None,
                 vector_dtype: torch.dtype = torch.bfloat16, breaker=None):
        self.device = resolve_device(device)
        self.vector_dtype = vector_dtype
        # insertion/touch order IS the LRU order eviction walks
        self._cache: "OrderedDict[str, Tuple[int, DeviceSegment]]" = \
            OrderedDict()
        self._lock = threading.Lock()
        # hbm child breaker (utils/breaker.py CircuitBreaker) or None
        self.breaker = breaker
        # segment name -> bytes accounted for it (kept unwired too, so
        # set_breaker charges what is resident)
        self._charged: Dict[str, int] = {}
        self._listeners: List[Callable[[List[str]], None]] = []
        # evicted names the listeners have yet to hear, and the thread
        # that tells them (None while there is nothing to tell)
        self._heard = threading.Condition()
        self._unheard: List[str] = []
        self._hearing: Optional[threading.Thread] = None
        # lifetime counters: segment admissions (uploads), admissions
        # that had to evict an LRU resident, and the accounted peak
        self.admissions = 0
        self.hbm_breaker_evictions = 0
        self.peak_hbm_bytes = 0

    def add_evict_listener(self, fn: Callable[[List[str]], None]) -> None:
        """Call ``fn(names)`` with the names of the segments that an
        admission evicted (not those ``evict`` retires), on the
        listeners' thread."""
        self._listeners.append(fn)

    def set_breaker(self, breaker) -> None:
        """Wire the ``hbm`` child breaker (node start-up), charging what
        is resident already."""
        with self._lock:
            self.breaker = breaker
            if breaker is not None:
                breaker.add_without_breaking(sum(self._charged.values()))

    def _admit_locked(self, nbytes: int, label: str, exclude: str,
                      evicted: List[str]) -> None:
        """Charge the breaker ``nbytes``: past the limit, evict LRU
        residents other than ``exclude`` (their names into ``evicted``)
        until the charge fits; trip only when nothing is left to evict
        (the reference's fielddata eviction interplay, for device
        memory)."""
        br = self.breaker
        if br is None:
            return
        while br.limit >= 0 and \
                (br.used + nbytes) * br.overhead > br.limit:
            victim = next((n for n in self._cache if n != exclude), None)
            if victim is None:
                break
            self._cache.pop(victim)
            br.release(self._charged.pop(victim, 0))
            self.hbm_breaker_evictions += 1
            evicted.append(victim)
        br.add_estimate_bytes_and_maybe_break(nbytes, label)

    def _release_locked(self, name: str) -> None:
        nbytes = self._charged.pop(name, 0)
        if self.breaker is not None:
            self.breaker.release(nbytes)

    def _notify(self, evicted: List[str]) -> None:
        """Queue ``evicted`` for the listeners; start their thread if
        none runs. Takes no lock but ``_heard``, so it is safe under any
        other."""
        if not evicted or not self._listeners:
            return
        with self._heard:
            self._unheard.extend(evicted)
            if self._hearing is not None:
                return
            t = self._hearing = threading.Thread(
                target=self._hear, name="hbm-evict-listeners", daemon=True)
        t.start()

    def _hear(self) -> None:
        """The listeners' thread: tell them every queued name, in
        batches, until none is left; then end."""
        while True:
            with self._heard:
                names, self._unheard = self._unheard, []
                if not names:
                    self._hearing = None
                    self._heard.notify_all()
                    return
            for fn in self._listeners:
                try:
                    fn(names)
                except Exception:   # one listener must not starve the rest
                    logger.exception("hbm eviction listener failed")

    def wait_evictions_heard(self, timeout: Optional[float] = None) -> bool:
        """Block until the listeners have heard every eviction made so
        far; False on timeout. Call it holding no lock of the node."""
        with self._heard:
            return self._heard.wait_for(
                lambda: self._hearing is None and not self._unheard,
                timeout)

    def account_filter_mask(self, dev: DeviceSegment, delta: int,
                            label: str = "filter_mask") -> None:
        """A resident segment's lazy build (``delta`` > 0, through the
        same eviction-first admission as a segment) or release
        (``delta`` < 0). A segment no longer resident (evicted, or
        replaced under its name) is not accounted."""
        evicted: List[str] = []
        try:
            with self._lock:
                entry = self._cache.get(dev.name)
                if entry is None or entry[1] is not dev:
                    return
                if delta >= 0:
                    self._admit_locked(delta, f"{label}[{dev.name}]",
                                       dev.name, evicted)
                elif self.breaker is not None:
                    self.breaker.release(-delta)
                self._charged[dev.name] += delta
                self._note_peak_locked()
        finally:
            self._notify(evicted)

    def _note_peak_locked(self) -> None:
        self.peak_hbm_bytes = max(self.peak_hbm_bytes,
                                  sum(self._charged.values()))

    def get(self, segment: Segment) -> DeviceSegment:
        evicted: List[str] = []
        try:
            with self._lock:
                entry = self._cache.get(segment.name)
                if entry is not None and entry[1].segment is segment:
                    version, dev = entry
                    if version != segment.live_version:
                        dev.update_live(segment.live)
                        self._cache[segment.name] = (segment.live_version,
                                                     dev)
                    self._cache.move_to_end(segment.name)
                    return dev
                if entry is not None:
                    # a new segment object under a known name
                    del self._cache[segment.name]
                    self._release_locked(segment.name)
                # charged AFTER the build (the sizes fall out of it): the
                # build itself overshoots by one segment, as the
                # reference's does
                dev = DeviceSegment(segment, self.device, self.vector_dtype)
                nbytes = dev.hbm_bytes()
                self._admit_locked(nbytes, f"device_segment[{segment.name}]",
                                   segment.name, evicted)
                self._charged[segment.name] = nbytes
                dev.hbm_sink = self
                self.admissions += 1
                self._cache[segment.name] = (segment.live_version, dev)
                self._note_peak_locked()
                return dev
        finally:
            self._notify(evicted)

    def evict(self, names: Iterable[str]) -> None:
        """Drop the device copies of retired segments."""
        with self._lock:
            for name in names:
                if self._cache.pop(name, None) is not None:
                    self._release_locked(name)

    def evict_except(self, names: Set[str]) -> None:
        """Drop every device copy but those of ``names``."""
        with self._lock:
            for name in list(self._cache):
                if name not in names:
                    del self._cache[name]
                    self._release_locked(name)

    def resident(self, name: str) -> Optional[DeviceSegment]:
        """The resident DeviceSegment of ``name``, or None."""
        with self._lock:
            entry = self._cache.get(name)
            return None if entry is None else entry[1]

    def churn_counters(self) -> Tuple[int, int]:
        """(admissions, breaker evictions) lifetime pair: a profiled
        query snapshots it before and after to report the churn of its
        window (node-wide: a concurrent query's uploads land in it)."""
        with self._lock:
            return self.admissions, self.hbm_breaker_evictions

    # -- engine observability (the `engine` stats rollup) -----------------

    def _devices(self, segment_names=None) -> Dict[str, DeviceSegment]:
        with self._lock:
            devs = {name: dev for name, (_v, dev) in self._cache.items()}
        if segment_names is not None:
            devs = {n: d for n, d in devs.items() if n in segment_names}
        return devs

    def hbm_stats(self, segment_names=None) -> Dict[str, object]:
        """Device bytes over the resident DeviceSegments, per slab class.
        ``segment_names=None`` is the node-level view (with the peak,
        the admissions and the breaker evictions)."""
        devs = self._devices(segment_names)
        by_class = dict.fromkeys(HBM_SLAB_CLASSES, 0)
        total = 0
        for dev in devs.values():
            for cls, n in dev.hbm_bytes_by_class().items():
                by_class[cls] += n
                total += n
        out: Dict[str, object] = {"total_bytes": total,
                                  "by_class": by_class,
                                  "segments": len(devs)}
        if segment_names is None:
            with self._lock:
                self.peak_hbm_bytes = max(self.peak_hbm_bytes, total)
                out["peak_bytes"] = self.peak_hbm_bytes
                out["admissions"] = self.admissions
                out["breaker_evictions"] = self.hbm_breaker_evictions
        return out

    def cache_stats(self, segment_names=None) -> Dict[str, object]:
        """The device caches' counters summed over the resident
        DeviceSegments (the filter-mask and bound-plan caches)."""
        agg: Dict[str, Dict[str, int]] = {}
        for dev in self._devices(segment_names).values():
            for cache_name, stats in dev.cache_stats().items():
                bucket = agg.setdefault(cache_name, {})
                for k, v in stats.items():
                    bucket[k] = bucket.get(k, 0) + v
        agg.setdefault("filter_mask", {"hits": 0, "misses": 0,
                                       "evictions": 0, "entries": 0,
                                       "bytes": 0})
        agg.setdefault("bound_plan", {"hits": 0, "misses": 0,
                                      "evictions": 0, "entries": 0})
        return agg

    def engine_stats(self, segment_names=None) -> Dict[str, object]:
        return {"hbm": self.hbm_stats(segment_names),
                "caches": self.cache_stats(segment_names)}
