"""The fast-path lanes of the serving front (counterpart of
elasticsearch_tpu/search/fastpath.py `FastPathServer`: its v2m and v1
lanes, lane routing and filter mask rows).

Request threads put (term ids, filter set, k) on a queue; one drain
thread takes them in COHORTS, routes each query to a lane, assembles the
block selection on the host, launches ONE kernel per cohort of up to
``Q_BATCH`` queries, reads the packed result back once, and re-sorts
each query's hits into (score desc, docid asc). Continuous batching
comes from backpressure: while a cohort runs on the device, new
requests accumulate and drain as a wider cohort.

Lanes, picked per query from its block counts (``route``):
- v2m: ``bm25_topk_total_merge_batch``, the merge of slotted runs,
  ranking in float64, for queries that fit the slot layout;
- v1: ``bm25_topk_total_batch``, one full sort; it takes any selection,
  so the slot misfits ride it at the largest bucket.
The reference's v2 lane (``ops/fastpath.py bm25_candidates_rerank_batch``)
is ported as an op but serves nothing: on the card it is slower than v2m
at the same shape and ranks on the float32 score.
A query needing more blocks than the largest bucket is refused
(``fits`` is False) and the REST layer sends it to the plan path, where
the reference's impact-truncated lane would take it.

Slot layout: a bucket of NB blocks has ``N_SLOTS`` slots of NB/N_SLOTS
blocks; each term instance starts on a slot boundary, so every slot is a
docid-ascending run and the merge kernel can combine them.

Filters: a query may carry a filter SET (sorted term ids of single-term
filters on its field). Each set gets a row of the registration's
persistent mask stack [F_SLOTS, ND] (row 0 = the live mask), holding
live AND the composed filter mask, so filtered and plain queries share
one launch. Nothing is ever answered on another device.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.ops.device import readback as _readback
from elasticsearch_tpu_torch.ops.fastpath import (
    F_SLOTS, bm25_topk_total_batch, bm25_topk_total_merge_batch)
from elasticsearch_tpu_torch.ops.plan import unpack_ids as _unpack_ids
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache

logger = logging.getLogger("elasticsearch_tpu_torch.fastpath")

Q_BATCH = 32      # cohort width (one launch shape per bucket)
# term instances a fast query may have (the C++ front's MAX_TERMS); also
# the slot count: a bucket's slot width is bucket // N_SLOTS blocks
MAX_TERMS = N_SLOTS = 16
MAX_FILTERS = 8   # single-term filters a fast query may carry
NB_BUCKETS = (1024, 2048, 4096)    # block buckets, smallest first
MAX_K = 1000
# float64 ranking: at 2M docs the float32 representation itself is the
# recall floor; reported scores stay float32
SCORE_DTYPE = torch.float64


class SliceUnsupported(Exception):
    """A request outside what this slice of the port serves; the REST
    layer answers it with a typed 400."""

    error_type = "unsupported_in_slice_exception"


class _Pending:
    """One query waiting for its cohort."""

    __slots__ = ("reg", "term_ids", "filt", "k", "lane", "bucket", "done",
                 "result", "error")

    def __init__(self, reg, term_ids, filt, k, lane, bucket):
        self.reg = reg
        self.term_ids = term_ids
        self.filt = filt
        self.k = k
        self.lane = lane
        self.bucket = bucket
        self.done = threading.Event()
        self.result: Optional[Tuple[np.ndarray, np.ndarray, int]] = None
        self.error: Optional[BaseException] = None


class FastPathServer:
    def __init__(self, device: DeviceLike, cache: DeviceSegmentCache):
        """``cache``: the DeviceSegmentCache to take resident segments
        from (the node shares its own with the plan path)."""
        self.device = resolve_device(device)
        self.cache = cache
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._running = False
        self._drain_thread: Optional[threading.Thread] = None
        self._reg_lock = threading.Lock()
        self._regs: Dict[str, dict] = {}
        self._gen = 0
        self.stats = {"cohorts": 0, "fast_queries": 0, "cohorts_v2m": 0,
                      "cohorts_v1": 0}
        # per lane:bucket dispatch counts, the cohort-width histogram
        # (powers of two) and the pad rows of the Q_BATCH-row launches
        self.dispatch: Dict[str, int] = {}
        self.cohort_hist: Dict[int, int] = {}
        self.pad_rows = 0
        self.used_rows = 0
        # host seconds of the drain thread per cohort stage: selection
        # assembly, launch through readback (device work included), and
        # the unpack + re-sort of the readback; on CUDA also the device
        # seconds from a cohort's first upload to its last kernel (CUDA
        # events), so gaps inside one cohort's launches count as busy
        self.timing = {"assemble_s": 0.0, "device_s": 0.0,
                       "finish_s": 0.0, "device_busy_s": 0.0}
        self._stats_lock = threading.Lock()

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self.device.type == "cuda":
            # build the kernels now, not on the first request
            from elasticsearch_tpu_torch.ops._build import build_all
            build_all()
        self._running = True
        self._drain_thread = threading.Thread(
            target=self._drain_loop, name="fastpath-drain", daemon=True)
        self._drain_thread.start()

    def stop(self, timeout: float = 5.0) -> bool:
        """Stop the drain thread; queued requests fail. True when the
        thread exited."""
        self._running = False
        clean = True
        if self._drain_thread is not None:
            self._drain_thread.join(timeout=timeout)
            clean = not self._drain_thread.is_alive()
            self._drain_thread = None
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            p.error = RuntimeError("fast path stopped")
            p.done.set()
        return clean

    # --------------------------------------------------------- telemetry
    def _count_dispatch(self, lane: str, bucket: int, n: int):
        key = f"{lane}:{bucket}"
        with self._stats_lock:
            self.dispatch[key] = self.dispatch.get(key, 0) + n

    def _count_cohort(self, n: int):
        b = 1
        while b < n:
            b *= 2
        with self._stats_lock:
            self.cohort_hist[b] = self.cohort_hist.get(b, 0) + 1
            self.pad_rows += Q_BATCH - n
            self.used_rows += n

    def serving_stats(self) -> dict:
        """Routing telemetry: queries dispatched per lane:bucket, the
        cohort-width histogram, the share of launched rows that were
        padding, and the counters."""
        with self._stats_lock:
            padded = self.pad_rows + self.used_rows
            return {
                "dispatch": dict(self.dispatch),
                "cohort_hist": {str(k): v for k, v in
                                sorted(self.cohort_hist.items())},
                "padding_waste_pct": round(
                    100.0 * self.pad_rows / padded, 1) if padded else 0.0,
                "nb_buckets": list(NB_BUCKETS),
                "counters": dict(self.stats),
            }

    # --------------------------------------------------------- registration
    def register(self, index: str, segment, field: str, k1: float,
                 b: float) -> dict:
        """The registration of ``index`` for its single ``segment``:
        built on first use and whenever the segment or its live mask
        changes (both are replaced, never mutated, on change)."""
        with self._reg_lock:
            reg = self._regs.get(index)
            if (reg is not None and reg["segment"] is segment
                    and reg["live"] is segment.live and reg["field"] == field
                    and reg["k1"] == k1 and reg["b"] == b):
                return reg
            dev = self.cache.get(segment)
            dp = dev.postings[field]
            pf = dp.host
            df = dp.doc_freq.astype(np.float64)
            n = float(pf.doc_count)
            idf = np.log1p((n - df + 0.5) / (df + 0.5))
            starts = dp.term_block_start.astype(np.int64)
            self._gen += 1
            reg = {
                "index": index, "field": field, "segment": segment,
                "live": segment.live, "gen": self._gen, "dev": dev,
                "dp": dp, "k1": float(k1), "b": float(b),
                # per-term idf + block ranges as vectors: per-cohort
                # selection assembly is vectorised numpy
                "idf": idf,
                "nb": dp.term_block_count.astype(np.int64),
                "starts": starts,
                # the persistent mask stack: row 0 = live; rows 1.. hold
                # filter-set columns (_resolve_mask_rows)
                "masks": dev.live.repeat(F_SLOTS, 1),
                "stack_map": {},
                "stack_next": 1,
            }
            self._regs[index] = reg
            logger.info("fastpath registered index=%s field=%s terms=%d",
                        index, field, len(pf.terms))
            return reg

    # -------------------------------------------------------------- routing
    def _v2_bucket(self, reg, term_ids) -> Optional[int]:
        """Smallest bucket whose slot layout fits: each term INSTANCE
        starts on a slot boundary (slot = bucket // N_SLOTS blocks), so
        the fit condition is sum(ceil(blocks_t / slot)) <= N_SLOTS."""
        nbs = reg["nb"]
        cnts = [int(nbs[t]) for t in term_ids if t >= 0]
        if not cnts or len(cnts) > N_SLOTS:
            return None
        for bucket in NB_BUCKETS:
            slot = bucket // N_SLOTS
            if slot == 0:
                continue
            if sum(-(-c // slot) for c in cnts) <= N_SLOTS:
                return bucket
        return None

    def route(self, reg, term_ids: List[int]):
        """(lane, bucket) that serves ``term_ids``: ("empty", None) when
        no term is known (an empty answer, no device work); v2m at the
        smallest bucket whose slot layout fits; else v1 at the largest
        bucket (its one launched shape); None when the blocks need more
        than the largest bucket or the query has more than MAX_TERMS
        known terms."""
        known = [t for t in term_ids if t >= 0]
        if not known:
            return ("empty", None)
        if len(known) > MAX_TERMS:
            return None
        need = int(reg["nb"][known].sum())
        if need > NB_BUCKETS[-1]:
            return None
        b2 = self._v2_bucket(reg, known)
        if b2 is not None:
            return ("v2m", b2)
        return ("v1", NB_BUCKETS[-1])

    def fits(self, reg, term_ids: List[int], k: int) -> bool:
        """True when a fast lane serves (term_ids, k)."""
        return 0 <= k <= MAX_K and self.route(reg, term_ids) is not None

    # --------------------------------------------------------------- search
    def submit(self, reg, term_ids: List[int], k: int,
               filt: Tuple[int, ...] = ()) -> _Pending:
        """Queue one query: term ids into the registered field's term
        dictionary (-1 for unknown terms) and the sorted term ids of its
        single-term filters (-1: the filter matches nothing). Raises
        SliceUnsupported for what no fast lane serves."""
        if not 0 <= k <= MAX_K:
            raise SliceUnsupported(
                f"size [{k}] is outside [0, {MAX_K}] served by the "
                f"fast path")
        if len(filt) > MAX_FILTERS:
            raise SliceUnsupported(f"{len(filt)} filters; the fast path "
                                   f"takes at most {MAX_FILTERS}")
        routed = self.route(reg, term_ids)
        if routed is None:
            known = [t for t in term_ids if t >= 0]
            need = int(reg["nb"][known].sum())
            raise SliceUnsupported(
                f"query of {len(known)} term(s) over {need} postings "
                f"blocks needs more than the fast path's largest bucket "
                f"({NB_BUCKETS[-1]} blocks, {MAX_TERMS} terms); the "
                f"impact-truncated lane that serves it is a later slice "
                f"of the port")
        lane, bucket = routed
        p = _Pending(reg, list(term_ids), tuple(filt), k, lane, bucket)
        if lane == "empty":
            p.result = (np.zeros(0, np.float32), np.zeros(0, np.int32), 0)
            p.done.set()
            return p
        self._queue.put(p)
        return p

    def search(self, reg, term_ids: List[int], k: int,
               filt: Tuple[int, ...] = (), timeout: float = 120.0):
        """(scores float32 [n], docids int32 [n], total) ordered by
        (score desc, docid asc); blocks until the cohort is back."""
        p = self.submit(reg, term_ids, k, filt)
        if not p.done.wait(timeout):
            raise TimeoutError(f"fast path gave no answer in {timeout}s")
        if p.error is not None:
            raise p.error
        return p.result

    # --------------------------------------------------------------- drain
    def _drain_loop(self):
        # drain deep: grouping by lane and bucket before chunking to
        # Q_BATCH fragments a shallow poll across the bucket ladder
        max_n = 8 * Q_BATCH
        while self._running:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            while len(batch) < max_n:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            by_gen: Dict[int, List[_Pending]] = {}
            for p in batch:
                by_gen.setdefault(p.reg["gen"], []).append(p)
            for items in by_gen.values():
                try:
                    self._route_cohort(items)
                except Exception as e:  # the drain thread must never die
                    logger.exception("fastpath routing failed")
                    self._fail(items, e)

    @staticmethod
    def _fail(items: List[_Pending], e: BaseException):
        for p in items:
            if not p.done.is_set():
                p.error = e
                p.done.set()

    def _route_cohort(self, items: List[_Pending]):
        """Launch one registration's drained queries: grouped by lane
        and bucket, small groups folded into the next bucket up, each
        group chunked by the cohort width and the mask-row budget."""
        reg = items[0].reg
        by_lane: Dict[str, Dict[int, List[_Pending]]] = {}
        for p in items:
            by_lane.setdefault(p.lane, {}).setdefault(p.bucket,
                                                      []).append(p)
        for lane in ("v2m", "v1"):
            for bucket, group in self._merge_up(by_lane.get(lane,
                                                            {})).items():
                for chunk in self._chunk_by_slots(group):
                    rows = self._resolve_mask_rows(
                        reg, {p.filt for p in chunk})
                    self._count_dispatch(lane, bucket, len(chunk))
                    self._count_cohort(len(chunk))
                    self._launch(lane, reg, bucket, chunk, rows)

    @staticmethod
    def _merge_up(groups: Dict[int, list]) -> Dict[int, list]:
        """Fold a group of fewer than Q_BATCH / 2 queries into the next
        bigger bucket that has a group (a query that fits a bucket fits
        every bigger one); the largest bucket never carries."""
        merged: Dict[int, list] = {}
        carry: list = []
        for bucket in sorted(groups):
            cur = carry + groups[bucket]
            if (len(cur) < Q_BATCH // 2 and bucket != NB_BUCKETS[-1]
                    and any(b > bucket for b in groups)):
                carry = cur
                continue
            merged.setdefault(bucket, []).extend(cur)
            carry = []
        return merged

    @staticmethod
    def _chunk_by_slots(items: List[_Pending]):
        """Split a launch class into cohorts of at most Q_BATCH queries
        and at most F_SLOTS - 1 distinct filter sets (row 0 is the live
        mask)."""
        chunk: list = []
        filts: set = set()
        for p in items:
            nf = filts | ({p.filt} if p.filt else set())
            if chunk and (len(chunk) >= Q_BATCH or len(nf) > F_SLOTS - 1):
                yield chunk
                chunk = []
                nf = {p.filt} if p.filt else set()
            chunk.append(p)
            filts = nf
        if chunk:
            yield chunk

    # ---------------------------------------------------------- mask rows
    @staticmethod
    def _filter_mask(reg, filt: Tuple[int, ...]):
        """The filter set's composed device mask (from the DeviceSegment's
        LRU), None when a filter term is unknown: the filter matches
        nothing."""
        pf = reg["dp"].host
        terms = []
        for t in filt:
            if not 0 <= t < len(pf.terms):
                return None
            terms.append((reg["field"], (pf.terms[t],), False))
        return reg["dev"].composed_filter_mask(terms)[0]

    def _resolve_mask_rows(self, reg, filts) -> Dict[tuple,
                                                     Optional[int]]:
        """{filter set: row of reg["masks"]} for a cohort's distinct
        filter sets; None for a set with an unknown term (no hits). A
        row holds live AND the set's composed mask, so deleted docs never
        resurface through a filter.

        A new set takes rows 1..F_SLOTS-1 round-robin, never a row
        already resolved for this cohort (its queries would read the
        wrong column); a cohort holds at most F_SLOTS - 1 sets, so a row
        is always free. Rows are assigned only on the drain thread, which
        also launches every cohort, all on one stream: the row is
        written in place, ordered after the launches that read its old
        column and before the one that reads the new."""
        st, smap = reg["masks"], reg["stack_map"]
        out: Dict[tuple, Optional[int]] = {}
        for filt in filts:
            if not filt:
                continue
            row = smap.get(filt)
            if row is None:
                mask = self._filter_mask(reg, filt)
                if mask is None:
                    out[filt] = None
                    continue
                taken = {r for r in out.values() if r is not None}
                taken |= {smap[f] for f in filts if f and f in smap}
                for _ in range(F_SLOTS - 1):
                    row = reg["stack_next"]
                    reg["stack_next"] = 1 + (row % (F_SLOTS - 1))
                    if row not in taken:
                        break
                for old_f, old_r in list(smap.items()):
                    if old_r == row:
                        del smap[old_f]
                torch.logical_and(reg["dev"].live, mask, out=st[row])
                smap[filt] = row
            out[filt] = row
        return out

    # -------------------------------------------------------------- launch
    def _launch(self, lane, reg, bucket, items, rows):
        try:
            self._launch_cohort(lane, reg, bucket, items, rows)
        except Exception as e:      # the drain thread must never die
            logger.exception("fastpath %s cohort failed", lane)
            self._fail(items, e)

    def assemble_cohort(self, reg, bucket: int, queries: List[List[int]],
                        slotted: bool = True):
        """Host-side block selection of one cohort, padded to
        ``Q_BATCH`` rows: sel int32 [Q, bucket] and ws float64 [Q,
        bucket], each term instance starting on a slot boundary when
        ``slotted`` (v2m), back to back otherwise (v1). Unknown terms
        (-1) skip."""
        dp = reg["dp"]
        slot = bucket // N_SLOTS
        sel = np.full((Q_BATCH, bucket), dp.zero_block, np.int32)
        ws = np.zeros((Q_BATCH, bucket), np.float64)
        starts, nbs, idf = reg["starts"], reg["nb"], reg["idf"]
        for qi, term_ids in enumerate(queries):
            pos = 0
            for t in term_ids:
                if t < 0:
                    continue
                cnt = int(nbs[t])
                s = int(starts[t])
                sel[qi, pos:pos + cnt] = np.arange(s, s + cnt,
                                                   dtype=np.int32)
                ws[qi, pos:pos + cnt] = idf[t]
                pos += -(-cnt // slot) * slot if slotted else cnt
        return sel, ws

    def _launch_cohort(self, lane: str, reg, bucket: int,
                       items: List[_Pending], rows):
        dp = reg["dp"]
        t0 = time.perf_counter()
        sel, ws = self.assemble_cohort(
            reg, bucket, [p.term_ids for p in items], slotted=lane != "v1")
        mask_ids = np.zeros(Q_BATCH, np.int32)
        for qi, p in enumerate(items):
            if not p.filt:
                continue
            row = rows.get(p.filt)
            if row is None:     # an unknown filter term: no hits
                sel[qi] = dp.zero_block
                ws[qi] = 0.0
            else:
                mask_ids[qi] = row
        t1 = time.perf_counter()
        dev = self.device
        if dev.type == "cuda":
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()

        def up(a):
            return torch.from_numpy(a).to(dev)

        args = (dp.block_docids, dp.block_tfs)
        tail = (dp.doc_lens, reg["masks"], up(mask_ids))
        if lane == "v2m":
            packed = bm25_topk_total_merge_batch(
                *args, up(sel), up(ws), *tail, dp.avg_len, N_SLOTS,
                reg["k1"], reg["b"], MAX_K, score_dtype=SCORE_DTYPE)
        else:
            packed = bm25_topk_total_batch(
                *args, up(sel), up(ws), *tail, dp.avg_len, reg["k1"],
                reg["b"], MAX_K, score_dtype=SCORE_DTYPE)
        if dev.type == "cuda":
            ev1.record()
        # ONE device->host copy per cohort, through the tracked funnel
        out = _readback(f"search.fastpath.{lane}_cohort", packed)
        t2 = time.perf_counter()
        busy = ev0.elapsed_time(ev1) / 1e3 if dev.type == "cuda" else 0.0
        self._finish(items, out)
        t3 = time.perf_counter()
        with self._stats_lock:
            self.timing["assemble_s"] += t1 - t0
            self.timing["device_s"] += t2 - t1
            self.timing["finish_s"] += t3 - t2
            self.timing["device_busy_s"] += busy
            self.stats["cohorts"] += 1
            self.stats[f"cohorts_{lane}"] += 1
            self.stats["fast_queries"] += len(items)

    @staticmethod
    def _finish(items: List[_Pending], out: np.ndarray):
        """Hand each query its hits from the packed rows ``out`` (one
        per item): the whole cohort in a few numpy calls, then the
        wake-ups (every call that lets go of the GIL hands it to a
        request thread)."""
        kk, n = MAX_K, len(items)
        vals = out[:n, :kk]
        ids = _unpack_ids(out[:n, kk:2 * kk])
        # each query keeps its first k hits of the rail-dtype ranking...
        nhit = np.minimum([p.k for p in items], np.isfinite(vals).sum(1))
        vals = np.where(np.arange(kk) < nhit[:, None], vals, -np.inf)
        # ...in the contract order on the reported float32 score
        order = np.lexsort((ids, -vals), axis=1)
        vals = np.take_along_axis(vals, order, 1)
        ids = np.take_along_axis(ids, order, 1)
        for qi, p in enumerate(items):
            p.result = (vals[qi, :nhit[qi]], ids[qi, :nhit[qi]],
                        int(out[qi, 2 * kk]))
        for p in items:
            p.done.set()
