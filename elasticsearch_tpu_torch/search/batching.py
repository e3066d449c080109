"""Continuous batching of plan-path and kNN launches (counterpart of
elasticsearch_tpu/search/batching.py `PlanBatcher` and `KnnBatcher`).

Concurrent requests whose bound plans share a launch shape coalesce into
one batched launch (ops/plan.py plan_topk_batch) and one device-to-host
readback.

Leader/follower protocol (no background thread): the first request to
arrive for a signature leads; later arrivals queue behind it. The leader
waits for a launch slot and takes the whole queue with it; whoever
arrives after the pop leads the next cohort. Before its launch a cohort
also waits for room under a limit on the lanes in flight, which bounds
the device memory that concurrent cohorts hold. Under load a cohort grows
with the launch latency, plus an explicit wait (a fraction of the
measured round trip when the device is slow, else a short flush window)
taken only when other requests are pending: a query that arrives alone
runs alone with no added wait.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import plan as plan_ops
from elasticsearch_tpu_torch.ops import vector as vec_ops
from elasticsearch_tpu_torch.ops.device import readback
from elasticsearch_tpu_torch.search.plan import (BoundPlan, empty_result,
                                                 execute_bound)

_Q_BUCKETS = (1, 2, 4, 8, 16, 32)
MAX_BATCH = _Q_BUCKETS[-1]
# cohorts in flight at once (their host work overlaps); waiting for a
# slot is the batching window that grows cohorts under load
MAX_CONCURRENT = 8
# lanes (Q bucket x padded width x 128, summed over streams) of the
# cohorts in flight at once, the memory admission limit: a launch keeps
# about 212 B a lane live at its peak (PERF.md, H100), so 2^27 lanes hold
# near 29 GB beside the resident segments. A cohort that would pass it
# launches in smaller Q chunks; only one query wider than the limit runs
# past it, alone.
MAX_LANES_IN_FLIGHT = 1 << 27
# on a fast device a leader that sees other work pending holds the pop
# this long so the cohort fills
ADAPTIVE_FLUSH_S = 0.002


def _q_bucket(n: int) -> int:
    for b in _Q_BUCKETS:
        if n <= b:
            return b
    return _Q_BUCKETS[-1]


# NB coalescing tiers: plans whose per-stream selection widths land in
# the same power-of-FOUR tier share a signature, and a cohort pads every
# member to its widest member's width, so slightly different widths (the
# common mix) share one launch. Power of four bounds the padding to 4x
# for the narrowest member of a cohort.
_NB_TIER_FLOOR = 64


def _nb_tier(n: int) -> int:
    t = _NB_TIER_FLOOR
    while t < n:
        t *= 4
    return t


class _Entry:
    __slots__ = ("bp", "event", "result", "error")

    def __init__(self, bp: BoundPlan):
        self.bp = bp
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class PlanBatcher:
    """Signature-bucketed batcher for plan launches.

    A signature is (segment, live version, per-stream corpus identity,
    shard-level average length and width tier, group-table size,
    combine, k, dense-mask identity, k1, b), so a cohort is homogeneous;
    Q pads to a power of two (the padding rows repeat the first member).
    The reference keys no average length: a cohort spanning a refresh
    would score a member with the other's."""

    def __init__(self):
        self._lock = threading.Lock()
        self._launch_slots = threading.BoundedSemaphore(MAX_CONCURRENT)
        self._admit = threading.Condition()
        self._lanes_in_flight = 0
        self.peak_lanes_in_flight = 0
        self.admission_waits = 0   # launches that waited for lanes
        self._pending: Dict[tuple, List[_Entry]] = {}
        self.launches = 0          # device launches
        self.batched_queries = 0   # queries served by them
        self.batch_hist: Dict[int, int] = {}   # Q bucket -> launches
        # EMA of launch + readback seconds: a slow device makes leaders
        # wait a fraction of it so cohorts grow; on a fast one the
        # adaptive flush window does (only when other work is pending)
        self._lat_ema = 0.0

    @staticmethod
    def _eligible(bp: BoundPlan, after_score) -> bool:
        """A plan with a per-query dense mask (its own [ND] column) or a
        ``_score`` search_after cursor launches alone."""
        return after_score is None and not bp.empty and bp.dense_mask is None

    @staticmethod
    def _signature(bp: BoundPlan, ctx, k: int, k1: float, b: float) -> tuple:
        # a pruned and an unpruned bind of one query may share a
        # signature and a cohort: each row launches its own selection and
        # gets its own packed result, and the lower-bound flag stays on
        # the caller's BoundPlan (search/searcher.py reads bp.pruned)
        return (
            ctx.segment.name, ctx.segment.live_version,
            tuple((id(st.block_docids), st.avg_len,
                   _nb_tier(int(st.sel_blocks.shape[0])))
                  for st in bp.streams),
            int(bp.group_kind.shape[0]), bp.combine, k,
            id(bp.dense_mask) if bp.dense_mask is not None else None,
            round(k1, 6), round(b, 6),
        )

    def execute(self, bp: BoundPlan, ctx, k: int, k1: float, b: float,
                after_score: Optional[float] = None):
        """(vals [k], ids [k], total) of ``bp`` on ``ctx``'s segment,
        launched in a cohort with whatever shares its signature, or
        alone when it may not batch (``_eligible``)."""
        if bp.empty:
            return empty_result(k)
        if not self._eligible(bp, after_score):
            return execute_bound(bp, ctx, k, k1, b, after_score)
        sig = self._signature(bp, ctx, k, k1, b)
        entry = _Entry(bp)
        with self._lock:
            q = self._pending.setdefault(sig, [])
            q.append(entry)
            leader = len(q) == 1
        if not leader:
            entry.event.wait()
            if entry.error is not None:
                raise entry.error
            return entry.result
        # leader: while other work is pending, hold the pop until this
        # signature fills a cohort or the window closes
        window = (min(0.75 * self._lat_ema, 1.5)
                  if self._lat_ema > 0.03 else ADAPTIVE_FLUSH_S)
        if window > 0.0:
            deadline = time.monotonic() + window
            step = min(0.02, max(window / 4.0, 0.0005))
            while time.monotonic() < deadline:
                with self._lock:
                    mine = len(self._pending.get(sig, ()))
                    busy = mine > 1 or len(self._pending) > 1
                if mine >= MAX_BATCH or not busy:
                    break
                time.sleep(step)
        with self._launch_slots:
            with self._lock:
                batch = self._pending.pop(sig, [])
            if not batch:
                batch = [entry]
            try:
                step = self._chunk(batch)
                for start in range(0, len(batch), step):
                    chunk = batch[start:start + step]
                    lanes = self._lanes(chunk)
                    self._acquire_lanes(lanes)
                    try:
                        self._run(chunk, ctx, k, k1, b)
                    finally:
                        self._release_lanes(lanes)
            except BaseException as exc:
                for e in batch:
                    if not e.event.is_set():
                        e.error = exc
                        e.event.set()
                raise
        return entry.result

    @staticmethod
    def _row_lanes(batch: List[_Entry]) -> int:
        """Lanes of one row of ``batch``'s launch: the widest member's
        selected blocks times 128, summed over the streams."""
        return 128 * sum(max(int(e.bp.streams[si].sel_blocks.shape[0])
                             for e in batch)
                         for si in range(len(batch[0].bp.streams)))

    @classmethod
    def _lanes(cls, batch: List[_Entry]) -> int:
        """Lanes of ``batch``'s launch: its Q bucket times a row's."""
        return _q_bucket(len(batch)) * cls._row_lanes(batch)

    @classmethod
    def _chunk(cls, batch: List[_Entry]) -> int:
        """Members per launch: MAX_BATCH, or the largest power of two
        whose launch stays within MAX_LANES_IN_FLIGHT (at least 1)."""
        fit = MAX_LANES_IN_FLIGHT // cls._row_lanes(batch)
        return min(MAX_BATCH, 1 << max(fit.bit_length() - 1, 0))

    def _acquire_lanes(self, lanes: int) -> None:
        """Wait until ``lanes`` more fit under MAX_LANES_IN_FLIGHT, or
        nothing else is in flight."""
        with self._admit:
            if (self._lanes_in_flight
                    and self._lanes_in_flight + lanes > MAX_LANES_IN_FLIGHT):
                self.admission_waits += 1
                self._admit.wait_for(
                    lambda: not self._lanes_in_flight
                    or self._lanes_in_flight + lanes <= MAX_LANES_IN_FLIGHT)
            self._lanes_in_flight += lanes
            self.peak_lanes_in_flight = max(self.peak_lanes_in_flight,
                                            self._lanes_in_flight)

    def _release_lanes(self, lanes: int) -> None:
        with self._admit:
            self._lanes_in_flight -= lanes
            self._admit.notify_all()

    @staticmethod
    def _pad1(a: np.ndarray, width: int, fill) -> np.ndarray:
        if a.shape[0] == width:
            return a
        out = np.full(width, fill, a.dtype)
        out[:a.shape[0]] = a
        return out

    def _run(self, batch: List[_Entry], ctx, k: int, k1: float, b: float):
        qn = len(batch)
        bucket = _q_bucket(qn)
        bps = [e.bp for e in batch] + [batch[0].bp] * (bucket - qn)
        proto = bps[0]
        ngpad = int(proto.group_kind.shape[0])
        streams = []
        for si, st in enumerate(proto.streams):
            # every member pads to the WIDEST member's width with the
            # reserved zero block at weight 0: all-zero tfs, so the pads
            # never count for presence or score
            width = max(int(bp.streams[si].sel_blocks.shape[0])
                        for bp in bps)
            zero_block = int(st.block_docids.shape[0]) - 1
            streams.append(st._replace(
                sel_blocks=np.stack([self._pad1(bp.streams[si].sel_blocks,
                                                width, zero_block)
                                     for bp in bps]),
                sel_group=np.stack([self._pad1(bp.streams[si].sel_group,
                                               width, ngpad) for bp in bps]),
                sel_sub=np.stack([self._pad1(bp.streams[si].sel_sub, width,
                                             0) for bp in bps]),
                sel_weight=np.stack([self._pad1(bp.streams[si].sel_weight,
                                                width, 0.0) for bp in bps]),
                sel_const=np.stack([self._pad1(bp.streams[si].sel_const,
                                               width, False) for bp in bps])))
        t0 = time.monotonic()
        packed = plan_ops.plan_topk_batch(
            streams, np.stack([bp.group_kind for bp in bps]),
            np.stack([bp.group_req for bp in bps]),
            np.stack([bp.group_const for bp in bps]), ctx.live,
            [bp.n_must for bp in bps], [bp.n_filter for bp in bps],
            [bp.msm for bp in bps], [bp.bonus for bp in bps],
            [bp.tie for bp in bps], k1=k1, b=b, k=k, combine=proto.combine,
            max_run=max(bp.max_run for bp in bps))
        # ONE readback for the whole cohort (rows are packed buffers)
        rows = readback("search.batching.plan_cohort", packed)
        dt = time.monotonic() - t0
        with self._lock:
            if dt < 5.0:   # first launches (lazy set-up) are outliers
                self._lat_ema = (dt if self._lat_ema == 0.0
                                 else 0.8 * self._lat_ema + 0.2 * dt)
            self.launches += 1
            self.batched_queries += qn
            self.batch_hist[bucket] = self.batch_hist.get(bucket, 0) + 1
        for i, e in enumerate(batch):
            e.result = plan_ops.unpack_result(rows[i], k)
            e.event.set()

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "launches": self.launches,
                "batched_queries": self.batched_queries,
                "avg_batch": (self.batched_queries / self.launches
                              if self.launches else 0.0),
                "batch_hist": {str(kk): v for kk, v
                               in sorted(self.batch_hist.items())},
                "peak_lanes_in_flight": self.peak_lanes_in_flight,
                "admission_waits": self.admission_waits,
            }


# ---------------------------------------------------------------------------
# kNN branch batching
# ---------------------------------------------------------------------------

_CUT_BUCKETS = (128, 256, 512, 1024, 2048, 4096)
# a cohort's [Q, ND] float32 score matrix stays within about 1 GiB beside
# the slab (an 8M x 768 bfloat16 slab holds 12.3 GB): Q <= 2^28 / ND
KNN_SCORE_ELEMS = 1 << 28
# queries a leader takes into one cohort (launched in Q chunks that fit
# KNN_SCORE_ELEMS)
KNN_MAX_BATCH = 64


def _cut_bucket(n: int) -> int:
    for b in _CUT_BUCKETS:
        if n <= b:
            return b
    return _CUT_BUCKETS[-1]


class _KnnEntry:
    __slots__ = ("qvec", "cut", "event", "result", "error")

    def __init__(self, qvec: np.ndarray, cut: int):
        self.qvec = qvec
        self.cut = cut
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class KnnBatcher:
    """Continuous batching of kNN branch launches, the vector analogue
    of :class:`PlanBatcher`: concurrent kNN queries against the same
    slab coalesce into ONE ``ops.vector.knn_nominate_batch`` launch
    ([Q, D] product and batched top-k) and share one packed readback
    (scores and docids as float casts in one float32 buffer). The same
    leader/follower protocol and adaptive flush window as PlanBatcher.

    A signature is (segment name, live version, field, similarity,
    bucketed cut, dims): a cohort shares one slab and one live mask
    (the reference keys on the ids of the tensors, which a freed tensor
    can hand on)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._launch_slots = threading.BoundedSemaphore(MAX_CONCURRENT)
        self._pending: Dict[tuple, List[_KnnEntry]] = {}
        self.launches = 0
        self.batched_queries = 0
        self._lat_ema = 0.0

    def topk(self, ctx, field: str, qvec: np.ndarray,
             cut: int) -> Tuple[np.ndarray, np.ndarray]:
        """Top-``cut`` (scores, docids) of one query vector against the
        ``field`` slab of ``ctx``'s segment (SegmentContext), deletes
        honoured through its live mask. On a quantized slab the
        nominations are re-scored in exact float32 from the segment's
        host vectors. The cut caps at the slab's padded row count."""
        dv = ctx.device.vectors[field]
        nd = int(dv.vectors.shape[0])
        bucket_cut = min(_cut_bucket(cut), nd)
        sig = (ctx.segment.name, ctx.segment.live_version, field,
               dv.similarity, bucket_cut, int(qvec.shape[0]))
        entry = _KnnEntry(np.asarray(qvec, np.float32), cut)
        with self._lock:
            q = self._pending.setdefault(sig, [])
            q.append(entry)
            leader = len(q) == 1
        if not leader:
            entry.event.wait()
            if entry.error is not None:
                raise entry.error
            return self._finish(entry, ctx, field)
        window = (min(0.75 * self._lat_ema, 1.5)
                  if self._lat_ema > 0.03 else ADAPTIVE_FLUSH_S)
        if window > 0.0:
            deadline = time.monotonic() + window
            step = min(0.02, max(window / 4.0, 0.0005))
            while time.monotonic() < deadline:
                with self._lock:
                    mine = len(self._pending.get(sig, ()))
                    busy = (mine > 1 or len(self._pending) > 1
                            or any(len(qq) > 1
                                   for qq in self._pending.values()))
                if mine >= KNN_MAX_BATCH or not busy:
                    break
                time.sleep(step)
        with self._launch_slots:
            with self._lock:
                batch = self._pending.pop(sig, [])
            if not batch:
                batch = [entry]
            try:
                for start in range(0, len(batch), KNN_MAX_BATCH):
                    self._run(batch[start:start + KNN_MAX_BATCH], dv,
                              ctx.device.live, bucket_cut)
            except BaseException as exc:
                for e in batch:
                    if not e.event.is_set():
                        e.error = exc
                        e.event.set()
                raise
        if entry.error is not None:
            raise entry.error
        return self._finish(entry, ctx, field)

    def _run(self, batch: List[_KnnEntry], dv, live, cut: int):
        nd = int(dv.vectors.shape[0])
        cap = max(1, KNN_SCORE_ELEMS // max(nd, 1))
        allowed = max((b for b in _Q_BUCKETS if b <= cap), default=1)
        dev = dv.vectors.device
        for start in range(0, len(batch), allowed):
            chunk = batch[start:start + allowed]
            qn = len(chunk)
            bucket = min(_q_bucket(qn), allowed)
            qs = np.stack([e.qvec for e in chunk]
                          + [chunk[0].qvec] * (bucket - qn))
            t0 = time.monotonic()
            top_s, top_i = vec_ops.knn_nominate_batch(
                torch.from_numpy(qs).to(dev), dv.vectors, dv.sq_norms,
                dv.has_value, live, dv.similarity, cut)
            # ONE packed readback: ids as float casts (exact < 2^24)
            rows = readback("search.batching.knn_cohort", torch.cat(
                [top_s, top_i.to(torch.float32)], dim=1))
            dt = time.monotonic() - t0
            with self._lock:
                if dt < 5.0:
                    self._lat_ema = (dt if self._lat_ema == 0.0
                                     else 0.8 * self._lat_ema + 0.2 * dt)
                self.launches += 1
                self.batched_queries += qn
            for i, e in enumerate(chunk):
                e.result = (rows[i, :cut].copy(),
                            plan_ops.unpack_ids(rows[i, cut:]))
                e.event.set()

    @staticmethod
    def _finish(entry: _KnnEntry, ctx,
                field: str) -> Tuple[np.ndarray, np.ndarray]:
        """The entry's row: the nominated docs that passed, re-scored in
        exact float32 from the host vectors when the slab is quantized,
        ordered by (score desc, docid asc), cut to the entry's cut."""
        scores, ids = entry.result
        ok = np.isfinite(scores)
        scores, ids = scores[ok], ids[ok]
        dv = ctx.device.vectors[field]
        vv = ctx.segment.vectors.get(field)
        if dv.vectors.dtype != torch.float32 and vv is not None:
            valid = ids < vv.vectors.shape[0]
            ids = ids[valid]
            scores = vec_ops.exact_rerank_scores(
                vv.vectors[ids], entry.qvec, dv.similarity)
        order = np.lexsort((ids, -scores))[: entry.cut]
        return scores[order], ids[order]

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "knn_launches": self.launches,
                "knn_batched_queries": self.batched_queries,
                "knn_avg_batch": (self.batched_queries / self.launches
                                  if self.launches else 0.0),
            }
