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

The replica fan-out (``PlanBatcher.mesh``, the search service's
parallel/mesh_executor.py MeshSearchBackend): on two or more devices a
cohort with no mask and no script splits its rows evenly over them,
the corpus replicated onto each (a copy only onto another card), each
slice launched with the unsplit launch's widths and ``max_run``, so
every row is the unsplit launch's byte for byte.

Cancellation: a member whose request's task is cancelled while it waits
(its cancellation poll, search/profile.py) leaves the queue when the
cohort has not launched, so its row never launches, or is dropped from
the launched cohort's answers; a cancelled leader still launches the
cohort of the others, without its own row. Either way the member
answers its TaskCancelledException and the cohort answers every other
member as it would have; the cohort's buffers and the segment's
charged masks are the cohort's, and no member holds anything past its
answer.

Attribution: a leader launches under the flight recorder's cohort
annotation (``annotate_launch``: the cohort, its Q bucket and the queue
wait of its oldest member), and the cohort's one packed readback goes
through the funnel with ``profile=False``. An entry whose request runs
``profile: true`` gets its own device record (kernel, buckets, cohort,
batcher wait, padding, readback bytes) when its cohort is back.
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
from elasticsearch_tpu_torch.search import profile as _prof
from elasticsearch_tpu_torch.search.plan import (BoundPlan, empty_result,
                                                 execute_bound, launch_mask)
from elasticsearch_tpu_torch.telemetry import flightrecorder as _flight

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
# how often a follower whose request is cancellable polls its
# cancellation while it waits for its cohort
CANCEL_POLL_S = 0.002


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
    __slots__ = ("bp", "event", "result", "error", "profiled", "t_enq",
                 "t_fr", "meta", "abandoned")

    def __init__(self, bp: BoundPlan):
        self.bp = bp
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        # its request was cancelled while the cohort launched: the
        # leader unpacks no row for it
        self.abandoned = False
        _stamp(self)


def _stamp(entry) -> None:
    """An entry's enqueue stamps: on the profile clock when its request
    is profiled (``meta`` is then filled by the launch), and on the
    ambient flight recorder's clock (the cohort's queue wait)."""
    entry.profiled = _prof.recording()
    entry.t_enq = _prof.now_ns() if entry.profiled else 0
    fr = _flight.current()
    entry.t_fr = fr.clock() if fr is not None else 0.0
    entry.meta = None


def _queue_wait_ns(entries) -> int:
    """The oldest entry's wait, on the ambient flight recorder's clock."""
    fr = _flight.current()
    enq = [e.t_fr for e in entries if e.t_fr]
    return (int(max(0.0, fr.clock() - min(enq)) * 1e9)
            if fr is not None and enq else 0)


def execute_solo(bp: BoundPlan, ctx, k: int, k1: float, b: float,
                 after_score: Optional[float] = None):
    """``execute_bound``: one plan launched alone, with a cohort-of-one
    attribution record when the request is profiled."""
    rec_on = _prof.recording()
    t_l = _prof.now_ns() if rec_on else 0
    out = execute_bound(bp, ctx, k, k1, b, after_score)
    if rec_on and not bp.empty:
        _prof.record_device({
            "kernel": "plan_topk", "cohort": 1, "q_bucket": 1,
            "nb_bucket": max((int(st.sel_blocks.shape[0])
                              for st in bp.streams), default=0),
            "padding_waste_pct": 0.0, "batch_wait_ms": 0.0,
            "launch_ms": round((_prof.now_ns() - t_l) / 1e6, 3)})
    return out


def _record_attribution(entry) -> None:
    """Fold the cohort meta ``_run`` stamped on a profiled entry into its
    request's recorder, with the batcher wait: the time from enqueue to
    the cohort's return, less the launch. The request's readback
    counters get its own row's bytes and the cohort readback's ms."""
    meta = entry.meta
    if meta is None:
        return
    total_ms = max(0.0, (_prof.now_ns() - entry.t_enq) / 1e6)
    rec = dict(meta)
    readback_ms = rec.pop("readback_ms")
    rec["batch_wait_ms"] = round(
        max(0.0, total_ms - float(rec.get("launch_ms", 0.0))), 3)
    _prof.record_device(rec)
    _prof.add("readback_bytes", rec["readback_bytes"])
    _prof.add("readback_ms", readback_ms)


class PlanBatcher:
    """Signature-bucketed batcher for plan launches.

    A signature is (segment, live version, per-stream corpus identity,
    shard-level average length and width tier, group-table size,
    combine, k, converted-filter composition, script spec, k1, b), so a
    cohort is homogeneous: one script per cohort, keyed by its source and
    params, and one composed filter mask, keyed by its (field, terms,
    negate) set, never by an object's id, which a freed object hands on;
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
        # the replica fan-out (a MeshSearchBackend, set by the search
        # service): a cohort without a mask or a script splits its rows
        # over the backend's devices when it has two or more
        # (``_launch_split``), and counts here
        self.mesh = None
        self.mesh_cohorts = 0
        # members whose request was cancelled before their cohort
        # launched (no row launched) and while it launched (row dropped)
        self.cancelled_queued = 0
        self.cancelled_in_flight = 0

    @staticmethod
    def _eligible(bp: BoundPlan, after_score) -> bool:
        """A plan with a per-query dense mask (its own [ND] column) or a
        ``_score`` search_after cursor launches alone; a plan whose only
        mask is the segment's cached composed filter mask batches."""
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
            bp.shared_mask, bp.script, round(k1, 6), round(b, 6),
        )

    def execute(self, bp: BoundPlan, ctx, k: int, k1: float, b: float,
                after_score: Optional[float] = None):
        """(vals [k], ids [k], total) of ``bp`` on ``ctx``'s segment,
        launched in a cohort with whatever shares its signature, or
        alone when it may not batch (``_eligible``)."""
        if bp.empty:
            return empty_result(k)
        if not self._eligible(bp, after_score):
            return execute_solo(bp, ctx, k, k1, b, after_score)
        sig = self._signature(bp, ctx, k, k1, b)
        entry = _Entry(bp)
        with self._lock:
            q = self._pending.setdefault(sig, [])
            q.append(entry)
            leader = len(q) == 1
        if not leader:
            self._follow(entry, sig)
            if entry.error is not None:
                raise entry.error
            if entry.profiled:
                _record_attribution(entry)
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
            # a cancelled leader still launches the cohort of the others,
            # without its own row, then answers its cancellation
            cancelled = _prof.cancelled_error()
            if cancelled is not None:
                batch = [e for e in batch if e is not entry]
                with self._lock:
                    self.cancelled_queued += 1
            try:
                # the cohort is everyone's: the leader's own poll must
                # not abort it halfway
                with _prof.cancellable(None):
                    step = self._chunk(batch) if batch else 1
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
        if cancelled is not None:
            raise cancelled
        if entry.profiled:
            _record_attribution(entry)
        return entry.result

    def _follow(self, entry: _Entry, sig: tuple) -> None:
        """A follower waits for its cohort. Under a cancellation poll
        (search/profile.py ``cancellable``) it polls every CANCEL_POLL_S:
        once cancelled it leaves the queue when its cohort has not
        launched yet (its row never launches), else marks itself
        abandoned (the leader unpacks no row for it), and raises."""
        if not _prof.cancel_installed():
            entry.event.wait()
            return
        while not entry.event.wait(CANCEL_POLL_S):
            cancelled = _prof.cancelled_error()
            if cancelled is None:
                continue
            with self._lock:
                q = self._pending.get(sig)
                if q is not None and entry in q:
                    q.remove(entry)
                    self.cancelled_queued += 1
                else:
                    entry.abandoned = True
                    self.cancelled_in_flight += 1
            raise cancelled

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

    @classmethod
    def cohort_args(cls, bps: List[BoundPlan], live):
        """(positional, keyword) arguments of ``plan_topk_batch`` for the
        bound plans ``bps`` (one row each) on the segment whose live
        mask is ``live``: host arrays, every member's selection padded
        to the WIDEST member's width with the reserved zero block at
        weight 0 (all-zero tfs, so the pads never count for presence or
        score); the script is the first member's."""
        proto = bps[0]
        ngpad = int(proto.group_kind.shape[0])
        streams = []
        for si, st in enumerate(proto.streams):
            width = max(int(bp.streams[si].sel_blocks.shape[0])
                        for bp in bps)
            zero_block = int(st.block_docids.shape[0]) - 1

            def stack(name, fill):
                return np.stack([cls._pad1(getattr(bp.streams[si], name),
                                           width, fill) for bp in bps])
            streams.append(st._replace(
                sel_blocks=stack("sel_blocks", zero_block),
                sel_group=stack("sel_group", ngpad),
                sel_sub=stack("sel_sub", 0),
                sel_weight=stack("sel_weight", 0.0),
                sel_const=stack("sel_const", False)))
        args = (streams, np.stack([bp.group_kind for bp in bps]),
                np.stack([bp.group_req for bp in bps]),
                np.stack([bp.group_const for bp in bps]), live,
                [bp.n_must for bp in bps], [bp.n_filter for bp in bps],
                [bp.msm for bp in bps], [bp.bonus for bp in bps],
                [bp.tie for bp in bps])
        return args, dict(combine=proto.combine,
                          max_run=max(bp.max_run for bp in bps),
                          script_fn=proto.script_fn)

    def _run(self, batch: List[_Entry], ctx, k: int, k1: float, b: float):
        qn = len(batch)
        bucket = _q_bucket(qn)
        # the padding rows repeat the first member
        bps = [e.bp for e in batch] + [batch[0].bp] * (bucket - qn)
        args, kw = self.cohort_args(bps, ctx.live)
        # the cohort's one composed filter mask, held for the launch
        kw["dense_mask"] = launch_mask(batch[0].bp, ctx)
        rmesh = None
        if (self.mesh is not None and kw["dense_mask"] is None
                and kw["script_fn"] is None):
            rmesh = self.mesh.replica_mesh_for(bucket)
        any_prof = any(e.profiled for e in batch)
        t0p = _prof.now_ns() if any_prof else 0
        t0 = time.monotonic()
        with _flight.annotate_launch(qn, bucket, _queue_wait_ns(batch)):
            if rmesh is None:
                packed = plan_ops.plan_topk_batch(*args, k1=k1, b=b, k=k,
                                                  **kw)
            else:
                packed = self._launch_split(rmesh, args, kw, k1, b, k)
        # ONE readback for the whole cohort (rows are packed buffers);
        # its bytes ride each profiled entry's record
        t_rb = _prof.now_ns() if any_prof else 0
        rows = readback("search.batching.plan_cohort", packed,
                        profile=False)
        rb_ms = round((_prof.now_ns() - t_rb) / 1e6, 3) if any_prof else 0.0
        dt = time.monotonic() - t0
        with self._lock:
            if dt < 5.0:   # first launches (lazy set-up) are outliers
                self._lat_ema = (dt if self._lat_ema == 0.0
                                 else 0.8 * self._lat_ema + 0.2 * dt)
            self.launches += 1
            self.batched_queries += qn
            self.batch_hist[bucket] = self.batch_hist.get(bucket, 0) + 1
            if rmesh is not None:
                self.mesh_cohorts += 1
        if rmesh is not None:
            self.mesh._dispatch("replica", qn)
        if any_prof:
            launch_ms = round((_prof.now_ns() - t0p) / 1e6, 3)
            widths = [int(st.sel_blocks.shape[1]) for st in args[0]]
            row_slots = sum(widths)
            for e in batch:
                if not e.profiled:
                    continue
                # this plan's own slots of its tier-padded row (the Q
                # bucket's pad rows show as q_bucket against cohort)
                own = sum(int(st.sel_blocks.shape[0])
                          for st in e.bp.streams)
                e.meta = {
                    "kernel": "plan_topk_batch", "cohort": qn,
                    "q_bucket": bucket,
                    **({"mesh_shape": {"replica": rmesh.devices.size}}
                       if rmesh is not None else {}),
                    "nb_bucket": max(widths) if widths else 0,
                    "nb_selected": own,
                    "padding_waste_pct": round(
                        100.0 * (1.0 - own / row_slots), 1)
                    if row_slots else 0.0,
                    "launch_ms": launch_ms,
                    "readback_bytes": int(rows[0].nbytes),
                    "readback_ms": rb_ms,
                }
        for i, e in enumerate(batch):
            if not e.abandoned:
                e.result = plan_ops.unpack_result(rows[i], k)
            e.event.set()

    def _launch_split(self, rmesh, args, kw, k1: float, b: float,
                      k: int) -> torch.Tensor:
        """The cohort's launch with its rows split over the replica
        devices of ``rmesh``: the corpus arrays replicated onto each
        (cached, no copy onto their own device), each slice of rows
        launched there with the unsplit launch's widths and ``max_run``,
        so every row is the unsplit launch's, and the packed slices
        gathered onto the first device. Every slice's inputs go up
        before any launch: an upload waits for its device's stream."""
        mb = self.mesh
        streams, gk, gr, gc, live, nm, nf, ms, bo, ti = args

        def rows(a):
            return mb.shard_rows(rmesh, np.asarray(a))
        sts = [st._replace(
            block_docids=mb.replicated(rmesh, st.block_docids),
            block_tfs=mb.replicated(rmesh, st.block_tfs),
            doc_lens=mb.replicated(rmesh, st.doc_lens),
            sel_blocks=rows(st.sel_blocks), sel_group=rows(st.sel_group),
            sel_sub=rows(st.sel_sub), sel_weight=rows(st.sel_weight),
            sel_const=rows(st.sel_const)) for st in streams]
        lv = mb.replicated(rmesh, live)
        per_row = [rows(a) for a in (gk, gr, gc, nm, nf, ms, bo, ti)]
        outs = []
        for r in range(rmesh.devices.size):
            outs.append(plan_ops.plan_topk_batch(
                [st._replace(**{f: getattr(st, f)[r] for f in (
                    "block_docids", "block_tfs", "doc_lens", "sel_blocks",
                    "sel_group", "sel_sub", "sel_weight", "sel_const")})
                 for st in sts],
                *(a[r] for a in per_row[:3]), lv[r],
                *(a[r] for a in per_row[3:]), k1=k1, b=b, k=k, **kw))
        dst = rmesh.devices.flat[0]
        return torch.cat([o.to(dst, non_blocking=True) for o in outs])

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
                "mesh_cohorts": self.mesh_cohorts,
                "cancelled_queued": self.cancelled_queued,
                "cancelled_in_flight": self.cancelled_in_flight,
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
    __slots__ = ("qvec", "cut", "event", "result", "error", "profiled",
                 "t_enq", "t_fr", "meta")

    def __init__(self, qvec: np.ndarray, cut: int):
        self.qvec = qvec
        self.cut = cut
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        _stamp(self)


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
            if entry.profiled:
                _record_attribution(entry)
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
        if entry.profiled:
            _record_attribution(entry)
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
            any_prof = any(e.profiled for e in chunk)
            t0p = _prof.now_ns() if any_prof else 0
            t0 = time.monotonic()
            with _flight.annotate_launch(qn, bucket, _queue_wait_ns(chunk)):
                top_s, top_i = vec_ops.knn_nominate_batch(
                    torch.from_numpy(qs).to(dev), dv.vectors, dv.sq_norms,
                    dv.has_value, live, dv.similarity, cut)
            # ONE packed readback: ids as float casts (exact < 2^24)
            packed = torch.cat([top_s, top_i.to(torch.float32)], dim=1)
            t_rb = _prof.now_ns() if any_prof else 0
            rows = readback("search.batching.knn_cohort", packed,
                            profile=False)
            rb_ms = (round((_prof.now_ns() - t_rb) / 1e6, 3) if any_prof
                     else 0.0)
            dt = time.monotonic() - t0
            with self._lock:
                if dt < 5.0:
                    self._lat_ema = (dt if self._lat_ema == 0.0
                                     else 0.8 * self._lat_ema + 0.2 * dt)
                self.launches += 1
                self.batched_queries += qn
            if any_prof:
                launch_ms = round((_prof.now_ns() - t0p) / 1e6, 3)
                for e in chunk:
                    if e.profiled:
                        # the bucketed cut columns this entry did not need
                        e.meta = {
                            "kernel": "knn_nominate_batch", "cohort": qn,
                            "q_bucket": bucket, "nb_bucket": cut,
                            "padding_waste_pct": round(
                                100.0 * (1.0 - min(e.cut, cut) / cut), 1)
                            if cut else 0.0,
                            "launch_ms": launch_ms,
                            "readback_bytes": int(rows[0].nbytes),
                            "readback_ms": rb_ms,
                        }
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
