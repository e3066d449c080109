"""The fast-path lanes of the serving front (counterpart of
elasticsearch_tpu/search/fastpath.py `FastPathServer`: its v2m, v1 and
θ-warm essential lanes, lane routing and filter mask rows).

Requests come from two sources: the C++ front (rest/native_http.py,
``attach_front``) parses the hot bodies of its one registered index and
hands them over as arrays of term ids, and request threads (the
front's fallback workers, direct callers) put (term ids, filter set, k)
on a Python queue (``submit``). One drain thread takes both in COHORTS,
routes each query to a lane (array ops over the whole batch), assembles
the block selection on the host (``np.repeat``/``cumsum`` over the term
instances), launches ONE kernel per cohort of up to ``Q_BATCH``
queries, reads the packed result back once, re-sorts each query's hits
into (score desc, docid asc) and answers: through ``es_fast_respond``
for the front's requests, through the waiting thread's event for the
others. Continuous batching comes from backpressure: while a cohort
runs on the device, new requests accumulate and drain as a wider
cohort.

Registration with the front (``register_front``): the node picks the
index (node.py ``Node.refresh_front``), which the drain has it do about
once a second and before each batch the front hands over; its term
dictionary and external ids go to C++ under the registration's
generation. A front request parsed under another generation is bounced
to the fallback workers, which dispatch it through REST as any other
body, as is one that needs more blocks than the largest bucket (the
plan path serves it). Unlike the reference, a segment with deletes
stays eligible (the lanes read the live mask from row 0 of the mask
stack); a new live mask is a new registration and generation.
``retire`` drops the registrations of retired segments.

Lanes, picked per query (``route``, then ``_route_cohort``); a query
that needs more blocks than the largest bucket goes to the plan path:
- ess: a repeat of a query whose exact answer at k = MAX_K left its kth
  score θ (``_finish``): its high-df terms whose block-max bounds sum
  below 0.9·θ are patched per candidate from the hot-term tf table
  instead of sorted (``ops/fastpath.py bm25_essential_dense_topk_batch``).
  The device certificate proves each answer exact; a row that fails it
  is memoised and refires on v2m or v1. θ lives in the registration, so
  a new segment or live mask drops it;
- v2m: ``bm25_topk_total_merge_batch``, the merge of slotted runs,
  ranking in float64, for queries that fit the slot layout;
- v1: ``bm25_topk_total_batch``, one full sort; it takes any selection,
  so the slot misfits ride it at the largest bucket.
Two of the reference's ops are ported but serve nothing: its v2 lane
(``ops/fastpath.py bm25_candidates_rerank_batch``: on the card slower
than v2m at the same shape, and it ranks on the float32 score) and the
essential binary-search patch (``bm25_essential_topk_batch``: on the card
slower than the full-lane launch the router gives the same queries), so
a repeat whose non-essential terms lack a hot-term row stays on its full
lane.

With a ``mesh_backend`` of two or more devices (parallel/
mesh_executor.py; node.py gives the node's) a registration binds a
replica mesh, and its v1 cohorts split their Q_BATCH rows over it: the
postings, lengths and mask stack replicated, one launch a replica
device (the contribution kernel on each), the packed rows gathered onto
the node's device, each row the unsplit launch's.

Slot layout: a bucket of NB blocks has ``N_SLOTS`` slots of NB/N_SLOTS
blocks; each term instance starts on a slot boundary, so every slot is a
docid-ascending run and the merge kernel can combine them.

Filters: a query may carry a filter SET (sorted term ids of single-term
filters on its field). Each set gets a row of the registration's
persistent mask stack [F_SLOTS, ND] (row 0 = the live mask), holding
live AND the composed filter mask, so filtered and plain queries share
one launch. Nothing is ever answered on another device, and a launch
that raises fails its cohort's requests: none is retried elsewhere.
"""

from __future__ import annotations

import ctypes
import logging
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.index.segment import BLOCK_SIZE
from elasticsearch_tpu_torch.ops.device import readback as _readback
from elasticsearch_tpu_torch.ops.fastpath import (
    CAND, F_SLOTS, NE_SLOTS, bm25_essential_dense_topk_batch,
    bm25_topk_total_batch, bm25_topk_total_merge_batch)
from elasticsearch_tpu_torch.ops.plan import build_term_impacts
from elasticsearch_tpu_torch.ops.plan import unpack_ids as _unpack_ids
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.telemetry import flightrecorder as _flight

logger = logging.getLogger("elasticsearch_tpu_torch.fastpath")

Q_BATCH = 32      # cohort width (one launch shape per bucket)
# term instances a fast query may have (the C++ front's MAX_TERMS); also
# the slot count: a bucket's slot width is bucket // N_SLOTS blocks
MAX_TERMS = N_SLOTS = 16
# single-term filters a fast query may carry (the C++ front's MAX_FILTERS)
MAX_FILTERS = 8
NB_BUCKETS = (1024, 2048, 4096)    # block buckets, smallest first
MAX_K = 1000
# float64 ranking: at 2M docs the float32 representation itself is the
# recall floor; reported scores stay float32
SCORE_DTYPE = torch.float64
# essential-union buckets of the θ-warm lanes, smallest first
ESS_BUCKETS = (256, 1024)
# a non-essential term's posting range must be shorter than this (the
# reference's bound, set by its binary-search patch's 21 halvings)
NE_MAX_LEN = 1 << 21
# θ entries and failed-certificate memos kept per registration
THETA_MAX = 100_000
# the longest the drain thread waits in the front's poll; a request put
# on the Python queue wakes it at once (``submit``)
POLL_MS = 50
# seconds between the drain thread's registration checks while no request
# comes from the front (each batch it hands over is checked first)
REGISTRATION_CHECK_S = 1.0
# the hot-term tf table: rows of df >= max(256, ND / 256), hottest first,
# at most DENSE_MAX_ROWS of them and DENSE_MB of device memory; float16
# holds every tf up to 2048 exactly
DENSE_MAX_ROWS = 512
DENSE_MB = 512
DENSE_F16_MAX_TF = 2048


class SliceUnsupported(Exception):
    """A request outside what this slice of the port serves; the REST
    layer answers it with a typed 400."""

    error_type = "unsupported_in_slice_exception"


class _Pending:
    """One query waiting for its cohort: a request of the C++ front
    (``token`` set; answered through the front) or of a Python thread
    (waiting on ``done``)."""

    __slots__ = ("reg", "term_ids", "filt", "k", "lane", "bucket", "ess",
                 "done", "result", "error", "token", "t0")

    def __init__(self, reg, term_ids, filt, k, lane, bucket, token=None,
                 t0=0.0):
        self.reg = reg
        self.term_ids = term_ids
        self.filt = filt
        self.k = k
        self.lane = lane
        self.bucket = bucket
        self.ess = None         # the essential split (_essential_split)
        self.token = token
        self.t0 = t0            # when the drain took it (front requests)
        self.done = threading.Event() if token is None else None
        self.result: Optional[Tuple[np.ndarray, np.ndarray, int]] = None
        self.error: Optional[BaseException] = None


class PollBuffers:
    """The arrays the front's ``es_fast_poll`` fills for the drain: for
    up to ``max_n`` requests their tokens, registration generations,
    sizes k, term counts, term ids [max_n, MAX_TERMS] (-1: a term the
    dictionary lacks; entries past the count are 0), filter counts and
    filter term ids [max_n, MAX_FILTERS]; ``args``, their pointers in the
    call's order."""

    def __init__(self, max_n: int):
        self.max_n = max_n
        self.tokens = np.zeros(max_n, np.uint64)
        self.gens = np.zeros(max_n, np.int32)
        self.ks = np.zeros(max_n, np.int32)
        self.nterms = np.zeros(max_n, np.int32)
        self.tids = np.zeros((max_n, MAX_TERMS), np.int32)
        self.nfilt = np.zeros(max_n, np.int32)
        self.ftids = np.zeros((max_n, MAX_FILTERS), np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self.args = (
            self.tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            *(a.ctypes.data_as(i32p) for a in (
                self.gens, self.ks, self.nterms, self.tids, self.nfilt,
                self.ftids)))


# lane codes of ``FastPathServer.route_rows``
LANE_NONE, LANE_EMPTY, LANE_V2M, LANE_V1 = range(4)
_LANES = {LANE_EMPTY: "empty", LANE_V2M: "v2m", LANE_V1: "v1"}


class FastPathServer:
    def __init__(self, device: DeviceLike, cache: DeviceSegmentCache,
                 flight=None, mesh_backend=None):
        """``cache``: the DeviceSegmentCache to take resident segments
        from (the node shares its own with the plan path); ``flight``:
        the node's flight recorder, ambient on the drain thread;
        ``mesh_backend``: a parallel/mesh_executor.py MeshSearchBackend
        whose replica devices the v1 lane's cohorts split their rows
        over (node.py gives the node's; bound to a registration when it
        is made, None below two devices)."""
        self.device = resolve_device(device)
        self.cache = cache
        self.flight = flight
        self.mesh_backend = mesh_backend
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._running = False
        self._drain_thread: Optional[threading.Thread] = None
        self._reg_lock = threading.RLock()
        self._regs: Dict[str, dict] = {}
        # runs on the cache's listener thread (never under our locks)
        cache.add_evict_listener(self._drop_evicted)
        self._gen = 0
        # the C++ front (attach_front), the callback that keeps its
        # registration current, and the registration it holds.
        # _front_lock orders a change of that registration against the
        # drain's batches: the front serializes a response with the
        # registration it holds, so none may change between a batch's
        # generation check and its answers. Lock order: _front_lock, then
        # _reg_lock.
        self._front = None
        self._refresh_front: Optional[Callable[[], None]] = None
        self._front_lock = threading.Lock()
        self._front_reg: Optional[dict] = None
        # the segment of the front's registration the cache evicted: not
        # registered again until a request re-admits it
        self._front_evicted = None
        self.stats = {"cohorts": 0, "fast_queries": 0, "cohorts_v2m": 0,
                      "cohorts_v1": 0, "cohorts_ess": 0,
                      "cohorts_failed": 0,
                      # θ cache: admission lookups that found / missed a
                      # θ, and θ stored by full-lane answers
                      "theta_hits": 0, "theta_misses": 0,
                      "theta_stores": 0,
                      # essential rows launched, the uncertified ones
                      # refired on a full lane, and the splits that
                      # passed every other condition but kept a
                      # non-essential term without a hot-term row
                      "ess_queries": 0, "ess_refires": 0,
                      "ess_no_dense": 0,
                      # front requests taken from C++, and those sent
                      # back to the fallback workers: all of them, and
                      # those parsed under another registration than the
                      # front's (the rest need more blocks than the
                      # largest bucket)
                      "front_queries": 0, "bounced": 0, "bounced_stale": 0,
                      # v1 cohorts split over the replica devices
                      "mesh_cohorts": 0,
                      # C++ registrations made (their seconds: the
                      # timing's front_register_s)
                      "front_registrations": 0}
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
        # ``front_register_s``: the C++ registrations' seconds, the
        # dictionary and id lists laid out and copied into C++
        self.timing = {"assemble_s": 0.0, "device_s": 0.0,
                       "finish_s": 0.0, "device_busy_s": 0.0,
                       "front_register_s": 0.0}
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

    def attach_front(self, front, refresh: Callable[[], None]):
        """Drain the C++ ``front`` (rest/native_http.py NativeHttpFront)
        too. ``refresh`` keeps the front's registration current (node.py
        ``Node.refresh_front``: it picks the index and calls
        ``register_front`` or ``unregister_front``); the drain calls it
        about once a second and before each batch the front hands over.
        The front stops this server before it frees itself."""
        self._front = front
        self._refresh_front = refresh
        front.fastpath = self

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
        with self._front_lock:
            self._front = None
            self._refresh_front = None
            self._front_reg = None
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

    def _count(self, **deltas):
        with self._stats_lock:
            for key, d in deltas.items():
                self.stats[key] += d

    def serving_stats(self) -> dict:
        """Routing telemetry: queries dispatched per lane:bucket, the
        cohort-width histogram, the share of launched rows that were
        padding, the lanes' settings and the counters."""
        with self._stats_lock:
            padded = self.pad_rows + self.used_rows
            return {
                "dispatch": dict(self.dispatch),
                "cohort_hist": {str(k): v for k, v in
                                sorted(self.cohort_hist.items())},
                "padding_waste_pct": round(
                    100.0 * self.pad_rows / padded, 1) if padded else 0.0,
                "nb_buckets": list(NB_BUCKETS),
                "ess_buckets": list(ESS_BUCKETS),
                "counters": dict(self.stats),
            }

    def front_registration(self) -> Optional[dict]:
        """The registration the C++ front holds, or None."""
        return self._front_reg

    def engine_cache_stats(self) -> dict:
        """The θ cache: admission hits and misses, θ stored, and the
        entries the current registrations hold (a registration's go with
        it when its segment or live mask changes)."""
        with self._reg_lock:
            entries = sum(len(r["theta"]) for r in self._regs.values())
        with self._stats_lock:
            return {"hits": self.stats["theta_hits"],
                    "misses": self.stats["theta_misses"],
                    "stores": self.stats["theta_stores"],
                    "entries": entries}

    # --------------------------------------------------------- registration
    def register(self, index: str, segment, field: str, k1: float,
                 b: float) -> dict:
        """The registration of ``index`` for its single ``segment``:
        built on first use and whenever the segment or its live mask
        changes (both are replaced, never mutated, on change). What
        depends on the postings alone (idf, each term's bound, the
        hot-term table) is built once per resident postings
        (``DevicePostings.derived``), so a delete rebuilds only the θ
        cache and the mask stack."""
        with self._reg_lock:
            reg = self._regs.get(index)
            if (reg is not None and reg["segment"] is segment
                    and reg["live"] is segment.live and reg["field"] == field
                    and reg["k1"] == k1 and reg["b"] == b):
                return reg
            dev = self.cache.get(segment)
            dp = dev.postings[field]
            idf, maxc = dp.derived(("fastpath.term_bounds", float(k1),
                                    float(b)),
                                   lambda: _term_bounds(dp, k1, b))
            dense_tf, dense_rows = dp.derived(
                "fastpath.dense_hot", lambda: _dense_hot(dp, self.device))
            self._gen += 1
            reg = {
                "index": index, "field": field, "segment": segment,
                "live": segment.live, "gen": self._gen, "dev": dev,
                "dp": dp, "k1": float(k1), "b": float(b),
                # per-term idf + block ranges as vectors: per-cohort
                # selection assembly is vectorised numpy
                "idf": idf,
                "nb": dp.term_block_count.astype(np.int64),
                "starts": dp.term_block_start.astype(np.int64),
                "df": dp.doc_freq.astype(np.int64),
                "maxc": maxc,
                "dense_tf": dense_tf,
                "dense_rows": dense_rows,
                "dense_row_of": _row_of(dense_rows, len(dp.host.terms)),
                # (term ids, filter set, k) -> (θ, exact total), and the
                # keys whose certificate failed; both valid for this
                # registration's immutable segment and live mask only
                "theta": {},
                "ess_bad": set(),
                # the persistent mask stack: row 0 = live; rows 1.. hold
                # filter-set columns (_resolve_mask_rows)
                "masks": dev.live.repeat(F_SLOTS, 1),
                "stack_map": {},
                "stack_next": 1,
                # bumped when a row of the stack is written in place: a
                # replica's copy of the stack is keyed on it
                "masks_version": 0,
                # the replica mesh of this registration's v1 cohorts
                "rmesh": (self.mesh_backend.replica_mesh_for(Q_BATCH)
                          if self.mesh_backend is not None else None),
            }
            self._regs[index] = reg
            logger.info("fastpath registered index=%s field=%s terms=%d",
                        index, field, len(dp.host.terms))
            return reg

    def retire(self, names) -> None:
        """Drop every registration whose segment is among the retired
        segment ``names``; when the front holds one, unregister it there
        (the next fast request on that index registers afresh, and the
        next ``register_front`` registers it with the front again)."""
        self._drop(set(names), evicted=False)

    def _drop_evicted(self, names) -> None:
        """Segments the device cache evicted under its hbm breaker (the
        cache's listener thread calls this): drop the registrations that
        hold them, the front's too, so none pins an evicted segment's
        memory. The front's index is not registered again until a
        request through the fallback re-admits it (``register_front``):
        the drain's refresh alone would re-admit it every second."""
        self._drop(set(names), evicted=True)

    def _drop(self, names, evicted: bool) -> None:
        with self._front_lock:
            with self._reg_lock:
                for index, reg in list(self._regs.items()):
                    if reg["segment"].name in names:
                        del self._regs[index]
                front_reg = self._front_reg
                if (front_reg is not None
                        and front_reg["segment"].name in names):
                    self._front_reg = None
                    self._front.unregister()
                    if evicted:
                        self._front_evicted = front_reg["segment"]

    def register_front(self, index: str, segment, field: str, k1: float,
                       b: float) -> None:
        """Make ``field`` of ``index``'s single ``segment`` the front's
        fast index: its registration (``register``) goes to C++ under the
        registration's generation, unless the front holds it already. A
        segment its engine retired meanwhile (``Segment.retired``; its
        ``retire`` waits for this call) is not registered, nor one the
        device cache evicted from the front until it is resident again."""
        with self._front_lock:
            front = self._front
            if front is None or segment.retired:
                return
            if segment is self._front_evicted:
                dev = self.cache.resident(segment.name)
                if dev is None or dev.segment is not segment:
                    return
                self._front_evicted = None
            reg = self.register(index, segment, field, k1, b)
            if reg is self._front_reg:
                return
            t0 = time.perf_counter()
            front.register(reg["gen"], index, field, reg["dp"].host.terms,
                           segment.stored.ids, 10, MAX_K)
            self._front_reg = reg
            with self._stats_lock:
                self.stats["front_registrations"] += 1
                self.timing["front_register_s"] += time.perf_counter() - t0
            logger.info("fastpath front registered index=%s gen=%d",
                        index, reg["gen"])

    def unregister_front(self) -> None:
        """Leave the front no fast index: every body goes to its
        fallback workers."""
        with self._front_lock:
            if self._front is not None and self._front_reg is not None:
                self._front.unregister()
                self._front_reg = None

    # -------------------------------------------------------------- routing
    @staticmethod
    def _block_counts(reg, tids: np.ndarray):
        """(blocks per term instance [n, W], 0 for -1, and known terms
        per row [n]) of term id rows ``tids`` [n, W] (-1: no term)."""
        known = tids >= 0
        cnt = np.zeros(tids.shape, np.int64)
        cnt[known] = reg["nb"][tids[known]]
        return cnt, known.sum(1)

    @staticmethod
    def _slot_buckets(cnt: np.ndarray, nknown: np.ndarray) -> np.ndarray:
        """Per row, the smallest bucket whose slot layout fits, 0 for
        none: each term INSTANCE starts on a slot boundary (slot =
        bucket // N_SLOTS blocks), so the fit condition is
        sum(ceil(blocks_t / slot)) <= N_SLOTS."""
        out = np.zeros(len(cnt), np.int64)
        ok = (nknown > 0) & (nknown <= N_SLOTS)
        for bucket in NB_BUCKETS[::-1]:
            slot = bucket // N_SLOTS
            if slot == 0:
                continue
            out[ok & ((-(-cnt // slot)).sum(1) <= N_SLOTS)] = bucket
        return out

    def _v2_bucket(self, reg, term_ids) -> Optional[int]:
        """``_slot_buckets`` of one query, None for no fit."""
        cnt, nknown = self._block_counts(reg, _term_rows([term_ids]))
        return int(self._slot_buckets(cnt, nknown)[0]) or None

    def route_rows(self, reg, tids: np.ndarray):
        """(lane codes [n], buckets [n]) of a batch of queries, term id
        rows ``tids`` [n, W] (-1: unknown term or padding), as array ops
        over the batch: LANE_EMPTY when no term is known (an empty
        answer, no device work); LANE_V2M at the smallest bucket whose
        slot layout fits; else LANE_V1 at the largest bucket (its one
        launched shape); LANE_NONE (bucket 0) when the blocks need more
        than the largest bucket or a row has more than MAX_TERMS known
        terms (the plan path serves it)."""
        cnt, nknown = self._block_counts(reg, tids)
        v2 = self._slot_buckets(cnt, nknown)
        lane = np.where(v2 > 0, LANE_V2M, LANE_V1)
        lane[(nknown > MAX_TERMS) | (cnt.sum(1) > NB_BUCKETS[-1])] = \
            LANE_NONE
        lane[nknown == 0] = LANE_EMPTY
        bucket = np.where(lane == LANE_V2M, v2,
                          np.where(lane == LANE_V1, NB_BUCKETS[-1], 0))
        return lane, bucket

    def route(self, reg, term_ids: Sequence[int]):
        """(lane, bucket) for one query's ``term_ids`` (``route_rows``):
        ("empty", None), ("v2m", bucket), ("v1", largest bucket), or
        None (the plan path). A repeat may still ride the essential
        lane: the drain thread decides that (``_essential_split``)."""
        lane, bucket = self.route_rows(reg, _term_rows([term_ids]))
        if lane[0] == LANE_NONE:
            return None
        if lane[0] == LANE_EMPTY:
            return ("empty", None)
        return (_LANES[int(lane[0])], int(bucket[0]))

    def fits(self, reg, term_ids: List[int], k: int) -> bool:
        """True when a fast lane serves (term_ids, k)."""
        return 0 <= k <= MAX_K and self.route(reg, term_ids) is not None

    # ------------------------------------------------------ essential split
    def _essential_split(self, reg, p: _Pending, nb_full: int):
        """(ess bucket, essential terms, non-essential terms, their
        bound, θ, exact total) when a cached θ licenses the essential
        lane for ``p``, else None. Term instances partition (a doubled
        term keeps both slots). Conditions, as the reference's attached
        branch: k == MAX_K; a θ stored and no failed certificate; at
        least two known terms; non-essential terms in ascending bound
        order while their bounds sum below 0.9·θ, each shorter than
        NE_MAX_LEN postings, at most NE_SLOTS of them, one term left
        essential; the essential terms' df summing to at most 0.9·CAND
        (so the union fits the candidates and the certificate closes); a
        block reduction of at least 1.25x; an ESS_BUCKETS bucket that
        holds the essential blocks. And, the port's own condition, a
        hot-term row for every non-essential term (the dense patch is the
        only one that serves). Runs on the drain thread only."""
        if p.k != MAX_K:
            return None
        key = (tuple(p.term_ids), p.filt, p.k)
        hit = reg["theta"].get(key)
        if hit is None:
            self._count(theta_misses=1)
            return None
        self._count(theta_hits=1)
        theta, total = hit
        if key in reg["ess_bad"]:
            return None
        known = [t for t in p.term_ids if t >= 0]
        if len(known) < 2:
            return None
        maxc, df = reg["maxc"], reg["df"]
        inst = sorted(known, key=lambda t: float(maxc[t]))
        theta_safe = 0.9 * float(theta)
        ne: List[int] = []
        ess: List[int] = []
        bound = 0.0
        for t in inst:
            mc = float(maxc[t])
            if (len(ne) < NE_SLOTS and len(inst) - len(ne) > 1
                    and bound + mc < theta_safe
                    and int(df[t]) < NE_MAX_LEN):
                ne.append(t)
                bound += mc
            else:
                ess.append(t)
        if not ne:
            return None
        if int(df[ess].sum()) > int(0.9 * CAND):
            return None
        nb_ess = int(reg["nb"][ess].sum())
        if nb_ess * 5 > nb_full * 4:
            return None
        bucket = next((bk for bk in ESS_BUCKETS if nb_ess <= bk), None)
        if bucket is None:
            return None
        if any(t not in reg["dense_rows"] for t in ne):
            self._count(ess_no_dense=1)
            return None
        return (bucket, ess, ne, bound, float(theta), int(total))

    # --------------------------------------------------------------- search
    def submit(self, reg, term_ids: List[int], k: int,
               filt: Tuple[int, ...] = ()) -> _Pending:
        """Queue one query: term ids into the registered field's term
        dictionary (-1 for unknown terms) and the sorted term ids of its
        single-term filters (-1: the filter matches nothing). Raises
        SliceUnsupported for a size or filter count outside the grammar,
        or a query no fast lane serves (``fits`` says which)."""
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
                f"({NB_BUCKETS[-1]} blocks, {MAX_TERMS} terms); the plan "
                f"path serves it")
        lane, bucket = routed
        p = _Pending(reg, list(term_ids), tuple(filt), k, lane, bucket)
        if lane == "empty":
            p.result = _empty_result()
            p.done.set()
            return p
        self._queue.put(p)
        front = self._front
        if front is not None:
            front.wake()        # the drain may be waiting in the poll
        return p

    def search(self, reg, term_ids: List[int], k: int,
               filt: Tuple[int, ...] = (), timeout: float = 120.0):
        """(scores float32 [n], docids int32 [n], exact total) ordered
        by (score desc, docid asc), blocking until the cohort is back."""
        p = self.submit(reg, term_ids, k, filt)
        if not p.done.wait(timeout):
            raise TimeoutError(f"fast path gave no answer in {timeout}s")
        if p.error is not None:
            raise p.error
        return p.result

    # --------------------------------------------------------------- drain
    def _drain_loop(self):
        with _flight.activate(self.flight):
            self._drain()

    def _drain(self):
        # drain deep: grouping by lane and bucket before chunking to
        # Q_BATCH fragments a shallow poll across the bucket ladder
        max_n = 8 * Q_BATCH
        bufs = None
        last_check = 0.0
        while self._running:
            front = self._front
            if front is None:
                try:
                    first = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                self._serve(self._take_queued([first], max_n))
                # an idle drain must not pin the last registration (and
                # through it a segment the device cache evicts)
                del first
                continue
            if bufs is None:
                bufs = PollBuffers(max_n)
            n = front.poll(bufs, POLL_MS)
            now = time.monotonic()
            if n or now - last_check > REGISTRATION_CHECK_S:
                last_check = now
                self._refresh_logged()
            with self._front_lock:
                batch = self._take_queued([], max_n)
                if n:
                    try:
                        batch += self._from_front(bufs, n)
                    except Exception as e:  # the drain must never die
                        logger.exception("fastpath front batch failed")
                        self._fail([_Pending(None, (), (), 0, None, None,
                                             tok)
                                    for tok in bufs.tokens[:n].tolist()],
                                   e)
                self._serve(batch)

    def _refresh_logged(self):
        try:
            self._refresh_front()
        except Exception:   # the drain thread must never die
            logger.exception("fastpath front registration failed")

    def _take_queued(self, batch: List[_Pending], max_n: int):
        while len(batch) < max_n:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return batch

    def _serve(self, batch: List[_Pending]):
        by_gen: Dict[int, List[_Pending]] = {}
        for p in batch:
            by_gen.setdefault(p.reg["gen"], []).append(p)
        for items in by_gen.values():
            try:
                self._route_cohort(items)
            except Exception as e:  # the drain thread must never die
                logger.exception("fastpath routing failed")
                self._fail(items, e)

    def _from_front(self, bufs, n: int) -> List[_Pending]:
        """The ``n`` requests of ``bufs`` (``es_fast_poll``), routed as
        one batch (``route_rows``). Those parsed under another
        generation than the registration's, and those no lane serves,
        are bounced to the fallback workers (REST dispatches them as any
        other body); those with no known term are answered empty at once. Runs under
        ``_front_lock``."""
        front, reg = self._front, self._front_reg
        t0 = time.perf_counter()
        tokens = bufs.tokens[:n].tolist()
        nterms = bufs.nterms[:n]
        tids = np.where(np.arange(MAX_TERMS) < nterms[:, None],
                        bufs.tids[:n], -1)
        if reg is None:
            stale = np.ones(n, bool)
            lanes = buckets = np.full(n, LANE_NONE)
        else:
            stale = bufs.gens[:n] != reg["gen"]
            lanes, buckets = self.route_rows(reg, tids)
            lanes[stale] = LANE_NONE
        if stale.any():
            logger.info("fastpath: %d front request(s) parsed under "
                        "generation(s) %s, the front's registration is %s: "
                        "bounced", int(stale.sum()),
                        sorted(set(bufs.gens[:n][stale].tolist())),
                        None if reg is None else reg["gen"])
        # counted before any answer can reach a client
        self._count(front_queries=n,
                    bounced=int((lanes == LANE_NONE).sum()),
                    bounced_stale=int(stale.sum()))
        rows, nts = tids.tolist(), nterms.tolist()
        ks, nfilt = bufs.ks[:n].tolist(), bufs.nfilt[:n].tolist()
        items = []
        for i, (tok, lane) in enumerate(zip(tokens, lanes.tolist())):
            if lane == LANE_NONE:
                front.bounce(tok)
            elif lane == LANE_EMPTY:
                front.respond(tok, reg["index"].encode(), _NO_IDS,
                              _NO_SCORES, 0,
                              int((time.perf_counter() - t0) * 1e3))
            else:
                filt = (tuple(sorted(bufs.ftids[i, :nfilt[i]].tolist()))
                        if nfilt[i] else ())
                items.append(_Pending(reg, tuple(rows[i][:nts[i]]), filt,
                                      ks[i], _LANES[lane], int(buckets[i]),
                                      tok, t0))
        return items

    def _answered(self, p: _Pending):
        """Hand ``p`` its result or error: through the front for a front
        request, else by waking its thread."""
        if p.token is None:
            p.done.set()
        elif p.error is not None:
            self._front.respond_error(p.token, 500, {"error": {
                "type": "exception",
                "reason": f"{type(p.error).__name__}: {p.error}"},
                "status": 500})
        else:
            v, d, total = p.result
            self._front.respond(
                p.token, p.reg["index"].encode(), np.ascontiguousarray(d),
                np.ascontiguousarray(v, np.float32), total,
                int((time.perf_counter() - p.t0) * 1e3))

    def _fail(self, items: List[_Pending], e: BaseException):
        for p in items:
            if p.result is None and p.error is None:
                p.error = e
                self._answered(p)

    def _route_cohort(self, items: List[_Pending]):
        """Launch one registration's drained queries: a repeat that a
        cached θ licenses rides the essential lane first; then grouped
        by lane and bucket, small groups folded into the next bucket
        up, each group chunked by the cohort width and the mask-row
        budget. Essential cohorts launch first, then v2m and v1."""
        reg = items[0].reg
        by_lane: Dict[str, Dict[int, List[_Pending]]] = {}
        for p in items:
            if p.lane in ("v2m", "v1"):
                known = [t for t in p.term_ids if t >= 0]
                ess = self._essential_split(reg, p,
                                            int(reg["nb"][known].sum()))
                if ess is not None:
                    p.lane, p.bucket, p.ess = "ess", ess[0], ess
            by_lane.setdefault(p.lane, {}).setdefault(p.bucket,
                                                      []).append(p)
        for lane in ("ess", "v2m", "v1"):
            self._launch_groups(reg, lane, by_lane.get(lane, {}))

    def _launch_groups(self, reg, lane: str,
                       groups: Dict[int, List[_Pending]]):
        for bucket, group in self._merge_up(groups).items():
            for chunk in self._chunk_by_slots(group):
                rows = self._resolve_mask_rows(reg, {p.filt for p in chunk})
                self._count_dispatch(lane, bucket, len(chunk))
                self._count_cohort(len(chunk))
                self._launch(lane, reg, bucket, chunk, rows)

    @staticmethod
    def _merge_up(groups: Dict[int, list]) -> Dict[int, list]:
        """Fold a group of fewer than Q_BATCH / 2 queries into the next
        bigger bucket that has a group (a query that fits a bucket fits
        every bigger one); the largest bucket of ``groups`` never
        carries."""
        merged: Dict[int, list] = {}
        carry: list = []
        for bucket in sorted(groups):
            cur = carry + groups[bucket]
            if (len(cur) < Q_BATCH // 2
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
                reg["masks_version"] += 1
                smap[filt] = row
            out[filt] = row
        return out

    # -------------------------------------------------------------- launch
    def _launch(self, lane, reg, bucket, items, rows):
        try:
            self._launch_cohort(lane, reg, bucket, items, rows)
        except Exception as e:      # the drain thread must never die
            logger.exception("fastpath %s cohort failed", lane)
            self._count(cohorts_failed=1)
            self._fail(items, e)

    def assemble_cohort(self, reg, bucket: int, queries,
                        slotted: bool = True):
        """Host-side block selection of one cohort, padded to
        ``Q_BATCH`` rows: sel int32 [Q, bucket] and ws float64 [Q,
        bucket], each term instance starting on a slot boundary when
        ``slotted`` (v2m), back to back otherwise (v1, and the essential
        terms of the ess lane). Unknown terms (-1) skip. ``queries``:
        term id sequences, or their rows [n, W] padded with -1. Array
        ops over every term instance of the cohort: an instance's first
        column is the running sum of the spans before it in its row (its
        block count, rounded up to whole slots when ``slotted``), and
        its blocks are laid out by ``np.repeat``."""
        dp = reg["dp"]
        sel = np.full((Q_BATCH, bucket), dp.zero_block, np.int32)
        ws = np.zeros((Q_BATCH, bucket), np.float64)
        tids = _term_rows(queries)
        qi, ji = np.nonzero(tids >= 0)
        if len(qi) == 0:
            return sel, ws
        t = tids[qi, ji]
        cnt = reg["nb"][t]
        if slotted:
            slot = bucket // N_SLOTS
            span = -(-cnt // slot) * slot
        else:
            span = cnt
        before = np.cumsum(span) - span
        first = np.flatnonzero(np.r_[True, qi[1:] != qi[:-1]])
        col0 = before - np.repeat(before[first],
                                  np.diff(np.r_[first, len(qi)]))
        inst = np.repeat(np.arange(len(t)), cnt)
        within = np.arange(len(inst)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        r, c = qi[inst], col0[inst] + within
        sel[r, c] = reg["starts"][t][inst] + within
        ws[r, c] = reg["idf"][t][inst]
        return sel, ws

    def assemble_essential(self, reg, bucket: int, splits):
        """The essential lane's inputs from each query's split
        (``_essential_split``): the essential terms' blocks back to back,
        and per non-essential slot its hot-term row (-1: unused) and its
        idf, and each row's summed bound. Returns (sel, ws, ne_row,
        ne_idf, ne_bound)."""
        sel, ws = self.assemble_cohort(reg, bucket, [s[1] for s in splits],
                                       slotted=False)
        ne_row = np.full((Q_BATCH, NE_SLOTS), -1, np.int32)
        ne_idf = np.zeros((Q_BATCH, NE_SLOTS), np.float64)
        ne_bound = np.zeros(Q_BATCH, np.float64)
        ne = _term_rows([s[2] for s in splits])
        qi, ji = np.nonzero(ne >= 0)
        t = ne[qi, ji]
        ne_row[qi, ji] = reg["dense_row_of"][t]
        ne_idf[qi, ji] = reg["idf"][t]
        ne_bound[:len(splits)] = [s[3] for s in splits]
        return sel, ws, ne_row, ne_idf, ne_bound

    def _launch_cohort(self, lane: str, reg, bucket: int,
                       items: List[_Pending], rows):
        dp = reg["dp"]
        t0 = time.perf_counter()
        ess_in = None
        if lane == "ess":
            sel, ws, *ess_in = self.assemble_essential(
                reg, bucket, [p.ess for p in items])
        else:
            sel, ws = self.assemble_cohort(
                reg, bucket, [p.term_ids for p in items],
                slotted=lane == "v2m")
        mask_ids = np.zeros(Q_BATCH, np.int32)
        nomatch = []        # rows with an unknown filter term: no hits
        for qi, p in enumerate(items):
            if not p.filt:
                continue
            row = rows.get(p.filt)
            if row is None:     # answered with no hits after the launch
                sel[qi] = dp.zero_block
                ws[qi] = 0.0
                nomatch.append(qi)
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
        k1, b = reg["k1"], reg["b"]
        if lane == "v2m":
            packed = bm25_topk_total_merge_batch(
                *args, up(sel), up(ws), *tail, dp.avg_len, N_SLOTS, k1, b,
                MAX_K, score_dtype=SCORE_DTYPE)
        elif lane == "ess":
            ne_row, ne_idf, ne_bound = ess_in
            packed = bm25_essential_dense_topk_batch(
                *args, reg["dense_tf"], up(sel), up(ws), *tail, up(ne_row),
                up(ne_idf), up(ne_bound), dp.avg_len, k1, b, MAX_K,
                score_dtype=SCORE_DTYPE)
        elif self._mesh_active(reg):
            outs = [bm25_topk_total_batch(
                *ins, dp.avg_len, k1, b, MAX_K, score_dtype=SCORE_DTYPE)
                for ins in self._v1_inputs(reg, sel, ws, mask_ids)]
            packed = torch.cat([o.to(dev, non_blocking=True) for o in outs])
            del outs
        else:
            packed = bm25_topk_total_batch(
                *args, up(sel), up(ws), *tail, dp.avg_len, k1, b, MAX_K,
                score_dtype=SCORE_DTYPE)
        if dev.type == "cuda":
            ev1.record()
        # ONE device->host copy per cohort, through the tracked funnel
        out = _readback(f"search.fastpath.{lane}_cohort", packed)
        # the cohort's device buffers go before its answers: a caller
        # woken by one finds none of them still held on the card
        del packed, tail
        t2 = time.perf_counter()
        busy = ev0.elapsed_time(ev1) / 1e3 if dev.type == "cuda" else 0.0
        refire: List[_Pending] = []
        if lane == "ess":
            answered, refire = self._finish_essential(reg, items, out,
                                                      nomatch)
        else:
            self._finish(items, out, store_theta=True)
            answered = len(items)
        t3 = time.perf_counter()
        split = lane == "v1" and self._mesh_active(reg)
        with self._stats_lock:
            self.timing["assemble_s"] += t1 - t0
            self.timing["device_s"] += t2 - t1
            self.timing["finish_s"] += t3 - t2
            self.timing["device_busy_s"] += busy
            self.stats["cohorts"] += 1
            self.stats[f"cohorts_{lane}"] += 1
            self.stats["fast_queries"] += answered
            if split:
                self.stats["mesh_cohorts"] += 1
        if split:
            self.mesh_backend._dispatch("replica", len(items))
        if refire:
            self._refire(reg, refire)

    def _mesh_active(self, reg) -> bool:
        """The one gate of replica-split v1 cohorts: a replica mesh bound
        at registration and the backend still enabled (the
        ESTPU_MESH_SERVING=0 switch reaches a registered index at
        once)."""
        return (reg.get("rmesh") is not None
                and self.mesh_backend is not None
                and self.mesh_backend.enabled())

    def _v1_inputs(self, reg, sel: np.ndarray, ws: np.ndarray,
                   mask_ids: np.ndarray):
        """The v1 launch's inputs split over the registration's replica
        mesh, one tuple a replica device: the corpus arrays and the mask
        stack replicated (cached by identity, the stack by its version
        too: its rows are written in place), the cohort's rows (all
        Q_BATCH of them, pads included) split evenly. Every slice goes
        up before any launch."""
        dp, rmesh, mb = reg["dp"], reg["rmesh"], self.mesh_backend
        bd, bt, dl = (mb.replicated(rmesh, t) for t in (
            dp.block_docids, dp.block_tfs, dp.doc_lens))
        masks = mb.replicated(rmesh, reg["masks"],
                              version=reg["masks_version"])
        s_, w_, m_ = (mb.shard_rows(rmesh, a) for a in (sel, ws, mask_ids))
        return list(zip(bd, bt, s_, w_, dl, masks, m_))

    def _finish(self, items: List[_Pending], out: np.ndarray,
                store_theta: bool = False, totals=None):
        """Hand each query its hits from the packed rows ``out`` (one
        per item): the whole cohort in a few numpy calls, then the
        wake-ups (every call that lets go of the GIL hands it to a
        request thread). Each query keeps its first k hits of the
        rail-dtype ranking, in the contract order on the reported
        float32 score. ``totals`` replace the packed totals (the
        essential lane's cached exact ones). With ``store_theta`` (a full
        lane's exact answer), a query that fills k = MAX_K stores its kth score
        θ and its total, licensing the essential lane for its repeats."""
        kk, n = MAX_K, len(items)
        vals = out[:n, :kk]
        ids = _unpack_ids(out[:n, kk:2 * kk])
        nhit = np.minimum([p.k for p in items], np.isfinite(vals).sum(1))
        vals = np.where(np.arange(kk) < nhit[:, None], vals, -np.inf)
        order = np.lexsort((ids, -vals), axis=1)
        vals = np.take_along_axis(vals, order, 1)
        ids = np.take_along_axis(ids, order, 1)
        if totals is None:
            totals = out[:n, 2 * kk].astype(np.int64)
        stores = 0
        for qi, p in enumerate(items):
            v = vals[qi, :nhit[qi]]
            p.result = (v, ids[qi, :nhit[qi]], int(totals[qi]))
            theta = p.reg["theta"]
            if (store_theta and p.k == MAX_K and len(v) == MAX_K
                    and len(theta) < THETA_MAX):
                theta[(tuple(p.term_ids), p.filt, p.k)] = (
                    float(v[-1]), int(totals[qi]))
                stores += 1
        if stores:
            self._count(theta_stores=stores)
        for p in items:
            self._answered(p)

    def _finish_essential(self, reg, items: List[_Pending], out,
                          nomatch: List[int]):
        """Certified rows (ok = 1) answer with the cached exact total,
        relation "eq"; rows with an unknown filter term answer no hits;
        the rest are memoised in ``ess_bad`` and returned for a refire.
        Returns (answered, refire)."""
        kk = MAX_K
        ok = out[:len(items), 2 * kk] == 1.0
        nm = set(nomatch)
        done = [qi for qi in range(len(items)) if qi in nm or ok[qi]]
        refire = [p for qi, p in enumerate(items)
                  if qi not in nm and not ok[qi]]
        for p in refire:
            if len(reg["ess_bad"]) < THETA_MAX:
                reg["ess_bad"].add((tuple(p.term_ids), p.filt, p.k))
        self._count(ess_queries=len(items), ess_refires=len(refire))
        if done:
            sub = out[done].copy()
            totals = [0 if qi in nm else items[qi].ess[5] for qi in done]
            sub[[i for i, qi in enumerate(done) if qi in nm], :kk] = -np.inf
            self._finish([items[qi] for qi in done], sub, totals=totals)
        return len(done), refire

    def _refire(self, reg, items: List[_Pending]):
        """Serve uncertified essential rows on the full lane ``route``
        picks (v2m when the slot layout fits, else v1), at once."""
        groups: Dict[str, Dict[int, List[_Pending]]] = {}
        for p in items:
            p.lane, p.bucket = self.route(reg, p.term_ids)
            p.ess = None
            groups.setdefault(p.lane, {}).setdefault(p.bucket, []).append(p)
        for lane in ("v2m", "v1"):
            self._launch_groups(reg, lane, groups.get(lane, {}))


_NO_IDS = np.zeros(0, np.int32)
_NO_SCORES = np.zeros(0, np.float32)


def _empty_result():
    return (_NO_SCORES, _NO_IDS, 0)


def _term_rows(queries) -> np.ndarray:
    """Term id sequences as rows [n, W] padded with -1 (an array of
    rows passes through)."""
    if isinstance(queries, np.ndarray):
        return queries
    width = max(map(len, queries), default=0)
    rows = np.full((len(queries), width), -1, np.int64)
    for i, q in enumerate(queries):
        rows[i, :len(q)] = q
    return rows


def _row_of(dense_rows: Dict[int, int], n_terms: int) -> np.ndarray:
    """The hot-term table's row per term id, -1 for a term it lacks."""
    row_of = np.full(n_terms, -1, np.int32)
    row_of[list(dense_rows)] = list(dense_rows.values())
    return row_of


def _term_bounds(dp, k1: float, b: float):
    """(idf, maxc) float64 [T] of one field's terms: maxc is a term's
    largest BM25 contribution, its best block's bound (ops/plan.py
    ``build_term_impacts``), the essential split's per-term bound. Kept
    in float64: a float32 maxc could round below the block bound the
    certificate needs."""
    pf = dp.host
    df = dp.doc_freq.astype(np.float64)
    n = float(pf.doc_count)
    idf = np.log1p((n - df + 0.5) / (df + 0.5))
    starts = dp.term_block_start.astype(np.int64)
    nb = dp.term_block_count.astype(np.int64)
    impacts = build_term_impacts(starts, nb, pf.block_max_tf,
                                 pf.block_min_len, idf, float(dp.avg_len),
                                 float(k1), float(b))
    maxc = np.zeros(len(pf.terms), np.float64)
    maxc[nb > 0] = impacts.ub_desc[starts[nb > 0]]
    return idf, maxc


def _dense_hot(dp, device):
    """(dense [H, ND] tf table on ``device`` or None, {term id: row}) of
    the hottest terms, the essential lane's patch: rows for the terms of
    df >= max(256, ND / 256), hottest first, at most DENSE_MAX_ROWS and
    DENSE_MB MB; float16 unless a candidate row holds a tf above 2048.
    None only when no term is hot or the budget gives no row; a failed
    build raises."""
    nd = int(dp.doc_lens.shape[0])
    df = dp.doc_freq.astype(np.int64)
    hot = np.nonzero(df >= max(256, nd // 256))[0]
    if len(hot) == 0:
        return None, {}
    hot = hot[np.argsort(-df[hot], kind="stable")][:DENSE_MAX_ROWS]
    pf = dp.host
    flat_d = pf.block_docids.reshape(-1)
    flat_t = pf.block_tfs.reshape(-1)
    # a term's postings fill the first df lanes of its blocks
    starts = dp.term_block_start.astype(np.int64) * BLOCK_SIZE
    # the dtype is decided over every candidate row: one tf above 2048
    # would round in float16 and the certificate would not see it
    max_tf = max(float(flat_t[starts[t]:starts[t] + df[t]].max())
                 for t in hot)
    dtype = np.float16 if max_tf <= DENSE_F16_MAX_TF else np.float32
    h = int(min(len(hot), (DENSE_MB << 20) // (nd * np.dtype(dtype).itemsize)))
    if h == 0:
        return None, {}
    dense = np.zeros((h, nd), dtype)
    rows = {}
    for row, t in enumerate(hot[:h]):
        s, n = int(starts[t]), int(df[t])
        dense[row, flat_d[s:s + n]] = flat_t[s:s + n]
        rows[int(t)] = row
    logger.info("fastpath dense hot-term table: %d rows x %d docs (%s, %.0f "
                "MB)", h, nd, np.dtype(dtype).name, dense.nbytes / 2 ** 20)
    return torch.from_numpy(dense).to(device), rows
