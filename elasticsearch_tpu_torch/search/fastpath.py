"""The v2m cohort lane of the serving front (counterpart of
elasticsearch_tpu/search/fastpath.py `FastPathServer`, v2m branch).

Request threads put (term ids, k) on a queue; one drain thread takes
them in COHORTS of up to ``Q_BATCH`` queries of one block bucket,
assembles the slotted block selection on the host, launches ONE
``bm25_topk_total_merge_batch`` per cohort, reads the packed result back
once, and re-sorts each query's hits into (score desc, docid asc).
Continuous batching comes from backpressure: while a cohort runs on the
device, new requests accumulate and drain as a wider cohort.

Slot layout: a bucket of NB blocks has ``N_SLOTS`` slots of NB/N_SLOTS
blocks; each term instance starts on a slot boundary, so every slot is a
docid-ascending run and the merge kernel can combine them. A query that
does not fit the layout, or needs more blocks than the largest bucket,
is refused with ``SliceUnsupported`` (a typed 400): the v1, truncated and
essential lanes that serve it in the reference are later slices. It is
never answered on another device.
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
from elasticsearch_tpu_torch.ops.device import DeviceSegment
from elasticsearch_tpu_torch.ops.device import readback as _readback
from elasticsearch_tpu_torch.ops.fastpath import (
    F_SLOTS, bm25_topk_total_merge_batch)
from elasticsearch_tpu_torch.ops.plan import unpack_ids as _unpack_ids

logger = logging.getLogger("elasticsearch_tpu_torch.fastpath")

Q_BATCH = 32      # cohort width (one launch shape per bucket)
# term-slot count (= the reference's MAX_TERMS); a bucket's slot width is
# bucket // N_SLOTS blocks
N_SLOTS = 16
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

    __slots__ = ("reg", "term_ids", "k", "bucket", "done", "result",
                 "error")

    def __init__(self, reg, term_ids, k, bucket):
        self.reg = reg
        self.term_ids = term_ids
        self.k = k
        self.bucket = bucket
        self.done = threading.Event()
        self.result: Optional[Tuple[np.ndarray, np.ndarray, int]] = None
        self.error: Optional[BaseException] = None


class FastPathServer:
    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._running = False
        self._drain_thread: Optional[threading.Thread] = None
        self._reg_lock = threading.Lock()
        self._regs: Dict[str, dict] = {}
        self._gen = 0
        self.stats = {"cohorts": 0, "fast_queries": 0}
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
            dev = DeviceSegment(segment, self.device)
            dp = dev.postings[field]
            pf = dp.host
            df = dp.doc_freq.astype(np.float64)
            n = float(pf.doc_count)
            self._gen += 1
            reg = {
                "index": index, "field": field, "segment": segment,
                "live": segment.live, "gen": self._gen, "dev": dev,
                "dp": dp, "k1": float(k1), "b": float(b),
                # per-term idf + block ranges as vectors: per-cohort
                # selection assembly is vectorised numpy
                "idf": np.log1p((n - df + 0.5) / (df + 0.5)),
                "nb": dp.term_block_count.astype(np.int64),
                "starts": dp.term_block_start.astype(np.int64),
                # row 0 = live; rows 1.. are the filter rows of a later
                # slice (every query of this slice reads row 0)
                "masks": dev.live.repeat(F_SLOTS, 1),
            }
            self._regs[index] = reg
            logger.info("fastpath registered index=%s field=%s terms=%d",
                        index, field, len(pf.terms))
            return reg

    # --------------------------------------------------------------- search
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

    def submit(self, reg, term_ids: List[int], k: int) -> _Pending:
        """Queue one query (term ids into the registered field's term
        dictionary, -1 for unknown terms). Raises SliceUnsupported for
        what this slice does not serve."""
        if not 0 <= k <= MAX_K:
            raise SliceUnsupported(
                f"size [{k}] is outside [0, {MAX_K}] served by the "
                f"v2m lane")
        known = [t for t in term_ids if t >= 0]
        if not known:
            p = _Pending(reg, term_ids, k, None)
            p.result = (np.zeros(0, np.float32), np.zeros(0, np.int32), 0)
            p.done.set()
            return p
        bucket = self._v2_bucket(reg, term_ids)
        if bucket is None:
            need = int(reg["nb"][known].sum())
            raise SliceUnsupported(
                f"query of {len(known)} term(s) over {need} postings "
                f"blocks does not fit the v2m slot layout ({N_SLOTS} "
                f"slots, largest bucket {NB_BUCKETS[-1]} blocks); the "
                f"v1, truncated and essential lanes that serve it are a "
                f"later slice of the port")
        p = _Pending(reg, list(term_ids), k, bucket)
        self._queue.put(p)
        return p

    def search(self, reg, term_ids: List[int], k: int,
               timeout: float = 120.0):
        """(scores float32 [n], docids int32 [n], total) ordered by
        (score desc, docid asc); blocks until the cohort is back."""
        p = self.submit(reg, term_ids, k)
        if not p.done.wait(timeout):
            raise TimeoutError(f"fast path gave no answer in {timeout}s")
        if p.error is not None:
            raise p.error
        return p.result

    # --------------------------------------------------------------- drain
    def _drain_loop(self):
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
            groups: Dict[Tuple[int, int], List[_Pending]] = {}
            for p in batch:
                groups.setdefault((p.reg["gen"], p.bucket), []).append(p)
            for items in groups.values():
                for i in range(0, len(items), Q_BATCH):
                    self._launch(items[i:i + Q_BATCH])

    def _launch(self, items: List[_Pending]):
        try:
            self._launch_cohort(items)
        except Exception as e:      # the drain thread must never die
            logger.exception("fastpath cohort failed")
            for p in items:
                if not p.done.is_set():
                    p.error = e
                    p.done.set()

    def assemble_cohort(self, reg, bucket: int, queries: List[List[int]]):
        """Host-side slotted selection of one cohort (padded to
        ``Q_BATCH`` rows): (sel_blocks int32 [Q, bucket], sel_weights
        float64 [Q, bucket], mask_ids int32 [Q]). Each term
        instance starts on a slot boundary; unknown terms (-1) skip."""
        dp = reg["dp"]
        slot = bucket // N_SLOTS
        sel = np.full((Q_BATCH, bucket), dp.zero_block, np.int32)
        ws = np.zeros((Q_BATCH, bucket), np.float64)
        mask_ids = np.zeros(Q_BATCH, np.int32)
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
                pos += -(-cnt // slot) * slot
        return sel, ws, mask_ids

    def _launch_cohort(self, items: List[_Pending]):
        reg = items[0].reg
        dp = reg["dp"]
        t0 = time.perf_counter()
        sel, ws, mask_ids = self.assemble_cohort(
            reg, items[0].bucket, [p.term_ids for p in items])
        t1 = time.perf_counter()
        dev = self.device
        if dev.type == "cuda":
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        packed = bm25_topk_total_merge_batch(
            dp.block_docids, dp.block_tfs, torch.from_numpy(sel).to(dev),
            torch.from_numpy(ws).to(dev), dp.doc_lens, reg["masks"],
            torch.from_numpy(mask_ids).to(dev), dp.avg_len, N_SLOTS,
            reg["k1"], reg["b"], MAX_K, score_dtype=SCORE_DTYPE)
        if dev.type == "cuda":
            ev1.record()
        # ONE device->host copy per cohort, through the tracked funnel
        out = _readback("search.fastpath.v2m_cohort", packed)
        t2 = time.perf_counter()
        busy = ev0.elapsed_time(ev1) / 1e3 if dev.type == "cuda" else 0.0
        # the whole cohort in a few numpy calls, then the wake-ups: every
        # call that lets go of the GIL hands it to a request thread
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
        t3 = time.perf_counter()
        with self._stats_lock:
            self.timing["assemble_s"] += t1 - t0
            self.timing["device_s"] += t2 - t1
            self.timing["finish_s"] += t3 - t2
            self.timing["device_busy_s"] += busy
            self.stats["cohorts"] += 1
            self.stats["fast_queries"] += len(items)
