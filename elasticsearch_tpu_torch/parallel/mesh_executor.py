"""Mesh serving: a multi-shard `_search` as one launch per shard on its
own device, merged on the device (counterpart of
elasticsearch_tpu/parallel/mesh_executor.py).

The reference runs a multi-shard query as ONE ``shard_map`` program:
each device scores its shard with the fused plan kernel, one
``all_gather`` over the shard axis and a re-top-k replace the
coordinator's merge, a ``psum`` the totals. The port keeps its single
controller (parallel/sharded.py): the node's device list is the grid,
shard s lives on its device s, the host issues each shard's program
there without a sync in between (each shard's inputs go up in one
pinned, non-blocking copy: ``upload``), each shard's [k] values and ids
are copied onto the grid's first device, re-taken to the top k and the
totals summed there (ops/plan.py ``plan_topk_mesh``), and the answer
comes back in ONE packed readback. Each shard scores with its own
statistics (the ES default; a dfs search takes the loop), and each is
bound by search/plan.py ``bind_plan`` on a SegmentContext of its own
segment, so a mesh search answers what the per-shard loop it replaces
answers, bit for bit: the same bind, the same program, ties by (score,
shard, docid).

Residency: a shard whose grid device is the node's own reads the node's
DeviceSegment (search/context.py ``DeviceSegmentCache``): the loop's
copy, no second one. A shard placed on another card reads a copy the
mesh keeps in a DeviceSegmentCache of that card, charged to the node's
``hbm`` breaker (an admission past its limit evicts that card's least
recently used copies first, then trips), dropped when a merge retires
its segment (``evict``) or on ``clear``. The replica fan-out's copies
(``replicated``) are charged the same way and leave with their source.
``GET /_kernels`` shows the mesh's own copies a device
(``mesh.residency``).

:class:`MeshSearchBackend` is the serving entry: search/service.py
sends it the eligible multi-shard bodies (plan queries through
``plan_topk_mesh``, a bare kNN merged into the query through
``_mesh_knn_nominate`` and ``_mesh_knn_step``), and search/batching.py
and search/fastpath.py borrow its replica helpers to split a cohort's
rows over the devices. Every refusal counts under
``fallback.<reason>`` and the caller runs the per-shard loop; the gate
is the reference's: at least as many devices as shards, so on one card
every multi-shard body falls back (``not_enough_devices``).

Ceiling: ``PACKED_ID_LIMIT`` (2^24): the packed readback carries global
ids ``shard * n_docs_padded + docid`` as float32 casts, exact below it;
past it the loop serves (``packed_id_ceiling``). The global ids
themselves are int64 on the device and never wrap.
"""

from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.device import resolve_devices
from elasticsearch_tpu_torch.ops import plan as plan_ops
from elasticsearch_tpu_torch.ops import vector as vec_ops
from elasticsearch_tpu_torch.ops.bm25 import _SENTINEL
from elasticsearch_tpu_torch.ops.device import DOC_PAD, readback, round_up
from elasticsearch_tpu_torch.ops.topk import stable_topk
from elasticsearch_tpu_torch.parallel.sharded import Mesh, make_mesh
from elasticsearch_tpu_torch.search import profile as _prof
from elasticsearch_tpu_torch.search.context import (DeviceSegmentCache,
                                                    SegmentContext)
from elasticsearch_tpu_torch.search.plan import (LogicalPlan, bind_plan,
                                                 compile_plan, launch_mask)
from elasticsearch_tpu_torch.telemetry.engine import tracked_kernel

# replicated arrays the replica fan-out keeps (an LRU on their sources)
REPLICA_CACHE_MAX = 64

_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64,
                 np.dtype(np.bool_): torch.bool}


def upload(arrays, dev: torch.device) -> List[torch.Tensor]:
    """Host arrays onto ``dev`` in ONE copy that does not wait for the
    card: packed into one pinned buffer (8-byte aligned slots), copied
    with ``non_blocking`` on the device's current stream, viewed back one
    tensor an array. The pinned block returns to PyTorch's host cache
    only once the copy has run. On the CPU the views alias the buffer."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += round_up(a.nbytes, 8)
    buf = torch.empty(max(total, 8), dtype=torch.uint8,
                      pin_memory=dev.type == "cuda")
    host = buf.numpy()
    for a, off in zip(arrays, offsets):
        host[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    dbuf = buf.to(dev, non_blocking=True)
    return [dbuf[off:off + a.nbytes].view(_TORCH_DTYPES[a.dtype])
            .reshape(a.shape) for a, off in zip(arrays, offsets)]


class MeshCorpus:
    """A multi-shard index laid over a mesh, shard s on the first
    replica row's device s: each shard's SegmentContext (the loop's own
    on the node's device, else one over the mesh's charged copy on the
    shard's card)."""

    def __init__(self, mesh: Mesh, contexts: List[SegmentContext]):
        self.devices = list(mesh.devices[0])
        self.contexts = contexts
        self.n_shards = len(contexts)
        # the global id stride: the widest shard's padded doc count
        self.n_docs_padded = max(c.n_docs_padded for c in contexts)

    @property
    def live(self) -> List[torch.Tensor]:
        return [c.live for c in self.contexts]


def plans_mesh_compatible(plans: List[Optional[LogicalPlan]]) -> bool:
    """Every shard compiled the query to the same structure, with no
    dense factor and no script (the mesh's program runs neither), within
    the launch's 16-bit group and subgroup ids (beyond them the loop
    answers its 400)."""
    if any(p is None for p in plans):
        return False
    p0 = plans[0]
    if any(p.dense or p.script is not None for p in plans):
        return False
    if len(p0.groups) >= plan_ops.GROUP_LIMIT or any(
            t.sub >= plan_ops.GROUP_LIMIT
            for p in plans for g in p.groups for t in g.terms):
        return False
    for p in plans[1:]:
        if (len(p.groups) != len(p0.groups) or p.combine != p0.combine
                or p.msm != p0.msm or p.n_must != p0.n_must
                or p.n_filter != p0.n_filter):
            return False
    return True


def _shard_launch(bp, ctx: SegmentContext) -> plan_ops.ShardLaunch:
    """A shard's bound plan as its launch on the shard's device: the
    selections and group tables in one ``upload``, the corpus arrays and
    the composed filter mask the context's own."""
    dev = ctx.live.device
    host = [a for st in bp.streams for a in (
        st.sel_blocks, st.sel_group, st.sel_sub, st.sel_weight,
        st.sel_const)]
    host += [bp.group_kind, bp.group_req, bp.group_const]
    up = upload(host, dev)
    streams = tuple(st._replace(
        sel_blocks=up[5 * i], sel_group=up[5 * i + 1],
        sel_sub=up[5 * i + 2], sel_weight=up[5 * i + 3],
        sel_const=up[5 * i + 4]) for i, st in enumerate(bp.streams))
    return plan_ops.ShardLaunch(
        streams, *up[-3:], ctx.live, bp.n_must, bp.n_filter, bp.msm,
        bp.bonus, bp.tie, bp.max_run, launch_mask(bp, ctx))


def bind_mesh(corpus: MeshCorpus, plans: List[LogicalPlan], k: int = 10):
    """Bind one LogicalPlan a shard (weights and constants carry each
    shard's own idf) with ``bind_plan`` on the shard's context, exact (no
    pruning), into per-shard launches on the shards' devices
    (``ShardLaunch``, or None for a shard where no term exists). Returns
    None when no query term exists in any shard."""
    shards = []
    for ctx, plan in zip(corpus.contexts, plans):
        bp = bind_plan(plan, ctx, k)
        shards.append(None if bp.empty else _shard_launch(bp, ctx))
    return None if all(s is None for s in shards) else shards


# ---------------------------------------------------------------------------
# The mesh kNN programs: the dense-vector side of plan_topk_mesh. Scoring
# follows search/queries.py KnnQuery.do_execute operation for operation
# (the same ops/vector.py products and ES transforms, the same masking
# order and candidate cut), so a mesh kNN answers what the per-shard
# dense loop answers. A shard without the field (``vectors[s]`` None)
# nominates nothing and scores nothing.
# ---------------------------------------------------------------------------


def _knn_local_scores(vectors, sq_norms, has_value, qvec, similarity):
    """One shard's (scores, mask) through ops/vector.py's products and
    the ES transforms, as KnnQuery scores a segment."""
    q = qvec[None, :]
    if similarity == "cosine":
        scores = (1.0 + vec_ops.cosine_scores(q, vectors)[0]) / 2.0
    elif similarity == "dot_product":
        scores = (1.0 + vec_ops.dot_scores(q, vectors)[0]) / 2.0
    else:   # l2_norm
        neg_sq = vec_ops.l2_scores(q, vectors, sq_norms)[0]
        scores = 1.0 / (1.0 - neg_sq)
    mask = has_value
    return torch.where(mask, scores, 0.0), mask


def _query_on(qvec, dev: torch.device) -> torch.Tensor:
    if isinstance(qvec, torch.Tensor):
        return qvec.to(device=dev, dtype=torch.float32)
    return upload([np.asarray(qvec, np.float32)], dev)[0]


@tracked_kernel("mesh_knn_nominate", static_argnames=("similarity", "nc"))
def _mesh_knn_nominate(vectors, sq_norms, has_value, qvec, dst,
                       similarity: str, nc: int) -> torch.Tensor:
    """Quantized-slab nomination: each shard's top-``nc`` candidate ids
    by its slab score (the ids KnnQuery's exact re-rank reads back per
    segment), one program a shard on its device (``vectors[s]`` etc.),
    gathered onto ``dst``: int32 [S, nc] (a shard without the field all
    ``_SENTINEL``), ONE readback for the mesh."""
    ids = []
    for v, sn, hv in zip(vectors, sq_norms, has_value):
        if v is None:
            ids.append(torch.full((1, nc), _SENTINEL, dtype=torch.int32,
                                  device=dst))
            continue
        scores, _ = _knn_local_scores(v, sn, hv, _query_on(qvec, v.device),
                                      similarity)
        docids = torch.arange(scores.shape[0], dtype=torch.int32,
                              device=scores.device)
        _, top = stable_topk(scores[None], docids[None], nc)
        ids.append(top)
    return torch.cat([i.to(dst, non_blocking=True) for i in ids])


@tracked_kernel("mesh_knn_step",
                static_argnames=("nd", "similarity", "boost", "cut", "k"))
def _mesh_knn_step(vectors, sq_norms, has_value, live, qvec, patches, dst,
                   nd: int, similarity: str, boost: float, cut: int,
                   k: int) -> torch.Tensor:
    """The mesh kNN program: per shard the slab scores, the exact
    float32 re-rank patch (``patches[s]``: (int64 ids, float32 scores)
    on the shard's device, or None), the candidate cut (``cut`` 0: none,
    as a cut of at least the padded size), the boost and the live mask,
    the shard's top k and its count; then the gather onto ``dst``, the
    re-top-k and the summed totals. ``nd`` is every shard's padded doc
    count, the global id stride. Returns ONE packed [2k+1] tensor on
    ``dst``."""
    outs = []
    for s, (v, sn, hv, lv, patch) in enumerate(
            zip(vectors, sq_norms, has_value, live, patches)):
        if v is None:
            continue
        scores, mask = _knn_local_scores(v, sn, hv, _query_on(qvec, v.device),
                                         similarity)
        if patch is not None:
            scores = scores.index_put((patch[0],), patch[1])
        if cut:
            kth = torch.kthvalue(torch.where(mask, scores, float("-inf")),
                                 nd - cut + 1).values
            mask = mask & (scores >= kth)
            scores = torch.where(mask, scores, 0.0)
        if boost != 1.0:
            scores = scores * boost
        mask = mask & lv
        docids = torch.arange(nd, dtype=torch.int32, device=scores.device)
        vals, ids = stable_topk(
            torch.where(mask, scores, float("-inf"))[None], docids[None], k)
        gids = torch.where(vals > float("-inf"), ids.long() + s * nd,
                           _SENTINEL)
        outs.append((vals[0], gids[0], mask.sum(dtype=torch.int32)))
    return plan_ops.mesh_merge([o[0] for o in outs], [o[1] for o in outs],
                               [o[2] for o in outs], dst, k)


class _Replica:
    """One replicated array: the source held weakly (its death drops the
    entry and releases its charge), its copies a device (None where the
    replica device is the source's own), their charged bytes."""

    __slots__ = ("ref", "copies", "version", "nbytes")

    def __init__(self, ref, copies, version, nbytes):
        self.ref, self.copies = ref, copies
        self.version, self.nbytes = version, nbytes


class MeshSearchBackend:
    """The service's mesh entry: runs eligible multi-shard queries with
    shard s on the grid's device s. ``devices`` is the node's device
    list (device.py ``resolve_devices``), the grid; ``cache`` the node's
    DeviceSegmentCache, whose device serves its shards from the node's
    own copies and whose ``hbm`` breaker the mesh's copies elsewhere are
    charged to.

    Dispatches count under ``dispatch.<axis>`` (``shard``: a plan query
    over the shards, ``knn``: a kNN one, ``replica``: queries of cohorts
    split by the replica helpers); every refusal under
    ``fallback.<reason>``, and the caller runs the per-shard loop; both
    are mirrored into ``metrics``, the node's registry, as
    ``search.mesh.dispatch{axis}`` and ``search.mesh.fallback{reason}``."""

    def __init__(self, devices=None,
                 cache: Optional[DeviceSegmentCache] = None):
        self.devices: List[torch.device] = resolve_devices(devices)
        self.cache = cache
        # the mesh's own copies, one DeviceSegmentCache a card other
        # than the node's
        self._owned: Dict[torch.device, DeviceSegmentCache] = {}
        self._owned_lock = threading.Lock()
        self.mesh_searches = 0   # queries served on the mesh
        self.counters: Dict[str, int] = {}
        self._count_lock = threading.Lock()
        self.metrics = None      # the node's MetricsRegistry (set by Node)
        self._replica_meshes: Dict[int, Mesh] = {}
        self._replicated: "OrderedDict[tuple, _Replica]" = OrderedDict()
        # re-entrant: a source freed while the lock is held calls back
        self._replica_lock = threading.RLock()

    @property
    def breaker(self):
        return self.cache.breaker if self.cache is not None else None

    # ------------------------------------------------------------ gates
    @staticmethod
    def enabled() -> bool:
        """``ESTPU_MESH_SERVING=0`` sends everything to the per-shard
        loop and splits no cohort (the fallback counters still tick)."""
        return os.environ.get("ESTPU_MESH_SERVING", "1") != "0"

    def available_devices(self) -> int:
        return len(self.devices)

    def _count(self, key: str, n: int = 1) -> None:
        with self._count_lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def _dispatch(self, axis: str, n: int = 1) -> None:
        self._count(f"dispatch.{axis}", n)
        if self.metrics is not None:
            self.metrics.inc("search.mesh.dispatch", n, axis=axis)

    def _fallback(self, reason: str) -> None:
        self._count(f"fallback.{reason}")
        if self.metrics is not None:
            self.metrics.inc("search.mesh.fallback", reason=reason)

    # ----------------------------------------------------------- corpus
    def _owned_cache(self, dev: torch.device,
                     like: DeviceSegmentCache) -> DeviceSegmentCache:
        with self._owned_lock:
            cache = self._owned.get(dev)
            if cache is None:
                cache = self._owned[dev] = DeviceSegmentCache(
                    dev, like.vector_dtype, breaker=self.breaker)
            return cache

    def corpus_for(self, searchers) -> MeshCorpus:
        """The shards of ``searchers`` (one segment each) laid over the
        grid: shard s's context on device s, the searcher's own where
        that is its cache's device, else over the mesh's copy there."""
        mesh = make_mesh(n_shards=len(searchers), devices=self.devices)
        contexts = []
        for s, dev in zip(searchers, mesh.devices[0]):
            if dev == s.cache.device:
                contexts.append(s._contexts()[0])
                continue
            seg = s.segments[0]
            contexts.append(SegmentContext(
                seg, self._owned_cache(dev, s.cache).get(seg), s.mapper,
                s.stats, s.k1, s.b))
        return MeshCorpus(mesh, contexts)

    def evict(self, names) -> None:
        """Segments a merge retired: the mesh keeps no copy of them."""
        names = list(names)
        with self._owned_lock:
            caches = list(self._owned.values())
        for cache in caches:
            cache.evict(names)

    def clear(self) -> None:
        """Drop every copy the mesh holds (the shards' and the replicas'),
        their charges with them."""
        with self._owned_lock:
            caches = list(self._owned.values())
        for cache in caches:
            cache.evict_except(set())
        with self._replica_lock:
            while self._replicated:
                self._drop_replica_locked(next(iter(self._replicated)))

    # ------------------------------------------------------------ stats
    def residency(self) -> Dict[str, Dict[str, int]]:
        """The mesh's own copies' bytes a DEVICE by slab class (``GET
        /_kernels`` ``mesh.residency``): shards on the node's device
        read the node's copies and add nothing here."""
        out: Dict[str, Dict[str, int]] = {}
        with self._owned_lock:
            caches = list(self._owned.items())
        for dev, cache in caches:
            hbm = cache.hbm_stats()
            if hbm["total_bytes"]:
                out[str(dev)] = {c: n for c, n in hbm["by_class"].items()
                                 if n}
        return out

    def stats(self) -> Dict[str, object]:
        with self._replica_lock:
            rep_bytes = sum(r.nbytes for r in self._replicated.values())
        with self._count_lock:
            counters = dict(sorted(self.counters.items()))
        return {
            "enabled": self.enabled(),
            "devices": self.available_devices(),
            "mesh_searches": self.mesh_searches,
            "counters": counters,
            "residency": self.residency(),
            "replica_corpus_bytes": int(rep_bytes),
        }

    # -------------------------------------------------- replica helpers
    #
    # The second mode: a query COHORT (a PlanBatcher launch, a fast-path
    # v1 launch) splits its rows over a 1-d ("replica",) mesh, the
    # corpus copied to each replica device and each slice of rows
    # launched there; every row's result is the unsplit launch's.

    def replica_mesh_for(self, q_rows: int) -> Optional[Mesh]:
        """The largest power-of-two ("replica",) mesh that divides a
        ``q_rows``-row cohort, or None below two devices (the caller
        launches on one)."""
        if not self.enabled():
            return None
        n = 1
        while n * 2 <= min(q_rows, len(self.devices)):
            n *= 2
        if n < 2:
            return None
        mesh = self._replica_meshes.get(n)
        if mesh is None:
            grid = np.empty(n, dtype=object)
            grid[:] = self.devices[:n]
            mesh = self._replica_meshes[n] = Mesh(grid, ("replica",))
        return mesh

    def _drop_replica_locked(self, key: tuple) -> None:
        entry = self._replicated.pop(key)
        br = self.breaker
        if br is not None and entry.nbytes:
            br.release(entry.nbytes)

    def _source_freed(self, key: tuple, ref) -> None:
        with self._replica_lock:
            entry = self._replicated.get(key)
            if entry is not None and entry.ref is ref:
                self._drop_replica_locked(key)

    def replicated(self, mesh: Mesh, arr: torch.Tensor,
                   version=None) -> List[torch.Tensor]:
        """``arr`` on every device of ``mesh`` (a list, one a replica):
        the source itself on its own device, a copy on any other, cached
        by the source's identity and ``version`` (a source written in
        place, such as the fast path's mask stack, bumps it). The copies
        are charged to the ``hbm`` breaker (a refused charge raises
        CircuitBreakingException) and leave, with their charge, when the
        source is freed, replaced or rewritten, or falls out of the LRU:
        the cache holds the source only weakly."""
        key = (id(mesh), id(arr))
        with self._replica_lock:
            entry = self._replicated.get(key)
            if entry is not None and entry.ref() is arr \
                    and entry.version == version:
                self._replicated.move_to_end(key)
                return [arr if c is None else c for c in entry.copies]
        copies = []
        for dev in mesh.devices.flat:
            c = arr.to(dev)
            copies.append(None if c.data_ptr() == arr.data_ptr() else c)
        nbytes = sum(int(c.nbytes) for c in copies if c is not None)
        br = self.breaker
        if br is not None and nbytes:
            br.add_estimate_bytes_and_maybe_break(nbytes, "mesh_replica")
        ref = weakref.ref(arr, lambda r, key=key: self._source_freed(key, r))
        with self._replica_lock:
            if key in self._replicated:
                self._drop_replica_locked(key)
            self._replicated[key] = _Replica(ref, copies, version, nbytes)
            while len(self._replicated) > REPLICA_CACHE_MAX:
                self._drop_replica_locked(next(iter(self._replicated)))
        return [arr if c is None else c for c in copies]

    @staticmethod
    def shard_rows(mesh: Mesh, arr) -> List[torch.Tensor]:
        """A cohort's leading (query) axis split evenly over the replica
        devices: one slice a device (host arrays go up through
        ``upload``, without a wait for the card)."""
        n = mesh.devices.size
        step = arr.shape[0] // n
        if isinstance(arr, torch.Tensor):
            return [arr[r * step:(r + 1) * step].to(dev)
                    for r, dev in enumerate(mesh.devices.flat)]
        arr = np.asarray(arr)
        return [upload([arr[r * step:(r + 1) * step]], dev)[0]
                for r, dev in enumerate(mesh.devices.flat)]

    # ---------------------------------------------------------- serving
    def execute(self, searchers, query,
                k: int) -> Optional[Tuple[list, int]]:
        """The mesh path for ``searchers`` (the index's per-shard
        ShardSearchers): ([(shard, segment, local docid, score)], total)
        ordered by (-score, shard, docid), or None, and the caller runs
        the per-shard loop (the reason counted)."""
        if not self.enabled():
            self._fallback("disabled")
            return None
        n_shards = len(searchers)
        if k < 1:
            self._fallback("size_zero")
            return None   # size 0: the loop keeps max_score's semantics
        if n_shards < 2:
            self._fallback("single_shard")
            return None
        if self.available_devices() < n_shards:
            self._fallback("not_enough_devices")
            return None
        if any(len(s.segments) == 0 for s in searchers):
            self._fallback("empty_shard")
            return None
        if any(getattr(s, "dfs_key", None) is not None for s in searchers):
            # dfs scores every shard with pooled statistics; the mesh
            # binds each shard's own
            self._fallback("dfs_stats")
            return None
        from elasticsearch_tpu_torch.search.queries import KnnQuery
        if isinstance(query, KnnQuery):
            return self._execute_knn(searchers, query, k)
        if any(len(s.segments) != 1 for s in searchers):
            # one launch a shard reads one segment (force-merged shards,
            # the reference's residency); checked before any compile
            self._fallback("multi_segment")
            return None
        # shard 0 first: an ineligible query falls back after one compile
        first = compile_plan(query.rewrite(searchers[0]), searchers[0])
        if first is None or first.dense or first.script is not None:
            self._fallback("plan_incompatible")
            return None
        plans = [first] + [compile_plan(query.rewrite(s), s)
                           for s in searchers[1:]]
        if not plans_mesh_compatible(plans):
            self._fallback("plan_incompatible")
            return None
        if n_shards * _padded(searchers) >= plan_ops.PACKED_ID_LIMIT:
            self._fallback("packed_id_ceiling")
            return None
        corpus = self.corpus_for(searchers)
        with _prof.span("bind"):
            bound = bind_mesh(corpus, plans, int(k))
        if bound is None:
            self.mesh_searches += 1
            self._dispatch("shard")
            return [], 0   # no query term exists in any shard
        p0 = plans[0]
        packed = self._launch(
            corpus, "plan_topk_mesh",
            lambda: plan_ops.plan_topk_mesh(
                bound, corpus.devices[0], corpus.n_docs_padded,
                float(searchers[0].k1), float(searchers[0].b), int(k),
                p0.combine))
        self.mesh_searches += 1
        self._dispatch("shard")
        return self._unpack_docs(corpus, packed, int(k))

    def _launch(self, corpus: MeshCorpus, kernel: str, fn) -> np.ndarray:
        """One mesh launch and its ONE readback, timed as the ``launch``
        stage; under ``profile: true`` a device record with the mesh
        shape and the device list."""
        recording = _prof.recording()
        t0 = _prof.now_ns() if recording else 0
        with _prof.span("launch"):
            packed = readback(f"parallel.mesh_executor.{kernel}", fn())
        if recording:
            _prof.record_device({
                "kernel": kernel,
                "mesh_shape": {"shard": corpus.n_shards},
                "device": [str(d) for d in corpus.devices],
                "launch_ms": round((_prof.now_ns() - t0) / 1e6, 3),
                "readback_bytes": int(packed.nbytes),
            })
        return packed

    @staticmethod
    def _unpack_docs(corpus: MeshCorpus, packed: np.ndarray,
                     k: int) -> Tuple[list, int]:
        vals, gids, total = plan_ops.unpack_result(packed, k)
        nd = corpus.n_docs_padded
        docs = [(int(g) // nd, 0, int(g) % nd, float(v))
                for v, g in zip(vals, gids) if v > -np.inf]
        return docs, int(total)

    # -------------------------------------------------------------- kNN
    def _execute_knn(self, searchers, query,
                     k: int) -> Optional[Tuple[list, int]]:
        """A bare top-level kNN query on the mesh, as the per-shard dense
        loop answers it (KnnQuery a shard and the coordinator's merge): a
        quantized slab keeps the exact float32 re-rank, through one
        [S, nc] nomination readback, the same host re-rank a shard, and
        the exact scores patched into the final launch."""
        if query.filter_query is not None:
            self._fallback("knn_filter")
            return None
        if any(len(s.segments) != 1 for s in searchers):
            self._fallback("knn_multi_segment")
            return None
        from elasticsearch_tpu_torch.search.searcher import MAX_TOPK
        k = min(max(int(k), 1), MAX_TOPK)
        pads = {_padded([s]) for s in searchers}
        if len(pads) != 1:
            # the candidate cut and the nomination depth follow EACH
            # shard's padded size in the loop
            self._fallback("knn_nonuniform_padding")
            return None
        n_shards = len(searchers)
        nd = pads.pop()
        if n_shards * nd >= plan_ops.PACKED_ID_LIMIT:
            self._fallback("packed_id_ceiling")
            return None
        sims = {vv.similarity for s in searchers
                for vv in [s.segments[0].vectors.get(query.field)]
                if vv is not None}
        if len(sims) != 1:
            # no shard holds the field, or the shards disagree
            self._fallback("knn_missing_field")
            return None
        sim = sims.pop()
        if sim not in ("cosine", "dot_product", "l2_norm"):
            self._fallback("knn_similarity")
            return None
        qvec = np.asarray(query.query_vector, np.float32)
        dims = next(vv.dims for s in searchers
                    for vv in [s.segments[0].vectors.get(query.field)]
                    if vv is not None)
        if qvec.shape != (dims,):
            # the loop answers the dimension error (a 400)
            self._fallback("knn_dims")
            return None
        corpus = self.corpus_for(searchers)
        dvs = [c.device.vectors.get(query.field) for c in corpus.contexts]
        vectors = [None if dv is None else dv.vectors for dv in dvs]
        sq_norms = [None if dv is None else dv.sq_norms for dv in dvs]
        has_value = [None if dv is None else dv.has_value for dv in dvs]
        cut = query.k or query.num_candidates
        cut = int(cut) if cut is not None and int(cut) < nd else 0
        patches: List[Optional[tuple]] = [None] * n_shards
        quantized = any(v is not None and v.dtype != torch.float32
                        for v in vectors)
        if quantized:
            nc = min(int(query.num_candidates or 3 * (query.k or 1000)), nd)
            ids = readback(
                "parallel.mesh_executor.knn_nominate",
                _mesh_knn_nominate(vectors, sq_norms, has_value, qvec,
                                   corpus.devices[0], sim, nc))   # [S, nc]
            for si, ctx in enumerate(corpus.contexts):
                vv = ctx.segment.vectors.get(query.field)
                if vv is None:
                    continue
                ids_h = ids[si][ids[si] < vv.vectors.shape[0]]
                exact = vec_ops.exact_rerank_scores(vv.vectors[ids_h], qvec,
                                                    sim)
                patches[si] = tuple(upload(
                    [ids_h.astype(np.int64), exact], corpus.devices[si]))
        packed = self._launch(
            corpus, "mesh_knn_step",
            lambda: _mesh_knn_step(
                vectors, sq_norms, has_value, corpus.live, qvec, patches,
                corpus.devices[0], nd, sim, float(query.boost), cut, k))
        self.mesh_searches += 1
        self._dispatch("knn")
        return self._unpack_docs(corpus, packed, k)


def _padded(searchers) -> int:
    """The widest shard's padded doc count (ops/device.py's padding of a
    DeviceSegment), known before anything goes up."""
    nd = max((seg.n_docs for s in searchers for seg in s.segments),
             default=1)
    return max(DOC_PAD, round_up(nd, DOC_PAD))
