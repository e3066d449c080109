"""Sharded search over a grid of devices (counterpart of
elasticsearch_tpu/parallel/sharded.py).

The reference runs an index of N shards as ONE SPMD program over a jax
``Mesh``: every device scores its shard, one ``all_gather`` over the
shard axis and a re-top-k replace the coordinator's merge, a ``psum``
the summed totals. jax is single-controller, so that program is issued
by one process. The port keeps the single controller:

- a ``Mesh`` is a grid of ``torch.device``s with the axes
  ``("replica", "shard")``; ``.devices`` is that grid as an ndarray;
- axis ``"shard"`` partitions the corpus: shard s's tensors are resident
  on the devices of column s;
- axis ``"replica"`` partitions the query batch (read scaling): replica
  row r scores its slice of the queries against its own copy of every
  shard, and nothing crosses this axis;
- the host issues each shard's program on that shard's device without a
  host sync in between, so distinct cards run concurrently; the gather
  is a copy of each shard's [Q, k] values and ids onto the row's first
  device (``.to(dst, non_blocking=True)``, peer to peer where the cards
  allow it, nothing where the shard already lives there), then one
  stable re-top-k; a psum is the sum of the shards' counts there.

Global ids are ``shard * n_docs_padded + local`` in int64 on the
device, so they are exact at any scale: the reference's int32 ceiling
(``GID_INT32_LIMIT``) and its host merge exist only because jax runs
with x64 off. Ties keep the lower flat position of the gathered
[S * k], shard first, then rank, as ``lax.top_k`` does.

The programs here are the reference's library kernels (BM25 and kNN
top-k, hybrid RRF, the dfs statistics). The serving path
(parallel/mesh_executor.py) runs the fused plan program instead.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.device import resolve_devices
from elasticsearch_tpu_torch.index.segment import BLOCK_SIZE
from elasticsearch_tpu_torch.ops.bm25 import _SENTINEL, segmented_topk
from elasticsearch_tpu_torch.ops.topk import stable_topk
from elasticsearch_tpu_torch.ops.vector import dot_scores, host_norms

# the RRF fusion's sentinel key (padding): sorts after every global id
_GID_SENTINEL = torch.iinfo(torch.int64).max


class Mesh:
    """A grid of torch devices with named axes (the reference's jax
    ``Mesh``): ``devices`` an object ndarray of ``torch.device``,
    ``axis_names`` one name per grid axis, ``shape`` {name: size}. The
    same device may fill several cells (one card standing in for a
    grid), and then its cells share its memory."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d grid needs "
                             f"{grid.ndim} axis names, got {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_shards: Optional[int] = None, n_replicas: int = 1,
              devices=None) -> Mesh:
    """A ("replica", "shard") mesh over ``devices`` (device.py
    ``resolve_devices``: every visible CUDA card by default); the first
    ``n_replicas * n_shards`` devices fill the grid row by row."""
    devices = resolve_devices(devices)
    if n_shards is None:
        n_shards = len(devices) // n_replicas
    if n_replicas * n_shards > len(devices) or n_shards < 1:
        raise ValueError(f"a {n_replicas} x {n_shards} mesh needs "
                         f"{n_replicas * n_shards} devices, "
                         f"got {len(devices)}")
    grid = np.empty(n_replicas * n_shards, dtype=object)
    grid[:] = devices[:n_replicas * n_shards]
    return Mesh(grid.reshape(n_replicas, n_shards), ("replica", "shard"))


def _place(mesh: Mesh, arr: np.ndarray) -> List[List[torch.Tensor]]:
    """Shard s's slice of a stacked [S, ...] host array on every device
    of column s: ``out[r][s]``. Cells on one device share one copy."""
    up: Dict[Tuple[int, torch.device], torch.Tensor] = {}
    out = []
    for r in range(mesh.devices.shape[0]):
        row = []
        for s in range(mesh.devices.shape[1]):
            dev = mesh.devices[r, s]
            t = up.get((s, dev))
            if t is None:
                t = up[(s, dev)] = torch.from_numpy(
                    np.ascontiguousarray(arr[s])).to(dev)
            row.append(t)
        out.append(row)
    return out


class ShardedIndex:
    """One text field's corpus laid out for a mesh: per shard, postings
    blocks (with the reserved all-zero block last), doc lengths, the
    live mask and optionally a float32 vector slab, each on the devices
    of its grid column (``block_docids[r][s]`` on ``devices[r, s]``).

    Built from per-shard arrays padded to a common shape, stacked on a
    leading shard axis (``build_sharded_index``)."""

    def __init__(self, mesh: Mesh,
                 block_docids: np.ndarray,   # [S, TB, B] int32
                 block_tfs: np.ndarray,      # [S, TB, B] float32
                 doc_lens: np.ndarray,       # [S, ND] float32
                 live: np.ndarray,           # [S, ND] bool
                 avg_len: float,
                 vectors: Optional[np.ndarray] = None,  # [S, ND, D]
                 ):
        if mesh.shape["shard"] != block_docids.shape[0]:
            raise ValueError(f"{block_docids.shape[0]} shards on a mesh "
                             f"of {mesh.shape['shard']}")
        self.mesh = mesh
        self.block_docids = _place(mesh, block_docids)
        self.block_tfs = _place(mesh, block_tfs)
        self.doc_lens = _place(mesh, doc_lens)
        self.live = _place(mesh, live)
        self.avg_len = float(avg_len)
        self.vectors = (_place(mesh, vectors) if vectors is not None
                        else None)
        self.n_shards = block_docids.shape[0]
        self.n_docs_padded = doc_lens.shape[1]
        # global id = shard * gid_stride + local docid (int64: any stride
        # is exact, 2^31 and past it too)
        self.gid_stride = self.n_docs_padded
        # each shard's reserved all-zero block row, its selections' pad
        self.zero_blocks = [block_docids.shape[1] - 1] * self.n_shards


def _row_slices(mesh: Mesh, q: int) -> List[slice]:
    """The query rows of each replica row (the batch splits evenly)."""
    n = mesh.shape["replica"]
    if q % n:
        raise ValueError(f"{q} queries do not split over {n} replicas")
    step = q // n
    return [slice(r * step, (r + 1) * step) for r in range(n)]


def _shard_bm25_topk_local(docids, tfs, lens, live, sel, ws, nd: int,
                           avg_len: float, k1: float, b: float, k: int):
    """One shard's BM25 top-k of Q queries (the shared body of the
    sharded BM25 and hybrid programs): the selected blocks' BM25
    contributions scattered into dense [Q, ND] scores, docs of score 0
    or deleted dropped, then the stable top-k. Returns (vals float32
    [Q, k], local ids int32 [Q, k]; empty slots (-inf, _SENTINEL))."""
    sel = sel.long()
    d = docids[sel]                                     # [Q, NB, B]
    tf = tfs[sel]
    dl = lens[d.long()]
    avg = torch.full((), avg_len, dtype=torch.float32, device=d.device)
    norm = k1 * ((1.0 - b) + b * dl / avg)
    contrib = ws[..., None] * torch.where(tf > 0.0, tf / (tf + norm), 0.0)
    q = sel.shape[0]
    scores = torch.zeros((q, nd), dtype=torch.float32, device=d.device)
    scores.scatter_add_(1, d.reshape(q, -1).long(), contrib.reshape(q, -1))
    masked = torch.where(live[None, :] & (scores > 0.0), scores,
                         float("-inf"))
    ids = torch.arange(nd, dtype=torch.int32,
                       device=d.device)[None].expand(q, nd)
    return stable_topk(masked, ids, k)


def _global_ids(vals, ids, shard: int, nd: int) -> torch.Tensor:
    """Local ids -> int64 global ids ``shard * nd + local``; empty slots
    keep the sentinel."""
    return torch.where(vals > float("-inf"), ids.long() + shard * nd,
                       _SENTINEL)


def _merge_over_shards(vals: List[torch.Tensor], gids: List[torch.Tensor],
                       k: int, dst: torch.device):
    """The gather over the shard axis and the re-top-k (the on-device
    coordinator merge shared by every sharded program): each shard's
    [Q, k] onto ``dst``, then the stable top-k of the [Q, S * k] rows,
    ties to the lower flat position (shard, then rank)."""
    av = torch.cat([v.to(dst, non_blocking=True) for v in vals], dim=1)
    ag = torch.cat([g.to(dst, non_blocking=True) for g in gids], dim=1)
    return stable_topk(av, ag, k)


def _gather_rows(mesh: Mesh, parts):
    """The replica rows' [q, k] results onto the grid's first device."""
    dst = mesh.devices[0, 0]
    return tuple(torch.cat([p[i].to(dst, non_blocking=True) for p in parts])
                 for i in range(len(parts[0])))


def _as_rows(arr, dtype) -> torch.Tensor:
    """A host array (or tensor) as a host tensor of ``dtype``."""
    if isinstance(arr, torch.Tensor):
        return arr.to(dtype=dtype)
    return torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(
        dtype)


def sharded_bm25_topk(index: ShardedIndex,
                      sel_blocks,     # [S, Q, NB] int32, per shard
                      sel_weights,    # [S, Q, NB] float32
                      k: int, k1: float = 1.2, b: float = 0.75):
    """Batched sharded BM25 top-k: every shard scores its own postings
    for its replica row's queries, local top-k, gather and merge over
    the shard axis. Returns (scores float32 [Q, k], global docids int64
    [Q, k]) on the grid's first device, global docid = shard *
    ``gid_stride`` (n_docs_padded) + local docid."""
    mesh = index.mesh
    nd = index.n_docs_padded
    sel_all = _as_rows(sel_blocks, torch.int32)
    ws_all = _as_rows(sel_weights, torch.float32)
    parts = []
    for r, rows in enumerate(_row_slices(mesh, sel_all.shape[1])):
        # every shard's inputs go up before any program runs: an upload
        # waits for its device's stream
        ins = [(sel_all[s, rows].to(mesh.devices[r, s]),
                ws_all[s, rows].to(mesh.devices[r, s]))
               for s in range(index.n_shards)]
        vals, gids = [], []
        for s, (sel, ws) in enumerate(ins):
            v, i = _shard_bm25_topk_local(
                index.block_docids[r][s], index.block_tfs[r][s],
                index.doc_lens[r][s], index.live[r][s], sel, ws, nd,
                index.avg_len, k1, b, k)
            vals.append(v)
            gids.append(_global_ids(v, i, s, index.gid_stride))
        parts.append(_merge_over_shards(vals, gids, k, mesh.devices[r, 0]))
    return _gather_rows(mesh, parts)


def _shard_knn_topk_local(vectors, live, q, k: int):
    """One shard's brute-force kNN top-k: raw dot products (float32
    out), deleted docs dropped, the stable top-k."""
    scores = dot_scores(q, vectors)
    masked = torch.where(live[None, :], scores, float("-inf"))
    ids = torch.arange(scores.shape[1], dtype=torch.int32,
                       device=scores.device)[None].expand_as(scores)
    return stable_topk(masked, ids, k)


def sharded_knn_topk(index: ShardedIndex,
                     queries,        # [Q, D] float32
                     k: int):
    """Sharded brute-force kNN: the queries of each replica row go to
    every shard of the row, one product and local top-k a shard, then
    the gather and merge. Returns (scores float32 [Q, k], global docids
    int64 [Q, k]) on the grid's first device."""
    mesh = index.mesh
    nd = index.n_docs_padded
    q_all = _as_rows(queries, torch.float32)
    parts = []
    for r, rows in enumerate(_row_slices(mesh, q_all.shape[0])):
        ins = [q_all[rows].to(mesh.devices[r, s])
               for s in range(index.n_shards)]
        vals, gids = [], []
        for s, q in enumerate(ins):
            v, i = _shard_knn_topk_local(index.vectors[r][s],
                                         index.live[r][s], q, k)
            vals.append(v)
            gids.append(_global_ids(v, i, s, index.gid_stride))
        parts.append(_merge_over_shards(vals, gids, k, mesh.devices[r, 0]))
    return _gather_rows(mesh, parts)


def sharded_hybrid_rrf(index: ShardedIndex,
                       sel_blocks,     # [S, Q, NB] int32
                       sel_weights,    # [S, Q, NB] float32
                       queries,        # [Q, D] float32
                       k: int, k1: float = 1.2, b: float = 0.75,
                       rank_constant: int = 60):
    """Hybrid BM25 + kNN with reciprocal rank fusion on the mesh: each
    shard scores both branches, each branch merges over the shard axis,
    and the fusion (the sum of 1 / (c + rank + 1) a branch, keyed by
    global docid) runs through ops/bm25.py ``segmented_topk``. Returns
    (rrf scores float32 [Q, k], global docids int64 [Q, k]); empty
    slots are (-inf, the int64 maximum)."""
    b_vals, b_gids = sharded_bm25_topk(index, sel_blocks, sel_weights, k,
                                       k1, b)
    v_vals, v_gids = sharded_knn_topk(index, queries, k)
    dev = b_vals.device
    c = float(rank_constant)
    rc = 1.0 / (c + torch.arange(k, dtype=torch.float32, device=dev) + 1.0)
    out_v, out_g = [], []
    for qi in range(b_vals.shape[0]):
        gids = torch.cat([b_gids[qi], v_gids[qi]])
        contrib = torch.cat([
            torch.where(torch.isfinite(b_vals[qi]), rc, 0.0),
            torch.where(torch.isfinite(v_vals[qi]), rc, 0.0)])
        key = torch.where(contrib > 0.0, gids, _GID_SENTINEL)
        v, g = segmented_topk(key, contrib, k, _GID_SENTINEL)
        out_v.append(v)
        out_g.append(g)
    return torch.stack(out_v), torch.stack(out_g)


def sharded_dfs_stats(index: ShardedIndex,
                      sel_blocks) -> torch.Tensor:   # [S, NB]
    """The dfs phase's statistics on the mesh: per selected block, the
    docs of each shard's block with tf > 0, summed over the shard axis.
    Returns int64 [NB] on the grid's first device."""
    mesh = index.mesh
    sel_all = _as_rows(sel_blocks, torch.int64)
    dst = mesh.devices[0, 0]
    ins = [sel_all[s].to(mesh.devices[0, s]) for s in range(index.n_shards)]
    local = [(index.block_tfs[0][s][sel] > 0.0).sum(dim=1)
             for s, sel in enumerate(ins)]
    return torch.stack([c.to(dst, non_blocking=True) for c in local]).sum(0)


def build_sharded_index(mesh: Mesh, segments: List, field: str,
                        with_vectors: Optional[str] = None
                        ) -> Tuple[ShardedIndex, List]:
    """Stack per-shard segments (padded to common shapes) into a
    ShardedIndex: one Segment per shard (shards beyond
    ``len(segments)`` are empty). Returns (index, each shard's
    PostingsField of ``field`` or None)."""
    s = mesh.shape["shard"]
    pfs = [seg.postings.get(field) for seg in segments]
    max_tb = max((pf.block_docids.shape[0] for pf in pfs if pf is not None),
                 default=0) + 1          # + the zero pad block
    max_nd = max((seg.n_docs for seg in segments), default=1)
    max_nd = ((max_nd + 1023) // 1024) * 1024

    block_docids = np.zeros((s, max_tb, BLOCK_SIZE), np.int32)
    block_tfs = np.zeros((s, max_tb, BLOCK_SIZE), np.float32)
    doc_lens = np.ones((s, max_nd), np.float32)
    live = np.zeros((s, max_nd), bool)
    total_len = 0.0
    total_docs = 0
    for i, seg in enumerate(segments[:s]):
        pf = seg.postings.get(field)
        if pf is None:
            continue
        tb = pf.block_docids.shape[0]
        block_docids[i, :tb] = pf.block_docids
        block_tfs[i, :tb] = pf.block_tfs
        doc_lens[i, :seg.n_docs] = np.maximum(pf.field_lengths, 1.0)
        live[i, :seg.n_docs] = seg.live
        total_len += pf.field_lengths.sum()
        total_docs += pf.doc_count

    vectors = None
    if with_vectors is not None:
        dims = next(seg.vectors[with_vectors].dims for seg in segments
                    if with_vectors in seg.vectors)
        vectors = np.zeros((s, max_nd, dims), np.float32)
        for i, seg in enumerate(segments[:s]):
            vv = seg.vectors.get(with_vectors)
            if vv is not None:
                # the reference's host preparation: cosine rows
                # pre-normalized (zero vectors stay zero)
                prepped = np.asarray(vv.vectors, np.float32)
                if vv.similarity == "cosine":
                    norms = host_norms(prepped)
                    prepped = prepped / np.where(
                        norms > 0, norms, np.float32(1.0))[:, None]
                vectors[i, :len(prepped)] = prepped

    avg_len = total_len / max(1, total_docs)
    return ShardedIndex(mesh, block_docids, block_tfs, doc_lens, live,
                        avg_len, vectors), pfs
