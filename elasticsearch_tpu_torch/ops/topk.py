"""Stable on-device top-k (counterpart of elasticsearch_tpu/ops/topk.py).

``jax.lax.top_k`` returns, among equal values, the lowest index first;
``torch.topk`` on CUDA promises no order among ties. Rows here are laid
out in ascending docid order, so the lowest position is the lowest
docid, Lucene's tie order. The fast-path lanes (ops/fastpath.py), the
plan path (ops/plan.py) and the dense executor (``masked_topk``) share
this one top-k.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from elasticsearch_tpu_torch.ops.bm25 import _SENTINEL
from elasticsearch_tpu_torch.telemetry.engine import tracked_kernel


@tracked_kernel("stable_topk", static_argnames=("k", "bound_slot"))
def stable_topk(cand: torch.Tensor, keys: torch.Tensor, k: int,
                bound_slot: bool = False):
    """Batched STABLE top-k of ``cand`` [Q, P]: among ties at the kth
    value the FIRST positions win. Returns (vals [Q, k], ids [Q, k]),
    ``ids`` gathered from ``keys`` [Q, P], ordered by value descending,
    then position ascending; empty slots are (-inf, _SENTINEL) (a +inf
    value keeps its id, as ``lax.top_k``'s callers keep it). A row
    shorter than k (k + 1 with ``bound_slot``) is padded with (-inf,
    _SENTINEL) first. With ``bound_slot`` also the (k+1)-th value [Q],
    the exclusion bound of the v2 lane's certificate."""
    width = k + 1 if bound_slot else k
    if width > cand.shape[1]:
        pad = width - cand.shape[1]
        cand = F.pad(cand, (0, pad), value=float("-inf"))
        keys = F.pad(keys, (0, pad), value=_SENTINEL)
    top = torch.topk(cand, width, dim=1).values
    kth = top[:, k - 1:k]
    gt = cand > kth
    eq = cand == kth
    need = k - gt.sum(dim=1, keepdim=True)
    eq_rank = torch.cumsum(eq.to(torch.int32), dim=1)
    cand2 = torch.where(gt | (eq & (eq_rank <= need)), cand,
                        float("-inf"))
    # the k winners as a set, then canonical order: value desc, position asc
    pos = torch.topk(cand2, k, dim=1).indices
    pos = torch.sort(pos, dim=1).values
    vals = torch.gather(cand2, 1, pos)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    vals = torch.gather(vals, 1, order)
    pos = torch.gather(pos, 1, order)
    ids = torch.gather(keys, 1, pos)
    ids = torch.where(vals > float("-inf"), ids, _SENTINEL)
    if bound_slot:
        return vals, ids, top[:, k]
    return vals, ids


@tracked_kernel("masked_topk", static_argnames=("k",))
def masked_topk(scores: torch.Tensor, mask: torch.Tensor, k: int):
    """Top-k of ``scores`` [ND] over the docs of ``mask`` [ND] only:
    (vals float32 [k], docids int32 [k]), value descending, and among
    equal values the LOWEST docid first (what ``lax.top_k`` gives). The
    caller supplies the full mask (matched & live & not padding): a
    filter-only query legitimately scores 0.0, so matching is not
    inferred from the score. A value of -inf means fewer than k docs
    passed; its docid is ``_SENTINEL``. A NaN score (a script's) ranks
    as -inf: never returned, as the reference's top-k orders the
    negative NaN its float32 arithmetic computes on the CPU below
    -inf."""
    cand = torch.where(mask & ~torch.isnan(scores), scores,
                       float("-inf"))[None]
    docids = torch.arange(scores.shape[0], dtype=torch.int32,
                          device=scores.device)[None]
    vals, ids = stable_topk(cand, docids, k)
    return vals[0], ids[0]
