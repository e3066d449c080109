"""Device-side aggregation collectors (counterpart of
elasticsearch_tpu/ops/aggs.py): batched segment reductions over columnar
doc values, as PyTorch ops on the tensors' device.

- ``terms_counts_per_term``: exact per-term doc counts of a query mask
  over a keyword field's ord-major docid permutation (ops/device.py
  ``keyword_ord_major``): gather the mask through the permutation, one
  int32 inclusive cumsum, difference at the term boundaries.
- ``masked_metric_stats``: count, sum, min, max and sum of squares of a
  masked float32 column, read back as one stacked tensor.
- ``bucket_counts`` and ``bucket_metric_columns``: a histogram's
  per-bucket doc counts (an int32 scatter-add into ``nb + 1`` slots, the
  last swallowing masked-out docs) and per-bucket count, sum, min, max
  and sum of squares of a metric column (``index_add_`` and
  ``scatter_reduce_``), one readback each.

The bucket-id arithmetic stays on the host in float64 (epoch-millisecond
keys exceed float32's integer range; search/aggregations.py computes it)
and the dispatch thresholds live there too. Float32 sums on the card are
atomic adds in no fixed order, so sums, averages and sums of squares may
differ from run to run in the last bits; counts, min and max are exact.

Every readback goes through the funnel (ops/device.py ``readback``)
under the reference's site names. Each collector is a ``tracked_kernel``
(telemetry/engine.py) under the reference's kernel name:
``TRACKER.calls`` counts its calls, on whatever device its tensors live.
"""

from __future__ import annotations

import numpy as np
import torch

from elasticsearch_tpu_torch.ops.device import readback
from elasticsearch_tpu_torch.telemetry.engine import tracked_kernel

# buckets beyond this cap stay on the host unique path (a scatter this
# wide stops paying for the launch)
AGG_BUCKET_CAP = 8192
_F32_BIG = float(np.finfo(np.float32).max)


@tracked_kernel("terms_counts")
def terms_counts_per_term(perm_docs: torch.Tensor, term_starts: np.ndarray,
                          mask: torch.Tensor) -> np.ndarray:
    """Per-term masked doc counts, int64 [n_terms] on the host:
    ``perm_docs`` int32 [total] (the ord-major docids), ``term_starts``
    int64 [n_terms + 1] (each term's first position in it), ``mask``
    bool [n_docs_padded] on the same device. One gather, one cumsum,
    one [n_terms] readback."""
    hits = torch.index_select(mask, 0, perm_docs).to(torch.int32)
    cum = torch.zeros(len(perm_docs) + 1, dtype=torch.int32,
                      device=mask.device)
    torch.cumsum(hits, 0, dtype=torch.int32, out=cum[1:])
    starts = torch.from_numpy(term_starts).to(mask.device)
    counts = cum[starts[1:]] - cum[starts[:-1]]
    return readback("ops.aggs.terms_counts", counts).astype(np.int64)



@tracked_kernel("agg_metric_stats")
def masked_metric_stats(values: torch.Tensor, missing: torch.Tensor,
                        mask: torch.Tensor):
    """(count, sum, min, max, sum_sq) over the masked present values of
    a float32 column: one fused pass, one readback of the five stacked
    as float64 (exact: each is a float32 or a count below 2^24). min and
    max are None when the count is 0."""
    sel = mask & ~missing
    v = torch.where(sel, values, 0.0)
    stats = torch.stack([
        sel.sum(dtype=torch.int64).to(torch.float64),
        v.sum().to(torch.float64),
        torch.where(sel, values, _F32_BIG).amin().to(torch.float64),
        torch.where(sel, values, -_F32_BIG).amax().to(torch.float64),
        (v * v).sum().to(torch.float64)])
    n, s, mn, mx, ss = readback("ops.aggs.metric_stats", stats).tolist()
    if n == 0:
        return 0, 0.0, None, None, 0.0
    return int(n), s, mn, mx, ss



def pow2_buckets(nb: int) -> int:
    """``nb`` padded to the power-of-two ladder (floor 64), the
    reference's compile rungs; 0 when past AGG_BUCKET_CAP (the caller
    takes the host path)."""
    if nb <= 0 or nb > AGG_BUCKET_CAP:
        return 0
    p = 64
    while p < nb:
        p <<= 1
    return p


def _check_cap(nb: int) -> None:
    if pow2_buckets(nb) == 0:
        raise ValueError(f"bucket count {nb} past AGG_BUCKET_CAP")


@tracked_kernel("agg_bucket_counts", static_argnames=("nb",))
def bucket_counts(bucket_ids: torch.Tensor, mask: torch.Tensor,
                  nb: int) -> np.ndarray:
    """Host int64 counts [nb] from one int32 scatter-add into ``nb + 1``
    slots. ``bucket_ids`` int32 in [0, nb) where ``mask`` holds (ids of
    out-of-range docs must be masked out)."""
    _check_cap(nb)
    ids = torch.where(mask, bucket_ids, nb)
    counts = torch.zeros(nb + 1, dtype=torch.int32, device=mask.device)
    counts.index_add_(0, ids, torch.ones_like(ids))
    return readback("ops.aggs.bucket_counts",
                    counts[:nb]).astype(np.int64)



@tracked_kernel("agg_bucket_metrics", static_argnames=("nb",))
def bucket_metric_columns(bucket_ids: torch.Tensor, mask: torch.Tensor,
                          values: torch.Tensor, missing: torch.Tensor,
                          nb: int):
    """Host (count int64, sum, min, max, sum_sq float64) arrays [nb] of
    one float32 metric column across all buckets: one pass, one readback
    of the five stacked as float64. min/max of a bucket with no value
    come back as the float32 max with the sign of +inf/-inf; the caller
    masks them by count == 0."""
    _check_cap(nb)
    sel = mask & ~missing
    ids = torch.where(sel, bucket_ids, nb).long()
    v = torch.where(sel, values, 0.0)
    dev = values.device
    cnt = torch.zeros(nb + 1, dtype=torch.int32, device=dev)
    cnt.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
    s = torch.zeros(nb + 1, dtype=torch.float32, device=dev)
    s.index_add_(0, ids, v)
    ss = torch.zeros(nb + 1, dtype=torch.float32, device=dev)
    ss.index_add_(0, ids, v * v)
    mn = torch.full((nb + 1,), _F32_BIG, dtype=torch.float32, device=dev)
    mn.scatter_reduce_(0, ids, torch.where(sel, values, _F32_BIG), "amin")
    mx = torch.full((nb + 1,), -_F32_BIG, dtype=torch.float32, device=dev)
    mx.scatter_reduce_(0, ids, torch.where(sel, values, -_F32_BIG), "amax")
    out = torch.stack([cnt[:nb].to(torch.float64), s[:nb].to(torch.float64),
                       mn[:nb].to(torch.float64), mx[:nb].to(torch.float64),
                       ss[:nb].to(torch.float64)])
    cnt, s, mn, mx, ss = readback("ops.aggs.bucket_metrics", out)
    return cnt.astype(np.int64), s, mn, mx, ss

