"""Serving kernel of the v2m cohort lane (counterpart of
elasticsearch_tpu/ops/fastpath.py `bm25_topk_total_merge_batch`).

One call scores a whole cohort of Q queries and returns ONE packed
float32 array, so the cohort pays one device-to-host copy:

    row = [values (k) | docids as float (k) | total as float (1)]

Exactness: no block-max pruning (every selected posting goes through the
merge); the per-doc sum is a DOUBLING segmented scan over the docid-
sorted runs (each doc's <= 16 contributions summed directly, not a
global prefix); totals are exact distinct-match counts (relation "eq");
the top-k keeps the lowest docids among ties at the kth value.

The two hand-written kernels are the gather + contribution
(ops/bm25_contrib.py) and the merge (ops/merge.py). The scan, run-last
selection and top-k are plain PyTorch ops, as the reference leaves them
to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from elasticsearch_tpu_torch.ops.bm25 import _SENTINEL
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.ops.merge import merge_sorted_slots
from elasticsearch_tpu_torch.ops.plan import check_packed_id_limit

# mask-stack height: every cohort launch carries F dense bool rows
# (row 0 = the live mask; rows 1.. = filter columns, a later slice);
# each query picks its row by mask_ids
F_SLOTS = 32

# runs are <= 16 term instances per doc (N_SLOTS): 4 doubling steps
# close every real run (sentinel runs are longer; never read)
_MERGE_SCAN_STEPS = (1, 2, 4, 8)


def _doubling_scan(keys: torch.Tensor, vals: torch.Tensor,
                   steps=_MERGE_SCAN_STEPS) -> torch.Tensor:
    """Segmented inclusive sums over contiguous key-runs along the LAST
    axis (Hillis-Steele with the key-equality carry)."""
    x = vals
    for step in steps:
        prev_x = F.pad(x[..., :-step], (step, 0))
        prev_k = F.pad(keys[..., :-step], (step, 0), value=-1)
        x = x + torch.where(prev_k == keys, prev_x, 0.0)
    return x


def _run_last_candidates(mk: torch.Tensor, x: torch.Tensor):
    """(cand, totals) from merged keys + per-run sums [Q, P]: run-last
    positions carry the doc totals; everything else -inf."""
    nxt = F.pad(mk[:, 1:], (0, 1), value=-1)
    real_last = (mk != nxt) & (x > 0.0) & (mk != _SENTINEL)
    totals = real_last.sum(dim=1, dtype=torch.int32)
    return torch.where(real_last, x, float("-inf")), totals


def _stable_topk(cand: torch.Tensor, keys: torch.Tensor, k: int):
    """Batched STABLE top-k of ``cand`` [Q, P] (key-ascending order):
    among ties at the kth value the FIRST positions (lowest keys) win.
    Returns (vals [Q, k], ids [Q, k]) ordered by value descending, then
    position ascending; empty slots are (-inf, _SENTINEL)."""
    kth = torch.topk(cand, k, dim=1).values[:, k - 1:k]
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
    ids = torch.where(torch.isfinite(vals), ids, _SENTINEL)
    return vals, ids


def bm25_topk_total_merge_batch(
        block_docids,   # int32 [TB, B]
        block_tfs,      # float32 [TB, B]
        sel_blocks,     # int32 [Q, NB] SLOTTED (term runs start on slot
                        #   boundaries; slot = NB // n_slots blocks)
        sel_weights,    # score_dtype [Q, NB]
        doc_lens,       # float32 [ND]
        masks,          # bool [F_SLOTS, ND]
        mask_ids,       # int32 [Q]
        avg_len: float, n_slots: int, k1: float, b: float, k: int,
        score_dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Cohort launch -> packed float32 [Q, 2k+1]. Ranking runs in
    ``score_dtype`` (float64 for serving, float32 for parity with the
    reference under x64 off); reported scores are float32."""
    check_packed_id_limit(doc_lens.shape[0], "fastpath kernel")
    q, nb = sel_blocks.shape
    p = nb * block_docids.shape[1]
    if sel_weights.dtype != score_dtype:
        sel_weights = sel_weights.to(score_dtype)
    avg = float(torch.tensor(avg_len, dtype=score_dtype))
    keys, cons = gather_bm25_contrib(block_docids, block_tfs, sel_blocks,
                                     sel_weights, doc_lens, masks, mask_ids,
                                     avg, k1, b)
    # the merge carries the LANE INDEX (int32) as payload; the rail-dtype
    # contributions follow through the merged permutation
    lane = torch.arange(p, dtype=torch.int32, device=keys.device)
    lane = lane.repeat(q, 1).view(q, n_slots, p // n_slots)
    mk, midx = merge_sorted_slots(keys.reshape(q, n_slots, p // n_slots),
                                  lane)
    x = torch.gather(cons, 1, midx.long())
    x = _doubling_scan(mk, x)
    cand, totals = _run_last_candidates(mk, x)
    vals, ids = _stable_topk(cand, mk, k)
    return torch.cat([vals.to(torch.float32), ids.to(torch.float32),
                      totals.to(torch.float32)[:, None]], dim=1)
