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
(ops/bm25_contrib.py) and the merge (ops/merge.py). The scan
(ops/bm25.py), run-last selection and top-k (ops/topk.py) are plain
PyTorch ops, as the reference leaves them to XLA outside any Pallas
kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from elasticsearch_tpu_torch.ops.bm25 import _SENTINEL, doubling_scan
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.ops.merge import merge_sorted_slots
from elasticsearch_tpu_torch.ops.plan import check_packed_id_limit
from elasticsearch_tpu_torch.ops.topk import stable_topk

# mask-stack height: every cohort launch carries F dense bool rows
# (row 0 = the live mask; rows 1.. = filter columns, a later slice);
# each query picks its row by mask_ids
F_SLOTS = 32


def _run_last_candidates(mk: torch.Tensor, x: torch.Tensor):
    """(cand, totals) from merged keys + per-run sums [Q, P]: run-last
    positions carry the doc totals; everything else -inf."""
    nxt = F.pad(mk[:, 1:], (0, 1), value=-1)
    real_last = (mk != nxt) & (x > 0.0) & (mk != _SENTINEL)
    totals = real_last.sum(dim=1, dtype=torch.int32)
    return torch.where(real_last, x, float("-inf")), totals


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
    # runs are <= n_slots term instances per doc (sentinel runs are
    # longer; never read)
    x = doubling_scan(mk, x, n_slots)
    cand, totals = _run_last_candidates(mk, x)
    vals, ids = stable_topk(cand, mk, k)
    return torch.cat([vals.to(torch.float32), ids.to(torch.float32),
                      totals.to(torch.float32)[:, None]], dim=1)
