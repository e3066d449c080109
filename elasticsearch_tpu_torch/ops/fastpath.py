"""Serving kernels of the fast-path lanes (counterpart of
elasticsearch_tpu/ops/fastpath.py): ``bm25_topk_total_merge_batch``
(v2m), ``bm25_topk_total_batch`` (v1), the θ-warm essential lanes
``bm25_essential_topk_batch`` / ``bm25_essential_dense_topk_batch``, and
``bm25_candidates_rerank_batch`` (v2, the reference's third lane; ported
and tested, but the serving front does not route to it: on the card it
is slower than v2m at the same shape, and it ranks on the float32 score).

One call scores a whole cohort of Q queries and returns ONE packed
float32 array, so the cohort pays one device-to-host copy:

    row = [values (k) | docids as float (k) | total as float (1)]

(v2 adds one more column, its certificate ``ok``; the essential lanes
put their certificate ``ok`` in place of the total).

Exactness: no block-max pruning (every selected posting is scored); the
per-doc sum is a DOUBLING segmented scan over the docid-sorted runs
(each doc's <= 16 contributions summed directly, not a global prefix);
totals are exact distinct-match counts (relation "eq"); the top-k keeps
the lowest docids among ties at the kth value.

The two hand-written kernels are the gather + contribution
(ops/bm25_contrib.py, every lane) and the merge (ops/merge.py, v2m and
v2). The sort, scan (ops/bm25.py), run-last selection, top-k
(ops/topk.py) and v2's re-rank are plain PyTorch ops, as the reference
leaves them to XLA outside any Pallas kernel.
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
# (row 0 = the live mask; rows 1.. = filter-set columns,
# search/fastpath.py); each query picks its row by mask_ids
F_SLOTS = 32
# v1 runs: a query has <= 16 term instances (search/fastpath.py
# MAX_TERMS), each <= 1 posting per doc, so 5 doubling steps close every
# real run (the reference's _SCAN_STEPS)
V1_MAX_RUN = 32
# v2: candidates re-ranked per query; term-instance slots of the
# re-rank's binary search; bound on the float32 phase-A pipeline's
# relative error against float64 (about 5 operations a contribution plus
# a <= 4-level scan of <= 16 positive terms stay under 32 * 2^-24;
# 128 * 2^-24 adds margin)
CAND_V2 = 4096
MAX_T = 16
_F32_SLACK = 128.0 * 2.0 ** -24


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
    return _pack(vals, ids, totals)


def _pack(vals, ids, totals, *extra):
    return torch.cat([vals.to(torch.float32), ids.to(torch.float32),
                      totals.to(torch.float32)[:, None],
                      *(e.to(torch.float32)[:, None] for e in extra)],
                     dim=1)


def bm25_topk_total_batch(
        block_docids,   # int32 [TB, B]
        block_tfs,      # float32 [TB, B]
        sel_blocks,     # int32 [Q, NB], term runs packed back to back
        sel_weights,    # score_dtype [Q, NB]
        doc_lens,       # float32 [ND]
        masks,          # bool [F_SLOTS, ND]
        mask_ids,       # int32 [Q]
        avg_len: float, k1: float, b: float, k: int,
        score_dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """The v1 lane: cohort launch -> packed float32 [Q, 2k+1]. Takes any
    block selection (no slot layout), so it serves the queries the slot
    layout refuses; one stable sort of the keys per row replaces the
    merge. Ranking runs in ``score_dtype``."""
    check_packed_id_limit(doc_lens.shape[0], "fastpath kernel")
    if sel_weights.dtype != score_dtype:
        sel_weights = sel_weights.to(score_dtype)
    avg = float(torch.tensor(avg_len, dtype=score_dtype))
    keys, cons = gather_bm25_contrib(block_docids, block_tfs, sel_blocks,
                                     sel_weights, doc_lens, masks, mask_ids,
                                     avg, k1, b)
    # The reference keys a doc that is dead in the query's mask row to
    # the sentinel; the kernel keeps its docid and contributes 0. After
    # the stable sort a live doc's run holds the same contributions in
    # the same order either way, and a scan step reads only its own run,
    # so its sum is bit-identical; a dead doc's run sums to 0 and fails
    # the x > 0 of the run-last selection, so totals and candidates agree
    # too, and both orders are docid-ascending for the top-k's ties.
    sk, perm = torch.sort(keys, dim=1, stable=True)
    x = torch.gather(cons, 1, perm)
    x = doubling_scan(sk, x, V1_MAX_RUN)
    cand, totals = _run_last_candidates(sk, x)
    vals, ids = stable_topk(cand, sk, k)
    return _pack(vals, ids, totals)


def _cand_norm(doc_lens, safe_ids, avg_len: float, k1: float, b: float,
               dt: torch.dtype) -> torch.Tensor:
    """BM25 length norm ``k1*((1-b) + b*dl/avg)`` of candidates [Q, C]
    in ``dt`` (the reference's per-candidate expression)."""
    dl = doc_lens[safe_ids].to(dt)
    avg_t = torch.full((), avg_len, dtype=dt, device=dl.device)
    return k1 * ((1.0 - b) + b * dl / avg_t)


def _search_tfs(flat_docids, flat_tfs, term_start, term_len, cids,
                n_steps: int) -> torch.Tensor:
    """tf of each candidate in each term instance's posting range,
    float32 [Q, T, C] (0 where absent): every instance's lower-bound
    binary search at once, ``n_steps`` halvings of the flat docid-sorted
    range [term_start, term_start + term_len); a range of length L needs
    ceil(log2(L + 1)) halvings. Instances of length 0 find nothing."""
    n_flat = flat_docids.shape[0]
    lo0 = term_start.long()[:, :, None]
    end = lo0 + term_len.long()[:, :, None]
    target = cids[:, None, :]
    lo = lo0.expand(-1, -1, cids.shape[1])
    hi = end.expand_as(lo)
    for _ in range(n_steps):
        mid = (lo + hi) // 2
        go_right = flat_docids[mid.clamp(0, n_flat - 1)] < target
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    at = lo.clamp(0, n_flat - 1)
    found = (lo < end) & (term_len[:, :, None] > 0) \
        & (flat_docids[at] == target)
    return torch.where(found, flat_tfs[at], 0.0)


# ---------------------------------------------------------------------------
# The θ-warm essential lanes: exact MaxScore for repeat queries.
#
# A query's first exact answer at k = MAX_K leaves its kth score θ. On a
# repeat against the same immutable segment the serving front splits its
# terms by their largest possible contribution (the block-max bound):
# the high-df terms whose bounds sum below a fraction of θ are
# NON-ESSENTIAL, since a doc in none of the essential terms' postings
# cannot reach θ. Only the essential postings go through the sort
# (phase 1); the non-essential contributions are patched back per
# candidate (phase 2) by binary search in the flat postings or by one
# gather per term from a dense [H, ND] tf table of the hottest terms.
# The certificate proves the answer exact on the device: every doc
# outside the top-C candidates scores at most (C+1)th essential score
# + sum of the non-essential bounds; if the patched kth does not beat it
# strictly, ``ok`` = 0 and the serving front refires the row on a full
# lane. Unlike the reference, the candidates are ranked in the rail
# dtype (float64 when serving), as the v1 and v2m lanes rank, so a warm
# repeat orders its hits as its cold answer did.
# ---------------------------------------------------------------------------

# non-essential term slots of a query (unused slots: length 0 / row -1)
NE_SLOTS = 8
# candidates patched per query: must exceed the essential union of
# typical queries, or the overflow bound engages and refires
CAND = 16384
# halvings of the binary-search patch: closes ranges shorter than 2^21
# postings (the serving front admits no longer non-essential term)
NE_SEARCH_STEPS = 21


def _essential_phase1(block_docids, block_tfs, sel_blocks, sel_weights,
                      doc_lens, masks, mask_ids, ne_bound, avg_len,
                      k1: float, b: float, score_dtype: torch.dtype):
    """Exact scores over the ESSENTIAL union: the v1 lane's front half
    (contribution kernel, one stable sort, the 5-step scan, run-last),
    then the top C+1 with C = min(CAND, lanes - 1). Returns (cand_ids
    [Q, C], ess [Q, C] rail dtype, overflow bound [Q] = the (C+1)th
    essential score + the non-essential bound, -inf when the union held
    at most C docs). Shared by both patch ops.

    Dead docs: the reference keys a doc that is dead in the query's mask
    row to the sentinel; the kernel keeps its docid and contributes 0.
    As in the v1 lane, a live doc's run holds the same contributions in
    the same order after the stable sort and sums bit-identically, and a
    dead doc's run sums to 0 and fails the run-last x > 0, so the
    candidates, their order and the (C+1)th score agree."""
    check_packed_id_limit(doc_lens.shape[0], "fastpath essential lane")
    if sel_weights.dtype != score_dtype:
        sel_weights = sel_weights.to(score_dtype)
    avg = float(torch.tensor(avg_len, dtype=score_dtype))
    keys, cons = gather_bm25_contrib(block_docids, block_tfs, sel_blocks,
                                     sel_weights, doc_lens, masks, mask_ids,
                                     avg, k1, b)
    sk, perm = torch.sort(keys, dim=1, stable=True)
    x = torch.gather(cons, 1, perm)
    x = doubling_scan(sk, x, V1_MAX_RUN)
    cand, _ = _run_last_candidates(sk, x)
    c = min(CAND, cand.shape[1] - 1)
    vals, ids = stable_topk(cand, sk, c + 1)
    overflow = vals[:, c] + ne_bound.to(score_dtype)
    return ids[:, :c], vals[:, :c], overflow


def _essential_epilogue(patched, cand_ids, overflow, k: int):
    """Rank the patched candidates [Q, C] (rail dtype) by score desc,
    docid asc, and certify: kth (the min over the selected k in the rail
    dtype, -inf when fewer than k hits) must beat the overflow bound
    STRICTLY, or the bound is -inf. Returns packed float32 [Q, 2k+1] =
    ``[values (k) | docids (k) | ok (1)]``."""
    if patched.shape[1] < k:
        pad = k - patched.shape[1]
        patched = F.pad(patched, (0, pad), value=float("-inf"))
        cand_ids = F.pad(cand_ids, (0, pad), value=_SENTINEL)
    fin = torch.isfinite(patched)
    neg = torch.where(fin, -patched, float("inf"))
    tie = torch.where(fin, cand_ids, _SENTINEL)
    # (neg, tie) order: a stable sort by the second key, then by the first
    o1 = torch.sort(tie, dim=1, stable=True).indices
    o2 = torch.sort(torch.gather(neg, 1, o1), dim=1, stable=True).indices
    order = torch.gather(o1, 1, o2)[:, :k]
    sdt = torch.gather(patched, 1, order)
    vals = sdt.to(torch.float32)
    ids = torch.where(torch.isfinite(sdt), torch.gather(cand_ids, 1, order),
                      _SENTINEL)
    kth = torch.where(torch.isfinite(sdt), sdt, float("inf")).min(dim=1).values
    kth = torch.where(torch.isfinite(sdt[:, k - 1]), kth, float("-inf"))
    ok = (overflow < kth) | ~torch.isfinite(overflow)
    return torch.cat([vals, ids.to(torch.float32),
                      ok.to(torch.float32)[:, None]], dim=1)


def _patch(ess, ptf, ne_idf, cnorm):
    """ess + each non-essential slot's contribution, slot by slot in the
    reference's order; -inf candidates stay -inf."""
    dt = ess.dtype
    patched = ess
    idf = ne_idf.to(dt)
    for t in range(ptf.shape[1]):
        p = ptf[:, t].to(dt)
        add = torch.where(p > 0.0, idf[:, t:t + 1] * p / (p + cnorm), 0.0)
        patched = torch.where(torch.isfinite(patched), patched + add,
                              patched)
    return patched


def bm25_essential_topk_batch(
        block_docids,   # int32 [TB, B]
        block_tfs,      # float32 [TB, B]
        flat_docids,    # int32 [TB*B] (the block arrays, flat)
        flat_tfs,       # float32 [TB*B]
        sel_blocks,     # int32 [Q, NBe] essential blocks, back to back
        sel_weights,    # score_dtype [Q, NBe]
        doc_lens,       # float32 [ND]
        masks,          # bool [F_SLOTS, ND]
        mask_ids,       # int32 [Q]
        ne_start,       # int32 [Q, NE_SLOTS] flat posting offsets
        ne_len,         # int32 [Q, NE_SLOTS] (0: unused slot)
        ne_idf,         # score_dtype [Q, NE_SLOTS]
        ne_bound,       # score_dtype [Q] sum of the NE terms' bounds
        avg_len: float, k1: float, b: float, k: int,
        score_dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """The essential lane with the binary-search patch: cohort launch ->
    packed float32 [Q, 2k+1] = ``[values | ids | ok]``. A row with ok = 0
    is not certified; the caller refires it on a full lane."""
    nd = doc_lens.shape[0]
    cand_ids, ess, overflow = _essential_phase1(
        block_docids, block_tfs, sel_blocks, sel_weights, doc_lens, masks,
        mask_ids, ne_bound, avg_len, k1, b, score_dtype)
    safe = cand_ids.clamp(0, nd - 1).long()
    cnorm = _cand_norm(doc_lens, safe, avg_len, k1, b, score_dtype)
    ptf = _search_tfs(flat_docids, flat_tfs, ne_start, ne_len, cand_ids,
                      NE_SEARCH_STEPS)
    patched = _patch(ess, ptf, ne_idf, cnorm)
    return _essential_epilogue(patched, cand_ids, overflow, k)


def bm25_essential_dense_topk_batch(
        block_docids,   # int32 [TB, B]
        block_tfs,      # float32 [TB, B]
        dense_tf,       # float16 or float32 [H, ND] hot-term tf rows
        sel_blocks,     # int32 [Q, NBe]
        sel_weights,    # score_dtype [Q, NBe]
        doc_lens,       # float32 [ND]
        masks,          # bool [F_SLOTS, ND]
        mask_ids,       # int32 [Q]
        ne_row,         # int32 [Q, NE_SLOTS] dense row (-1: unused)
        ne_idf,         # score_dtype [Q, NE_SLOTS]
        ne_bound,       # score_dtype [Q]
        avg_len: float, k1: float, b: float, k: int,
        score_dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """The essential lane with the dense patch: one gather per
    non-essential slot from the [H, ND] tf table of the hottest terms
    (exact: tf counts are integers, float16 holds them to 2048). Packing
    and certificate are the binary-search op's."""
    nd = doc_lens.shape[0]
    cand_ids, ess, overflow = _essential_phase1(
        block_docids, block_tfs, sel_blocks, sel_weights, doc_lens, masks,
        mask_ids, ne_bound, avg_len, k1, b, score_dtype)
    safe = cand_ids.clamp(0, nd - 1).long()
    cnorm = _cand_norm(doc_lens, safe, avg_len, k1, b, score_dtype)
    flat = dense_tf.reshape(-1)
    rows = ne_row.long()                                   # [Q, NE]
    # int64 flat index: H * ND passes 2^31 at a few hundred rows of 2M
    idx = rows.clamp(min=0)[:, :, None] * nd + safe[:, None, :]
    ptf = torch.where(rows[:, :, None] >= 0, flat[idx].to(torch.float32),
                      0.0)
    patched = _patch(ess, ptf, ne_idf, cnorm)
    return _essential_epilogue(patched, cand_ids, overflow, k)


def bm25_candidates_rerank_batch(
        block_docids,   # int32 [TB, B]
        block_tfs,      # float32 [TB, B]
        flat_docids,    # int32 [TB*B] (the block arrays, flat)
        flat_tfs,       # float32 [TB*B]
        sel_blocks,     # int32 [Q, NB] SLOTTED, as for v2m
        sel_weights,    # float32 [Q, NB]
        doc_lens,       # float32 [ND]
        masks,          # bool [F_SLOTS, ND]
        mask_ids,       # int32 [Q]
        term_start,     # int32 [Q, MAX_T] flat posting offsets
        term_len,       # int32 [Q, MAX_T] (0 pads)
        term_idf,       # score_dtype [Q, MAX_T]
        avg_len: float, n_slots: int, k1: float, b: float, k: int,
        score_dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """The v2 lane: cohort launch -> packed float32 [Q, 2k+2], the last
    column the certificate ``ok``. Phase A finds the CAND_V2 best
    candidates in float32 through both kernels; phase B re-scores each
    candidate exactly in ``score_dtype`` by binary search in each term's
    postings and ranks by (reported float32 score desc, docid asc). A
    row with ok = 0 is not certified (a tie mass wider than CAND_V2 at
    the boundary): a caller would serve it on v1."""
    check_packed_id_limit(doc_lens.shape[0], "fastpath kernel")
    q, nb = sel_blocks.shape
    p = nb * block_docids.shape[1]
    nd = doc_lens.shape[0]
    f32 = torch.float32
    dev = sel_blocks.device

    # ---- phase A: float32 contributions, merge, scan, top CAND_V2 + 1
    keys, cons = gather_bm25_contrib(
        block_docids, block_tfs, sel_blocks, sel_weights.to(f32), doc_lens,
        masks, mask_ids, float(torch.tensor(avg_len, dtype=f32)), k1, b)
    # the merge carries the lane index; the reference merges the float32
    # contributions as the payload, but the kernel orders equal keys by
    # payload, so a float payload would reorder them. Lane order is the
    # stable sort, which is what the reference's CPU path runs.
    lane = torch.arange(p, dtype=torch.int32, device=dev)
    lane = lane.repeat(q, 1).view(q, n_slots, p // n_slots)
    mk, midx = merge_sorted_slots(keys.reshape(q, n_slots, p // n_slots),
                                  lane)
    x = torch.gather(cons, 1, midx.long())
    x = doubling_scan(mk, x, n_slots)
    cand, totals = _run_last_candidates(mk, x)
    _, cids, bound = stable_topk(cand, mk, CAND_V2, bound_slot=True)

    # ---- phase B: exact re-rank of the candidates in score_dtype
    dt = score_dtype
    # halvings that close any posting range (df <= ND)
    n_steps = max(1, (nd - 1).bit_length()) + 1
    safe = cids.clamp(0, nd - 1).long()                       # [Q, C]
    cnorm = _cand_norm(doc_lens, safe, avg_len, k1, b, dt)
    ptf = _search_tfs(flat_docids, flat_tfs, term_start, term_len, cids,
                      n_steps).to(dt)
    part = torch.where(ptf > 0.0, term_idf.to(dt)[:, :, None] * ptf
                       / (ptf + cnorm[:, None, :]), 0.0)
    # summed term by term, in the reference's order
    score = torch.zeros_like(cnorm)
    for t in range(term_start.shape[1]):
        score = score + part[:, t]
    live = masks[mask_ids.long()[:, None], safe]
    valid = (cids != _SENTINEL) & live & (score > 0.0)
    score = torch.where(valid, score, float("-inf"))
    disp = score.to(f32)
    fin = torch.isfinite(disp)
    neg = torch.where(fin, -disp, float("inf"))
    tie = torch.where(fin, cids, _SENTINEL)
    # order by (neg, tie): a stable sort by the second key, then a
    # stable sort by the first (lax.sort with num_keys=2 in the
    # reference)
    o1 = torch.sort(tie, dim=1, stable=True).indices
    o2 = torch.sort(torch.gather(neg, 1, o1), dim=1, stable=True).indices
    order = torch.gather(o1, 1, o2)[:, :k]
    vals = torch.gather(disp, 1, order)
    ids = torch.where(torch.isfinite(vals), torch.gather(cids, 1, order),
                      _SENTINEL)
    sdt = torch.gather(score, 1, order)
    kth = torch.where(torch.isfinite(vals), sdt, float("inf")) \
        .min(dim=1).values
    kth = torch.where(torch.isfinite(vals[:, k - 1]), kth, float("-inf"))
    # certificate: every excluded doc's true score <= bound * (1 + slack)
    # < kth; trivially certified when fewer than CAND_V2 + 1 docs matched
    bfin = torch.isfinite(bound)
    bound_up = torch.where(bfin, bound.to(dt) * (1.0 + _F32_SLACK),
                           float("-inf"))
    ok = (bound_up < kth) | ~bfin
    return _pack(vals, ids, totals, ok)
