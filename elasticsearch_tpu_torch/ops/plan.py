"""Fused query-plan top-k (counterpart of elasticsearch_tpu/ops/plan.py),
the plan path's device program, and the packed-readback helpers.

A boolean query tree executes as ONE sorted segmented-reduction program
over the query's postings, batched over a leading [Q] axis of queries
(the reference vmaps a single-query body; here every tensor carries the
query axis, and the single-query ``plan_topk`` is Q = 1):

  1. gather the selected postings blocks of every clause, tagging each
     posting with (group, subgroup): a group is one bool clause (a match,
     a term filter, ...), a subgroup one term within it;
  2. sort by (docid, group, subgroup): one int64 key
     ``docid << 32 | group << 16 | subgroup`` through a stable
     ``torch.sort``, the contributions gathered through the permutation
     (the reference's three-key ``lax.sort``);
  3. segmented reductions over the sorted runs give, per (doc, group),
     the distinct subgroups matched (operator=and, minimum_should_match)
     and the summed BM25 contribution; then per doc which groups are
     present, must/filter/should/must_not satisfaction and the combined
     score (sum or dis-max);
  4. a stable top-k over the per-doc run totals gives (scores, docids)
     and the exact count of matching docs.

The segmented sums are the bounded DOUBLING scan of ops/bm25.py
(``max_run = scan_run_bound(term entries)``: a doc's run holds at most
one entry per term entry), where the reference subtracts a cummax'ed
run-start prefix from a global float32 cumsum. It is the same function
with tighter rounding: each run is summed from its own few terms, not
from a prefix over the whole row. The rail is float32, as in the
reference. Dense column clauses AND in a cohort-shared ``dense_mask``;
a ``_score`` search_after cursor keeps the docs strictly below it; an
expression ``script_score`` transforms the combined score
(``script_fn``) before both and before the top-k, as in the
reference's ``plan_topk_body``. A NaN script score never ranks: it is
counted in the total and not returned, as the reference treats the NaN
its float32 arithmetic computes on the CPU (a negative NaN, which its
top-k orders below -inf).

The impact helpers at the end (``build_term_impacts``,
``select_blocks_impact``, ``select_blocks_prefix``,
``impact_safe_termination``) are host numpy, copied from the reference:
per-block BM25 upper bounds from the segment's block-max metadata (the
fast path's essential split reads each term's best one), and the
budgeted impact-ordered block selection and post-launch safe-termination
check of the reference's impact-truncated lane. The port does not serve
that lane (its answers are partial sums, relation "gte"), so only the
tests run the last three.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from elasticsearch_tpu_torch.ops.bm25 import (_SENTINEL, bm25_contrib,
                                              doubling_scan, scan_run_bound)
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.ops.topk import stable_topk
from elasticsearch_tpu_torch.telemetry.engine import tracked_kernel

MUST = 0
SHOULD = 1
FILTER = 2
MUST_NOT = 3

# group and subgroup ids share the low 32 bits of the sort key
GROUP_LIMIT = 1 << 16

PACKED_ID_LIMIT = 1 << 24


def check_packed_id_limit(nd: int, where: str) -> None:
    """Enforce the ``nd < 2^24`` float-pack invariant loudly at build /
    register time (a violation later would corrupt docids silently)."""
    if nd >= PACKED_ID_LIMIT:
        raise ValueError(
            f"{where}: {nd} docs (padded) >= 2^24 — float32-packed "
            f"readback ids would lose precision; shard the corpus further")


class FieldStream(NamedTuple):
    """One field's postings selection for a plan launch: the resident
    corpus arrays (shared by the cohort) and, per query and selected
    block, the owning (group, subgroup), the weight (idf · boost) and
    whether the block scores constant-per-match (keyword semantics)
    instead of BM25. Selections are [Q, NB] (numpy or tensors)."""

    block_docids: torch.Tensor   # int32 [TB+1, B] (with the zero block)
    block_tfs: torch.Tensor      # float32 [TB+1, B]
    doc_lens: torch.Tensor       # float32 [ND]
    avg_len: float               # shard-level average length (float32)
    sel_blocks: Any              # int32 [Q, NB]
    sel_group: Any               # int32 [Q, NB]
    sel_sub: Any                 # int32 [Q, NB]
    sel_weight: Any              # float32 [Q, NB]
    sel_const: Any               # bool [Q, NB]


def _up(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """One host array (or tensor) on ``device`` in ``dtype``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along dim 0 for any-shaped int32/int64 ``idx``."""
    out = table.index_select(0, idx.reshape(-1))
    return out.view(*idx.shape, *table.shape[1:])


def plan_topk_body(streams, group_kind, group_req, group_const, live,
                   n_must, n_filter, msm, bonus, tie,
                   k1: float, b: float, k: int, combine: str,
                   max_run: int, dense_mask=None, after_score=None,
                   script_fn=None):
    """The program on device tensors: per-query ``group_*`` [Q, G],
    ``n_must``/``n_filter``/``msm`` int32 [Q, 1], ``bonus``/``tie``
    float32 [Q, 1], streams with [Q, NB] selections on the device; the
    optional ``dense_mask`` bool [ND] is shared by the cohort, the
    optional ``after_score`` float32 [Q, 1] is each query's cursor, the
    optional ``script_fn(score [Q, L], docids [Q, L]) -> float32 [Q, L]``
    (docids clamped into the segment) is the cohort's script_score
    transform. Returns (vals float32 [Q, k], ids int32 [Q, k], total
    int32 [Q])."""
    keys, contribs = [], []
    for st in streams:
        sel = st.sel_blocks
        q = sel.shape[0]
        d = _gather_rows(st.block_docids, sel)              # [Q, NB, B]
        tf = _gather_rows(st.block_tfs, sel)
        dl = _gather_rows(st.doc_lens, d)
        # filled on the device: torch.tensor would copy from the host and
        # wait for the stream
        avg = torch.full((), st.avg_len, dtype=torch.float32,
                         device=d.device)
        w = st.sel_weight
        bm25 = bm25_contrib(w, tf, dl, avg, k1, b)
        hit = tf > 0.0
        c = torch.where(st.sel_const[..., None],
                        torch.where(hit, w[..., None], 0.0), bm25)
        valid = hit & _gather_rows(live, d)
        dkey = torch.where(valid, d, _SENTINEL).long()
        key = ((dkey << 32) | (st.sel_group.long()[..., None] << 16)
               | st.sel_sub.long()[..., None])
        keys.append(key.reshape(q, -1))
        contribs.append(torch.where(valid, c, 0.0).reshape(q, -1))
    key = torch.cat(keys, dim=1)
    skey, perm = torch.sort(key, dim=1, stable=True)
    c = torch.gather(torch.cat(contribs, dim=1), 1, perm)
    dkey = (skey >> 32).to(torch.int32)       # docid, or the sentinel
    dg = skey >> 16                           # (docid, group)

    new_sub = skey != F.pad(skey[:, :-1], (1, 0), value=-1)
    is_grp_last = dg != F.pad(dg[:, 1:], (0, 1), value=-1)
    is_doc_last = dkey != F.pad(dkey[:, 1:], (0, 1), value=-1)

    # per (doc, group): distinct subgroups matched + summed contribution
    sub_cnt, grp_score = doubling_scan(
        dg, torch.stack([new_sub.to(torch.float32), c]), max_run)

    ng = group_kind.shape[1]
    gc = ((skey >> 16) & (GROUP_LIMIT - 1)).clamp(max=ng - 1)
    kind = torch.gather(group_kind, 1, gc)
    req = torch.gather(group_req, 1, gc)
    cval = torch.gather(group_const, 1, gc)
    present = is_grp_last & (sub_cnt >= req.to(torch.float32))
    gscore = torch.where(torch.isnan(cval), grp_score, cval)
    scoring = present & ((kind == MUST) | (kind == SHOULD))

    # per doc: summed score and the present groups of each kind
    doc_score, doc_must, doc_filt, doc_should, doc_mnot = doubling_scan(
        dkey, torch.stack([
            torch.where(scoring, gscore, 0.0),
            (present & (kind == MUST)).to(torch.float32),
            (present & (kind == FILTER)).to(torch.float32),
            (present & (kind == SHOULD)).to(torch.float32),
            (present & (kind == MUST_NOT)).to(torch.float32)]), max_run)
    if combine == "dismax":
        doc_max = doubling_scan(
            dkey, torch.where(scoring, gscore, float("-inf")), max_run,
            reduce="max")
        score = torch.where(torch.isfinite(doc_max),
                            doc_max + tie * (doc_score - doc_max), 0.0)
    else:
        score = doc_score
    score = score + bonus
    nd = live.shape[0]
    if script_fn is not None:
        score = script_fn(score, dkey.clamp(max=nd - 1))

    passed = (is_doc_last & (dkey != _SENTINEL)
              & (doc_must >= n_must.to(torch.float32))
              & (doc_filt >= n_filter.to(torch.float32))
              & (doc_should >= msm.to(torch.float32))
              & (doc_mnot == 0.0))
    if dense_mask is not None:
        passed = passed & dense_mask[dkey.clamp(max=nd - 1).long()]
    if after_score is not None:
        # search_after on _score: strictly after the cursor; ties are
        # excluded, as in the dense executor
        passed = passed & (score < after_score)
    cand = torch.where(passed, score, float("-inf"))
    if script_fn is not None:
        cand = torch.where(torch.isnan(cand), float("-inf"), cand)
    vals, ids = stable_topk(cand, dkey, k)
    return vals, ids, passed.sum(dim=1, dtype=torch.int32)


def pack_result(vals: torch.Tensor, ids: torch.Tensor,
                total: torch.Tensor) -> torch.Tensor:
    """(vals [Q, k], ids [Q, k], total [Q]) -> ONE float32 [Q, 2k+1]
    buffer, so a cohort pays one device-to-host copy. Ints ride as float
    casts: float32 holds every integer < 2^24 exactly (doc ids and
    totals stay below it); the sentinel id is never read (callers mask
    by finite values first)."""
    return torch.cat([vals.to(torch.float32), ids.to(torch.float32),
                      total.to(torch.float32)[:, None]], dim=1)


def unpack_ids(buf: np.ndarray) -> np.ndarray:
    """Float-packed int lanes -> int32, sentinel-safe. The sentinel
    rides as 2^31 exactly, which float32 can represent but int32 cannot:
    widen to int64 first, then clip, then narrow."""
    return np.clip(buf.astype(np.int64), 0, 0x7FFFFFFF).astype(np.int32)


def unpack_result(buf: np.ndarray, k: int):
    """Host-side inverse of pack_result on one float32 [2k+1] row:
    (vals [k], ids int32 [k], total)."""
    return buf[:k], unpack_ids(buf[k:2 * k]), int(buf[2 * k])


@tracked_kernel("plan_topk_batch",
                static_argnames=("k", "combine", "max_run"))
def plan_topk_batch(streams, group_kind, group_req, group_const, live,
                    n_must, n_filter, msm, bonus, tie,
                    k1: float = 1.2, b: float = 0.75, k: int = 10,
                    combine: str = "sum",
                    max_run: Optional[int] = None, dense_mask=None,
                    after_score=None, script_fn=None) -> torch.Tensor:
    """Batched entry: every per-query array has a leading [Q] axis (host
    arrays go up once, here, onto ``live``'s device); the corpus arrays
    inside ``streams`` are shared, as is the optional bool [ND]
    ``dense_mask`` (one column for the whole cohort) and ``script_fn``
    (one script for the whole cohort). ``after_score`` is None or one
    cursor per query. Returns PACKED [Q, 2k+1] rows
    (pack_result): one readback serves the whole cohort. ``max_run``
    bounds a doc's run (``scan_run_bound`` of the most term entries of
    any query); by default the selection width, which is always safe."""
    dev = live.device
    sts = [st._replace(
        sel_blocks=_up(st.sel_blocks, torch.int32, dev),
        sel_group=_up(st.sel_group, torch.int32, dev),
        sel_sub=_up(st.sel_sub, torch.int32, dev),
        sel_weight=_up(st.sel_weight, torch.float32, dev),
        sel_const=_up(st.sel_const, torch.bool, dev)) for st in streams]
    if max_run is None:
        max_run = scan_run_bound(sum(st.sel_blocks.shape[1] for st in sts))

    def col(a, dtype):
        return _up(a, dtype, dev).reshape(-1, 1)
    return pack_result(*plan_topk_body(
        sts, _up(group_kind, torch.int32, dev),
        _up(group_req, torch.int32, dev),
        _up(group_const, torch.float32, dev), live,
        col(n_must, torch.int32), col(n_filter, torch.int32),
        col(msm, torch.int32), col(bonus, torch.float32),
        col(tie, torch.float32), float(k1), float(b), int(k), combine,
        int(max_run),
        None if dense_mask is None else _up(dense_mask, torch.bool, dev),
        None if after_score is None else col(after_score, torch.float32),
        script_fn))


@tracked_kernel("plan_topk",
                static_argnames=("k", "combine", "packed", "max_run"))
def plan_topk(streams, group_kind, group_req, group_const, live,
              n_must: int, n_filter: int, msm: int,
              bonus: float = 0.0, tie: float = 0.0,
              k1: float = 1.2, b: float = 0.75, k: int = 10,
              combine: str = "sum", packed: bool = False,
              max_run: Optional[int] = None, dense_mask=None,
              after_score: Optional[float] = None, script_fn=None):
    """Single-query entry (Q = 1): streams carry [NB] selections and the
    group arrays are [G]; ``dense_mask`` (bool [ND]), ``after_score``
    and ``script_fn`` as in ``plan_topk_batch``. Returns (vals [k],
    ids [k], total) tensors, or ONE packed [2k+1] tensor with
    ``packed=True``."""
    def row(a):
        return a[None] if isinstance(a, torch.Tensor) else np.asarray(a)[None]
    sts = [st._replace(sel_blocks=row(st.sel_blocks),
                       sel_group=row(st.sel_group), sel_sub=row(st.sel_sub),
                       sel_weight=row(st.sel_weight),
                       sel_const=row(st.sel_const)) for st in streams]
    out = plan_topk_batch(
        sts, row(group_kind), row(group_req), row(group_const), live,
        [n_must], [n_filter], [msm], [bonus], [tie], k1=k1, b=b, k=k,
        combine=combine, max_run=max_run, dense_mask=dense_mask,
        after_score=None if after_score is None else [after_score],
        script_fn=script_fn)[0]
    if packed:
        return out
    return out[:k], out[k:2 * k].to(torch.int64).clamp(
        max=_SENTINEL).to(torch.int32), out[2 * k].to(torch.int32)


# ---------------------------------------------------------------------------
# The dense executor's scorer
# ---------------------------------------------------------------------------

def _run_last_scatter_indices(dkey: torch.Tensor, is_last: torch.Tensor,
                              nd: int) -> torch.Tensor:
    """Scatter targets of a sorted run: each run-last lane writes its
    docid; every other lane writes the dump slot ``nd`` past the end,
    which the caller cuts off (the reference gives each such lane its own
    out-of-bounds slot and drops them)."""
    return torch.where(is_last & (dkey != _SENTINEL), dkey,
                       nd).to(torch.int64)


@tracked_kernel("bm25_dense_scores_sorted", static_argnames=("max_run",))
def bm25_dense_scores_sorted(block_docids, block_tfs, sel_blocks,
                             sel_weights, doc_lens, avg_len: float,
                             k1: float, b: float, max_run: int = 32,
                             mask_row=None) -> torch.Tensor:
    """Dense per-doc BM25 scores float32 [ND] of the selected blocks
    (``sel_blocks`` int32 [NB], ``sel_weights`` float32 [NB], padded
    with the zero block at weight 0): 0.0 where a doc matches nothing.

    The gather and contribution run in the contribution kernel
    (``gather_bm25_contrib``) as a cohort of one query whose mask row
    ``mask_row`` (bool [1, ND], every doc: the dense scorer does not
    mask by liveness) is all true, giving the reference's ``dkey``/``c``
    before its sort; then a stable sort by docid, the doubling scan
    (``max_run`` must bound the term instances of one doc: callers pass
    ``scan_run_bound(n_terms)``) and one scatter of the run-last lanes.
    ``avg_len`` is the shard's average field length (rounded to float32
    here, as the reference's ``jnp.float32``)."""
    nd = doc_lens.shape[0]
    dev = doc_lens.device
    if mask_row is None:
        mask_row = torch.ones((1, nd), dtype=torch.bool, device=dev)
    sel = _up(sel_blocks, torch.int32, dev).reshape(1, -1).contiguous()
    w = _up(sel_weights, torch.float32, dev).reshape(1, -1).contiguous()
    keys, contrib = gather_bm25_contrib(
        block_docids, block_tfs, sel, w, doc_lens, mask_row,
        torch.zeros(1, dtype=torch.int32, device=dev),
        float(np.float32(avg_len)), k1, b)
    dkey, perm = torch.sort(keys[0], stable=True)
    x = doubling_scan(dkey, contrib[0][perm], max_run)
    is_last = dkey != F.pad(dkey[1:], (0, 1), value=-1)
    scores = torch.zeros(nd + 1, dtype=torch.float32, device=dev)
    scores[_run_last_scatter_indices(dkey, is_last, nd)] = x
    return scores[:nd]


# ---------------------------------------------------------------------------
# Impact-ordered block selection (host numpy): the per-block BM25 upper
# bound is the block-max saturation at the block's minimum length times
# the term's idf; a term's blocks in descending bound order let a budget
# keep the blocks that can contribute most, and the largest bound left
# out bounds what any doc can still gain.
# ---------------------------------------------------------------------------


class TermImpacts(NamedTuple):
    """Registration-time impact metadata for one postings field."""

    ub: np.ndarray        # float64 [TB] per-block score upper bound
    order: np.ndarray     # int32 [TB] impact-sorted block ids per term
    ub_desc: np.ndarray   # float64 [TB] bounds in `order`'s layout


def build_term_impacts(starts, counts, block_max_tf, block_min_len,
                       idf, avg_len: float, k1: float,
                       b: float) -> TermImpacts:
    """Per-block BM25 upper bounds + per-term impact ordering.

    The bound is the block-max saturation at the block's minimum length
    times the term's idf: the most ANY doc in the block can contribute
    (the θ-warm lanes' ``maxc`` is its per-term max). Empty blocks (max
    tf 0) bound to 0."""
    starts = np.asarray(starts, np.int64)
    counts = np.asarray(counts, np.int64)
    mtf = np.asarray(block_max_tf, np.float64)
    mln = np.asarray(block_min_len, np.float64)
    sat = np.where(mtf > 0,
                   mtf / (mtf + k1 * (1.0 - b + b * mln / avg_len)), 0.0)
    tb = mtf.shape[0]
    # the term owning each block: the packed layout is contiguous and
    # gap-free (index/segment.py builds starts as the exact cumsum of
    # counts); a gap would silently shift every term's range
    if int(counts.sum()) != tb:
        raise ValueError(
            f"packed block layout violated: sum(counts)="
            f"{int(counts.sum())} != n_blocks={tb}")
    term_of = np.repeat(np.arange(len(counts)), counts)
    ub = sat * np.asarray(idf, np.float64)[term_of]
    # impact order per term: one global stable sort of (term, -ub,
    # block); ties keep block (docid) order
    order = np.lexsort((np.arange(tb), -ub, term_of)).astype(np.int32)
    return TermImpacts(ub=ub, order=order, ub_desc=ub[order])


def select_blocks_impact(term_ids, budget: int, starts, counts,
                         impacts: TermImpacts):
    """Budgeted per-query block selection by descending impact.

    Returns ``(per_term, miss_bound)``: ``per_term`` a list of int32
    arrays (one per term id, ASCENDING block ids), ``miss_bound`` the sum
    over terms of the largest bound among that term's EXCLUDED blocks (a
    doc appears in at most one block per term, so no doc's true score
    exceeds its observed score by more than ``miss_bound``; an unseen
    doc is bounded by ``miss_bound`` itself). ``miss_bound`` is 0.0
    exactly when the selection is complete."""
    segs = [(int(starts[t]), int(counts[t])) for t in term_ids]
    total = sum(c for _, c in segs)
    if total <= budget:
        return ([np.arange(s, s + c, dtype=np.int32) for s, c in segs],
                0.0)
    ud = impacts.ub_desc
    cat = np.concatenate([ud[s:s + c] for s, c in segs])
    # threshold = the budget-th largest bound; strictly greater blocks
    # are all in, ties fill the remainder in term order
    thr = np.partition(cat, total - budget)[total - budget]
    n_gt = [int(np.searchsorted(-ud[s:s + c], -thr, side="left"))
            for s, c in segs]
    spare = budget - sum(n_gt)
    per_term: list = []
    miss = 0.0
    for (s, c), j in zip(segs, n_gt):
        while spare > 0 and j < c and ud[s + j] == thr:
            j += 1
            spare -= 1
        take = impacts.order[s:s + j]
        per_term.append(np.sort(take).astype(np.int32))
        if j < c:
            miss += float(ud[s + j])
    return per_term, miss


def select_blocks_prefix(term_ids, budget: int, starts, counts):
    """Posting-order baseline: each term keeps the PREFIX of its block
    list, lowest docids first, dropping tail blocks from the longest
    term until the budget fits. Same return convention as
    :func:`select_blocks_impact` minus the bound."""
    cnts = [int(counts[t]) for t in term_ids]
    while sum(cnts) > budget:
        i = int(np.argmax(cnts))
        over = sum(cnts) - budget
        cnts[i] = max(0, cnts[i] - max(1, min(over, cnts[i] // 2)))
    return [np.arange(int(starts[t]), int(starts[t]) + c, dtype=np.int32)
            for t, c in zip(term_ids, cnts)]


def impact_safe_termination(kth: float, next_best: float,
                            miss_bound: float) -> bool:
    """The block-max safe-termination check on a truncated launch's
    readback: with every doc's possible gain bounded by ``miss_bound``,
    the observed top-k SET is provably the true top-k when the best
    excluded candidate (``next_best``: the (k+1)-th observed score, or
    0.0 when fewer than k+1 docs matched) cannot close the gap to the
    kth. Observed scores stay lower bounds (relation "gte")."""
    if miss_bound <= 0.0:
        return True
    if not np.isfinite(kth):
        return False          # fewer than k hits: unseen docs could fill
    floor = max(float(next_best) if np.isfinite(next_best) else 0.0, 0.0)
    return floor + miss_bound < kth
