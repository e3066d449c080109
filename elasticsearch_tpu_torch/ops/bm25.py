"""BM25 scoring primitives (counterpart of elasticsearch_tpu/ops/bm25.py).

The formula matches Lucene 8's BM25Similarity with the (k1+1) numerator
constant dropped, which does not change ranking:

    idf(t)  = ln(1 + (N - df + 0.5) / (df + 0.5))
    score   = idf * tf / (tf + k1 * (1 - b + b * dl / avgdl))

Padding lanes carry ``tf = 0`` and contribute exactly 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from elasticsearch_tpu_torch.telemetry.engine import tracked_kernel

# padding docid: sorts after every real docid
_SENTINEL = 0x7FFFFFFF


def idf(doc_freq, doc_count) -> float:
    """Lucene BM25 idf (BM25Similarity.idf)."""
    return math.log(1.0 + (doc_count - doc_freq + 0.5) / (doc_freq + 0.5))


def bm25_contrib(sel_weights: torch.Tensor, tf: torch.Tensor,
                 dl: torch.Tensor, avg_len, k1: float,
                 b: float) -> torch.Tensor:
    """Per-posting BM25 contribution [..., NB, B]: THE scoring expression,
    in the dtype of its tensor operands. ``avg_len`` is a tensor of that
    dtype on the operands' device (a Python float divisor would let
    PyTorch's CUDA division multiply by a rounded reciprocal instead).
    The tf > 0 guard keeps padding lanes from 0/0."""
    norm = k1 * ((1.0 - b) + b * dl / avg_len)
    return sel_weights[..., None] * torch.where(tf > 0.0, tf / (tf + norm),
                                                0.0)


@tracked_kernel("match_mask", static_argnames=("n_docs",))
def match_mask(block_docids: torch.Tensor, block_tfs: torch.Tensor,
               sel_blocks: torch.Tensor, n_docs: int) -> torch.Tensor:
    """bool [n_docs]: docs appearing (tf > 0) in ANY selected block (the
    term/terms filters' any-of mask). A scatter of True: lanes with tf =
    0 write a dump slot past the end, so no lane needs a host-side
    filter and the duplicates all write the same value. (``index_fill_``
    takes True as a kernel argument: an indexed assignment of a Python
    value would copy it from the host and wait for the stream.)"""
    sel = sel_blocks.long()
    d = block_docids[sel].reshape(-1).long()
    hit = block_tfs[sel].reshape(-1) > 0.0
    mask = torch.zeros(n_docs + 1, dtype=torch.bool, device=d.device)
    mask.index_fill_(0, torch.where(hit, d, n_docs), True)
    return mask[:n_docs]


@tracked_kernel("match_count",
                static_argnames=("n_clauses", "n_docs"))
def match_count(block_docids: torch.Tensor, block_tfs: torch.Tensor,
                sel_blocks: torch.Tensor, clause_ids: torch.Tensor,
                n_clauses: int, n_docs: int) -> torch.Tensor:
    """int32 [n_docs]: the number of distinct clauses each doc matches
    (bool must / minimum_should_match). Each selected block carries its
    owning clause's id; presence is scattered into a [n_docs, n_clauses]
    plane (tf = 0 lanes into a dump row past the end), then summed."""
    return _clause_counts(block_docids, block_tfs, sel_blocks, clause_ids,
                          n_clauses, n_docs)


@tracked_kernel("conjunction_mask",
                static_argnames=("n_clauses", "n_docs"))
def conjunction_mask(block_docids: torch.Tensor, block_tfs: torch.Tensor,
                     sel_blocks: torch.Tensor, clause_ids: torch.Tensor,
                     n_clauses: int, n_docs: int) -> torch.Tensor:
    """bool [n_docs]: the docs that hold every one of ``n_clauses``
    terms (the positional queries' candidate filter, the reference's
    ``_conjunction_mask``): ``match_count`` >= n_clauses."""
    return _clause_counts(block_docids, block_tfs, sel_blocks, clause_ids,
                          n_clauses, n_docs) >= n_clauses


def _clause_counts(block_docids, block_tfs, sel_blocks, clause_ids,
                   n_clauses: int, n_docs: int) -> torch.Tensor:
    sel = sel_blocks.long()
    d = block_docids[sel].long()                         # [NB, B]
    hit = block_tfs[sel] > 0.0
    cid = clause_ids.long()[:, None].expand_as(d)
    present = torch.zeros((n_docs + 1) * n_clauses, dtype=torch.bool,
                          device=d.device)
    present.index_fill_(
        0, (torch.where(hit, d, n_docs) * n_clauses + cid).reshape(-1), True)
    return present.view(n_docs + 1, n_clauses)[:n_docs].sum(
        dim=1, dtype=torch.int32)


def scan_run_bound(n_terms: int, floor: int = 32) -> int:
    """``max_run`` for the doubling segmented scans: the smallest power
    of two >= max(n_terms, floor). The scan's window equals this bound
    (steps 1 .. bound/2 sum a run of exactly ``bound`` elements), and a
    doc's run holds at most one entry per term entry of its query."""
    r = floor
    while r < n_terms:
        r *= 2
    return r


def doubling_scan(keys: torch.Tensor, vals: torch.Tensor, max_run: int,
                  reduce: str = "sum") -> torch.Tensor:
    """Segmented inclusive scans over contiguous key-runs along the LAST
    axis (Hillis-Steele with the key-equality carry): steps 1, 2, 4 ...
    below ``max_run``, which must bound the longest run that is read.
    ``reduce`` is "sum" or "max"; ``vals`` may carry extra leading axes
    over which ``keys`` broadcasts.

    Each run is reduced directly, element by element, so a float32 sum
    keeps its rounding to the run's own few terms; a global prefix sum
    minus a run-start prefix (the reference's ``_segsum``) carries the
    rounding of everything before the run."""
    x = vals
    step = 1
    while step < min(max_run, keys.shape[-1]):
        prev_k = F.pad(keys[..., :-step], (step, 0), value=-1)
        same = prev_k == keys
        if reduce == "sum":
            prev_x = F.pad(x[..., :-step], (step, 0))
            x = x + torch.where(same, prev_x, 0.0)
        else:
            prev_x = F.pad(x[..., :-step], (step, 0), value=float("-inf"))
            x = torch.maximum(x, torch.where(same, prev_x, float("-inf")))
        step *= 2
    return x


@tracked_kernel("segmented_topk", static_argnames=("k", "max_run"))
def segmented_topk(keys: torch.Tensor, contribs: torch.Tensor, k: int,
                   sentinel: int, max_run: int = 32):
    """Top-k of per-key contribution sums without a dense accumulator:
    a stable sort of the (key, contribution) pairs [N] by key, each
    key-run summed by the DOUBLING scan (``doubling_scan``: runs are
    contiguous after the sort), then a stable top-k over the run totals
    at the run-last positions (the lowest key first among equal
    totals, as ``lax.top_k`` over the sorted positions gives).

    The doubling scan, not a global prefix sum, is a precision
    contract: a float32 prefix over 500K postings carries an absolute
    error of about prefix * 2^-24, which reorders top-k boundary docs,
    while summing each run's <= ``max_run`` elements directly keeps full
    float32 accuracy. ``max_run`` must bound the longest real run
    (sentinel runs are longer and never read). Keys equal to
    ``sentinel`` (padding) never win. Returns (values [k], keys [k]);
    empty slots are (-inf, sentinel)."""
    from elasticsearch_tpu_torch.ops.topk import stable_topk
    sorted_k, perm = torch.sort(keys, stable=True)
    x = doubling_scan(sorted_k, contribs[perm], max_run)
    nxt = F.pad(sorted_k[1:], (0, 1), value=-1)
    is_last = sorted_k != nxt
    cand = torch.where(is_last & (x > 0.0) & (sorted_k != sentinel), x,
                       float("-inf"))
    vals, ids = stable_topk(cand[None], sorted_k[None], k)
    vals, ids = vals[0], ids[0].to(keys.dtype)
    return vals, torch.where(torch.isfinite(vals), ids,
                             torch.full_like(ids, sentinel))


def bm25_reference_scores(postings_per_term, idfs, doc_lens, avg_len,
                          k1: float, b: float) -> np.ndarray:
    """Pure-numpy scalar BM25 in float64: ``postings_per_term`` is a list
    of (docids, tfs) arrays, one per query term, ``idfs`` the matching
    idf list. The oracle the serving path is held against."""
    scores = np.zeros(len(doc_lens), np.float64)
    for (docids, tfs), w in zip(postings_per_term, idfs):
        for d, tf in zip(docids, tfs):
            dl = doc_lens[d]
            scores[d] += w * tf / (tf + k1 * (1 - b + b * dl / avg_len))
    return scores
