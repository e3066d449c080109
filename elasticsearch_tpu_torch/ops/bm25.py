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
    filter and the duplicates all write the same value."""
    sel = sel_blocks.long()
    d = block_docids[sel].reshape(-1).long()
    hit = block_tfs[sel].reshape(-1) > 0.0
    mask = torch.zeros(n_docs + 1, dtype=torch.bool, device=d.device)
    mask[torch.where(hit, d, n_docs)] = True
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
    sel = sel_blocks.long()
    d = block_docids[sel].long()                         # [NB, B]
    hit = block_tfs[sel] > 0.0
    cid = clause_ids.long()[:, None].expand_as(d)
    present = torch.zeros((n_docs + 1) * n_clauses, dtype=torch.bool,
                          device=d.device)
    present[(torch.where(hit, d, n_docs) * n_clauses + cid).reshape(-1)] = \
        True
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
