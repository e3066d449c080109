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
