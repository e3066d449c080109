"""Positional (phrase) matching over token streams (a copy of the
jax-free elasticsearch_tpu/search/phrase.py).

The split of Lucene's PhraseQuery (ExactPhraseMatcher and
SloppyPhraseMatcher): the device filters, a conjunctive match over the
phrase's terms through the postings blocks (ops/bm25.py
``conjunction_mask``), and positions are verified here on the host, in
numpy, over only the surviving candidates' token-stream rows
(index/segment.py ``TokenStreams``).

Scoring is Lucene's: the phrase scores as a pseudo-term with tf = the
phrase frequency and weight = the sum of its member terms' idfs
(Lucene's PhraseWeight sums the TermStatistics of all its terms).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def exact_phrase_freqs(tokens: np.ndarray,      # int32 [C, L] candidate rows
                       term_ids: Sequence[int]  # phrase term ids, len P >= 1
                       ) -> np.ndarray:
    """Phrase occurrence count per candidate row (slop = 0), vectorized:
    an occurrence at position p is ``all_j tokens[:, p+j] == term_ids[j]``."""
    C, L = tokens.shape
    P = len(term_ids)
    if L < P:
        return np.zeros(C, np.int64)
    n_pos = L - P + 1
    match = np.ones((C, n_pos), bool)
    for j, tid in enumerate(term_ids):
        match &= tokens[:, j : j + n_pos] == tid
    return match.sum(axis=1)


def sloppy_phrase_freqs(tokens: np.ndarray, lengths: np.ndarray,
                        term_ids: Sequence[int], slop: int,
                        last_alternatives: Optional[Sequence[int]] = None
                        ) -> np.ndarray:
    """Sloppy phrase frequency per candidate row.

    Greedy alignment: for each occurrence p0 of the first term, each later
    term j must appear at an UNUSED position q with ``|q - j - p0| <= slop``
    (the nearest such q is taken and consumed — repeated terms need
    distinct positions, as in Lucene's SloppyPhraseMatcher). Covers
    in-order and moved-within-slop matches without Lucene's full alignment
    search. ``last_alternatives`` extends the final slot to an any-of set
    (the match_phrase_prefix expansion).
    """
    if slop <= 0 and last_alternatives is None:
        return exact_phrase_freqs(tokens, term_ids)
    C = tokens.shape[0]
    freqs = np.zeros(C, np.int64)
    n_slots = len(term_ids) + (1 if last_alternatives is not None else 0)
    for c in range(C):
        row = tokens[c, : lengths[c]]
        positions: List[np.ndarray] = [np.nonzero(row == tid)[0]
                                       for tid in term_ids]
        if last_alternatives is not None:
            positions.append(np.nonzero(np.isin(row, last_alternatives))[0])
        if any(len(p) == 0 for p in positions):
            continue
        count = 0
        for p0 in positions[0]:
            used = {int(p0)}
            ok = True
            for j in range(1, n_slots):
                target = p0 + j
                best = None
                for q in positions[j]:
                    qi = int(q)
                    if qi in used or abs(qi - target) > slop:
                        continue
                    if best is None or abs(qi - target) < abs(best - target):
                        best = qi
                if best is None:
                    ok = False
                    break
                used.add(best)
            if ok:
                count += 1
        freqs[c] = count
    return freqs


def phrase_prefix_freqs(tokens: np.ndarray,
                        term_ids: Sequence[int],
                        last_term_ids: Sequence[int]) -> np.ndarray:
    """match_phrase_prefix: fixed prefix terms followed by ANY of
    ``last_term_ids`` (the prefix expansions of the final token)."""
    C, L = tokens.shape
    P = len(term_ids) + 1
    if L < P or not last_term_ids:
        return np.zeros(C, np.int64)
    n_pos = L - P + 1
    match = np.ones((C, n_pos), bool)
    for j, tid in enumerate(term_ids):
        match &= tokens[:, j : j + n_pos] == tid
    j = len(term_ids)
    last = np.zeros((C, n_pos), bool)
    window = tokens[:, j : j + n_pos]
    for tid in last_term_ids:
        last |= window == tid
    match &= last
    return match.sum(axis=1)
