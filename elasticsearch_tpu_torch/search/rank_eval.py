"""Rank evaluation: relevance metrics over rated search requests (the
port's copy of elasticsearch_tpu/search/rank_eval.py).

The reference's _rank_eval module (ref: modules/rank-eval/.../
RankEvalSpec.java, PrecisionAtK.java, RecallAtK.java,
MeanReciprocalRank.java, DiscountedCumulativeGain.java,
ExpectedReciprocalRank.java) — the in-framework harness used to verify
"matched recall" of a scoring path against a reference ranking.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException


def _rated_map(ratings: List[Dict[str, Any]]) -> Dict[str, int]:
    return {str(r["_id"]): int(r["rating"]) for r in ratings}


class Metric:
    name = "?"

    def evaluate(self, hits: List[str], ratings: Dict[str, int]) -> float:
        raise NotImplementedError

    def detail(self, hits, ratings) -> Dict[str, Any]:
        return {}


class PrecisionAtK(Metric):
    """ref: PrecisionAtK.java — relevant-in-top-k / retrieved-in-top-k."""

    name = "precision"

    def __init__(self, k: int = 10, relevant_rating_threshold: int = 1,
                 ignore_unlabeled: bool = False):
        self.k = k
        self.threshold = relevant_rating_threshold
        self.ignore_unlabeled = ignore_unlabeled

    def evaluate(self, hits, ratings):
        top = hits[: self.k]
        relevant = 0
        retrieved = 0
        for doc_id in top:
            rating = ratings.get(doc_id)
            if rating is None and self.ignore_unlabeled:
                continue
            retrieved += 1
            if rating is not None and rating >= self.threshold:
                relevant += 1
        return relevant / retrieved if retrieved else 0.0


class RecallAtK(Metric):
    """ref: RecallAtK.java — relevant-in-top-k / all-relevant."""

    name = "recall"

    def __init__(self, k: int = 10, relevant_rating_threshold: int = 1):
        self.k = k
        self.threshold = relevant_rating_threshold

    def evaluate(self, hits, ratings):
        relevant_total = sum(1 for r in ratings.values() if r >= self.threshold)
        if relevant_total == 0:
            return 0.0
        found = sum(1 for doc_id in hits[: self.k]
                    if ratings.get(doc_id, 0) >= self.threshold)
        return found / relevant_total


class MeanReciprocalRank(Metric):
    name = "mean_reciprocal_rank"

    def __init__(self, k: int = 10, relevant_rating_threshold: int = 1):
        self.k = k
        self.threshold = relevant_rating_threshold

    def evaluate(self, hits, ratings):
        for rank, doc_id in enumerate(hits[: self.k], start=1):
            if ratings.get(doc_id, 0) >= self.threshold:
                return 1.0 / rank
        return 0.0


class DiscountedCumulativeGain(Metric):
    """ref: DiscountedCumulativeGain.java — gain 2^rating - 1, log2 discount;
    optionally normalized (NDCG)."""

    name = "dcg"

    def __init__(self, k: int = 10, normalize: bool = False):
        self.k = k
        self.normalize = normalize

    @staticmethod
    def _dcg(rs: List[int]) -> float:
        return sum((2 ** r - 1) / math.log2(rank + 2)
                   for rank, r in enumerate(rs))

    def evaluate(self, hits, ratings):
        rs = [ratings.get(doc_id, 0) for doc_id in hits[: self.k]]
        dcg = self._dcg(rs)
        if not self.normalize:
            return dcg
        ideal = sorted(ratings.values(), reverse=True)[: self.k]
        idcg = self._dcg(ideal)
        return dcg / idcg if idcg > 0 else 0.0


class ExpectedReciprocalRank(Metric):
    """ref: ExpectedReciprocalRank.java — cascade model with stop
    probability (2^r - 1) / 2^max_rating."""

    name = "expected_reciprocal_rank"

    def __init__(self, maximum_relevance: int, k: int = 10):
        self.max_rel = maximum_relevance
        self.k = k

    def evaluate(self, hits, ratings):
        err = 0.0
        p_continue = 1.0
        denom = 2 ** self.max_rel
        for rank, doc_id in enumerate(hits[: self.k], start=1):
            r = ratings.get(doc_id, 0)
            stop = (2 ** r - 1) / denom
            err += p_continue * stop / rank
            p_continue *= 1 - stop
        return err


def parse_metric(spec: Dict[str, Any]) -> Metric:
    if len(spec) != 1:
        raise IllegalArgumentException("[rank_eval] exactly one metric required")
    (name, params), = spec.items()
    params = params or {}
    if name == "precision":
        return PrecisionAtK(params.get("k", 10),
                            params.get("relevant_rating_threshold", 1),
                            params.get("ignore_unlabeled", False))
    if name == "recall":
        return RecallAtK(params.get("k", 10),
                         params.get("relevant_rating_threshold", 1))
    if name == "mean_reciprocal_rank":
        return MeanReciprocalRank(params.get("k", 10),
                                  params.get("relevant_rating_threshold", 1))
    if name == "dcg":
        return DiscountedCumulativeGain(params.get("k", 10),
                                        params.get("normalize", False))
    if name == "expected_reciprocal_rank":
        return ExpectedReciprocalRank(params["maximum_relevance"],
                                      params.get("k", 10))
    raise IllegalArgumentException(f"unknown rank-eval metric [{name}]")


def rank_eval(search_fn: Callable[[Dict[str, Any]], List[str]],
              requests: List[Dict[str, Any]],
              metric_spec: Dict[str, Any]) -> Dict[str, Any]:
    """Evaluate rated requests. search_fn(body) -> ordered doc-id list.
    Returns the reference's response shape: overall metric_score +
    per-request details with unrated docs."""
    metric = parse_metric(metric_spec)
    details = {}
    scores = []
    for req in requests:
        rid = req.get("id", f"request_{len(details)}")
        ratings = _rated_map(req.get("ratings", []))
        hits = search_fn(req["request"])
        score = metric.evaluate(hits, ratings)
        scores.append(score)
        details[rid] = {
            "metric_score": score,
            "unrated_docs": [{"_id": h} for h in hits if h not in ratings],
            "hits": [{"hit": {"_id": h}, "rating": ratings.get(h)} for h in hits],
        }
    return {
        "metric_score": sum(scores) / len(scores) if scores else 0.0,
        "details": details,
    }
