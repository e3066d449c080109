"""Mergeable quantile sketches for the percentile agg family (a copy of
elasticsearch_tpu/search/sketches.py, which imports no JAX).

The reference reduces percentile-family aggs by merging per-shard
TDigest states on the coordinator (ref: InternalTDigestPercentiles /
org.elasticsearch.search.aggregations.metrics.TDigestState — the
AVL/merging digest of Dunning & Ertl). This engine previously carried
the RAW SAMPLE across the agg tree (the ``_values`` ndarray on a
percentiles result) — unbounded memory per shard, and nothing that
could legally cross the wire to a coordinator. This module is the
bounded-memory replacement:

- ``TDigest`` holds at most ``compression`` weighted centroids sorted
  by mean (f64), plus exact min/max/count. Memory is
  ``O(compression)`` regardless of input size.
- **Exact mode**: while every centroid is a singleton (weight 1) and
  the count fits the budget, ``quantile`` is numpy's default linear
  interpolation and ``cdf``/``mad`` are exact — so small corpora (and
  every pre-existing test) produce bit-for-bit the results the raw
  sample produced. Merging exact digests whose combined size fits the
  budget stays exact, which makes shard-split invariance EXACT below
  the budget and bounded-error above it.
- **Compressed mode** (count > budget): centroids merge under the k1
  scale function ``k(q) = c/(2π)·asin(2q−1)`` — more resolution at the
  tails, the classic TDigest trade. Quantile error is bounded by the
  widest centroid's q-span: O(1/compression) in the middle, tighter at
  the tails (documented in COMPONENTS.md "Distributed aggregations").

The compression pass is fully vectorized (sort + cumsum + bincount —
no per-point Python), so building a digest over millions of values is
one numpy pass, and merging two digests touches only
O(compression) centroids.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

# default centroid budget (the reference's TDigest compression default
# is 100; this engine defaults higher — centroids are 16 bytes, so 256
# costs 4 KiB per sketch and halves mid-quantile error)
DEFAULT_COMPRESSION = 256


class TDigest:
    """A merging t-digest: ≤ ``compression`` centroids, exact min/max."""

    __slots__ = ("means", "weights", "min", "max", "compression")

    def __init__(self, means: np.ndarray, weights: np.ndarray,
                 mn: Optional[float], mx: Optional[float],
                 compression: int = DEFAULT_COMPRESSION):
        self.means = np.asarray(means, np.float64)
        self.weights = np.asarray(weights, np.float64)
        self.min = mn
        self.max = mx
        self.compression = int(compression)

    # ------------------------------------------------------------ build

    @classmethod
    def empty(cls, compression: int = DEFAULT_COMPRESSION) -> "TDigest":
        return cls(np.zeros(0), np.zeros(0), None, None, compression)

    @classmethod
    def from_values(cls, values,
                    compression: int = DEFAULT_COMPRESSION) -> "TDigest":
        vals = np.asarray(values, np.float64).ravel()
        if vals.size == 0:
            return cls.empty(compression)
        vals = np.sort(vals)
        mn, mx = float(vals[0]), float(vals[-1])
        if vals.size <= compression:
            # exact mode: one singleton centroid per sample
            return cls(vals.copy(), np.ones(vals.size), mn, mx,
                       compression)
        means, weights = _compress(vals, np.ones(vals.size), compression)
        return cls(means, weights, mn, mx, compression)

    # ------------------------------------------------------------ state

    @property
    def count(self) -> float:
        return float(self.weights.sum())

    def is_empty(self) -> bool:
        return self.means.size == 0

    def is_exact(self) -> bool:
        """True while the digest is a losslessly-held sample."""
        return bool(self.means.size <= self.compression
                    and (self.weights == 1.0).all())

    def nbytes(self) -> int:
        """Accounting size (breaker charges): centroid arrays + header."""
        return int(self.means.nbytes + self.weights.nbytes + 64)

    # ------------------------------------------------------------ merge

    def merge(self, other: "TDigest") -> "TDigest":
        return TDigest.merge_all([self, other], self.compression)

    @staticmethod
    def merge_all(digests: Iterable["TDigest"],
                  compression: Optional[int] = None) -> "TDigest":
        """Associative-by-value merge: concatenate centroids, re-sort,
        compress only past the budget (so exact stays exact)."""
        ds = [d for d in digests if d is not None and not d.is_empty()]
        if compression is None:
            compression = (max(d.compression for d in ds)
                           if ds else DEFAULT_COMPRESSION)
        if not ds:
            return TDigest.empty(compression)
        means = np.concatenate([d.means for d in ds])
        weights = np.concatenate([d.weights for d in ds])
        order = np.argsort(means, kind="stable")
        means, weights = means[order], weights[order]
        mn = min(d.min for d in ds)
        mx = max(d.max for d in ds)
        if means.size > compression:
            means, weights = _compress(means, weights, compression)
        return TDigest(means, weights, mn, mx, compression)

    # -------------------------------------------------------- estimates

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` in [0, 100] — PERCENT, matching the
        agg bodies. Exact mode reproduces ``np.percentile(sample, q)``
        (linear interpolation); compressed mode interpolates between
        centroid midpoints, clamped to the exact min/max."""
        if self.is_empty():
            return None
        p = float(q) / 100.0
        p = min(max(p, 0.0), 1.0)
        if self.is_exact():
            return float(np.percentile(self.means, p * 100.0))
        w = self.weights
        total = w.sum()
        target = p * total
        # centroid "centers" in cumulative-weight space
        cum = np.cumsum(w)
        centers = cum - w / 2.0
        if target <= centers[0]:
            # below the first center: interpolate min → first mean
            if w[0] <= 1.0 or centers[0] <= 0:
                return float(self.min)
            f = target / centers[0]
            return float(self.min + f * (self.means[0] - self.min))
        if target >= centers[-1]:
            tail = total - centers[-1]
            if w[-1] <= 1.0 or tail <= 0:
                return float(self.max)
            f = (target - centers[-1]) / tail
            return float(self.means[-1] + f * (self.max - self.means[-1]))
        i = int(np.searchsorted(centers, target, side="right")) - 1
        span = centers[i + 1] - centers[i]
        f = 0.0 if span <= 0 else (target - centers[i]) / span
        return float(self.means[i] + f * (self.means[i + 1] - self.means[i]))

    def cdf(self, x: float) -> float:
        """Fraction of mass ≤ x (exact mode: exactly the sample CDF the
        raw-carrier implementation computed)."""
        if self.is_empty():
            return 0.0
        if self.is_exact():
            return float((self.means <= x).mean())
        if x < self.min:
            return 0.0
        if x >= self.max:
            return 1.0
        w = self.weights
        total = w.sum()
        cum = np.cumsum(w)
        centers = cum - w / 2.0
        if x < self.means[0]:
            span = self.means[0] - self.min
            f = 0.0 if span <= 0 else (x - self.min) / span
            return float(f * centers[0] / total)
        if x >= self.means[-1]:
            span = self.max - self.means[-1]
            f = 1.0 if span <= 0 else (x - self.means[-1]) / span
            return float((centers[-1] + f * (total - centers[-1])) / total)
        i = int(np.searchsorted(self.means, x, side="right")) - 1
        span = self.means[i + 1] - self.means[i]
        f = 0.0 if span <= 0 else (x - self.means[i]) / span
        return float((centers[i] + f * (centers[i + 1] - centers[i]))
                     / total)

    def mad(self) -> Optional[float]:
        """Median absolute deviation (ref: x-pack analytics
        MedianAbsoluteDeviationAggregator reduces a TDigest the same
        way): the weighted median of |centroid − median|. Exact on the
        exact path, centroid-resolution approximate when compressed."""
        if self.is_empty():
            return None
        med = self.quantile(50.0)
        dev = np.abs(self.means - med)
        order = np.argsort(dev, kind="stable")
        dev, w = dev[order], self.weights[order]
        if self.is_exact():
            return float(np.median(dev))
        cum = np.cumsum(w)
        i = int(np.searchsorted(cum, w.sum() / 2.0, side="left"))
        return float(dev[min(i, dev.size - 1)])

    def data_points(self) -> np.ndarray:
        """The digest's representative points (exact mode: the sample
        itself) — used by boxplot's whisker clamp."""
        return self.means

    # -------------------------------------------------------------- wire

    def to_wire(self) -> Dict[str, Any]:
        return {"c": self.compression,
                "mn": self.min, "mx": self.max,
                "m": [float(v) for v in self.means],
                "w": [float(v) for v in self.weights]}

    @classmethod
    def from_wire(cls, payload: Optional[Dict[str, Any]]) -> "TDigest":
        if not payload or not payload.get("m"):
            return cls.empty((payload or {}).get(
                "c", DEFAULT_COMPRESSION))
        return cls(np.asarray(payload["m"], np.float64),
                   np.asarray(payload["w"], np.float64),
                   payload.get("mn"), payload.get("mx"),
                   payload.get("c", DEFAULT_COMPRESSION))


def _compress(means: np.ndarray, weights: np.ndarray,
              compression: int):
    """One vectorized merging pass under the k1 scale function: assign
    each (sorted) centroid to the k-bucket of its cumulative-weight
    midpoint, then aggregate buckets with weighted bincounts."""
    total = weights.sum()
    cum = np.cumsum(weights)
    q_mid = (cum - weights / 2.0) / total
    # k1 scale: k(q) = (c/2π)·(asin(2q−1) + π/2) ∈ [0, c/2]·(2/π)… the
    # constant factor only sets the bucket count ≈ compression
    k = (compression / (2.0 * math.pi)) * (
        np.arcsin(np.clip(2.0 * q_mid - 1.0, -1.0, 1.0)) + math.pi / 2.0)
    ids = np.floor(k).astype(np.int64)
    # monotone ids (floor of a monotone function is monotone) → dense
    ids = np.cumsum(np.r_[0, (np.diff(ids) > 0).astype(np.int64)])
    nb = int(ids[-1]) + 1
    w_out = np.bincount(ids, weights=weights, minlength=nb)
    m_out = np.bincount(ids, weights=weights * means,
                        minlength=nb) / np.maximum(w_out, 1e-300)
    return m_out, w_out


def merge_wire_digests(payloads: List[Optional[Dict[str, Any]]],
                       compression: Optional[int] = None
                       ) -> Dict[str, Any]:
    """Merge wire-form digests (coordinator partial reduce) without the
    caller touching TDigest instances."""
    merged = TDigest.merge_all(
        [TDigest.from_wire(p) for p in payloads if p], compression)
    return merged.to_wire()
