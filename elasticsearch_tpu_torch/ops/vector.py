"""Dense-vector scoring: brute-force kNN as one matrix product
(counterpart of elasticsearch_tpu/ops/vector.py).

A segment's vectors live on the device as an [ND, D] slab (bfloat16 by
default, search/context.py); a cohort of queries scores as one
[Q, D] @ [D, ND] product with float32 output, then the ES score
transform, the missing and live mask and a per-row top-``cut``.

- **Float32 output from bfloat16 inputs.** ``torch.matmul`` of two
  bfloat16 tensors returns bfloat16, whose 8 mantissa bits would tie
  scores in large groups. On CUDA the product is ``torch.mm(...,
  out_dtype=torch.float32)`` (bfloat16 in, float32 accumulation and
  out) where this PyTorch has it, else the slab is upcast to float32 in
  row chunks; on the CPU it is upcast. Each product of two bfloat16
  values is exact in float32, so the routes differ only in summation
  order. ``matmul_route`` names the route a device takes.
- **A float32 slab stays float32**: no TF32 (the reference computes it
  at ``Precision.HIGHEST``).
- **Cosine** is a dot product over the pre-normalized slab; the query is
  normalized in float32 before its cast to the slab's dtype.
- **l2** keeps the expansion ``||q||^2 - 2 q.v + ||v||^2``.
- **Ties**: the top-``cut`` is ops/topk.py ``stable_topk``: among equal
  scores the lowest docid first, as ``lax.top_k`` gives.

The slab is built by ``prepare_vectors`` in row chunks: the norms on the
host with the reference's own ``np.linalg.norm`` (a per-row reduction,
so a chunk gives the same values), the division on the device (IEEE) and
the cast with round-to-nearest-even, so its bits equal the reference's
host-built slab. ``exact_rerank_scores`` is the host float32 re-rank the
quantized slab's nominations go through.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.ops.topk import stable_topk
from elasticsearch_tpu_torch.telemetry.engine import tracked_kernel

# slab rows per chunk: of the host norms and the upload when the slab is
# built, and of the float32 upcast when the product is upcast
ROW_CHUNK = 1 << 18


def host_norms(vectors: np.ndarray) -> np.ndarray:
    """float32 [N]: ``np.linalg.norm(vectors, axis=1)`` computed per row
    chunk (the same per-row values, without a full-size temporary)."""
    out = np.empty(vectors.shape[0], np.float32)
    for lo in range(0, vectors.shape[0], ROW_CHUNK):
        out[lo:lo + ROW_CHUNK] = np.linalg.norm(
            vectors[lo:lo + ROW_CHUNK], axis=1)
    return out


def prepare_vectors(vectors: np.ndarray, similarity: str,
                    dtype: torch.dtype, device: torch.device,
                    n_rows: int) -> Tuple[torch.Tensor, np.ndarray]:
    """(slab [n_rows, D] ``dtype`` on ``device``, norms float32 [N] on
    the host) of the float32 host ``vectors`` [N, D]; rows past N are
    zero. For cosine the slab is pre-normalized (zero vectors stay
    zero)."""
    n, d = vectors.shape
    norms = host_norms(vectors)
    safe = np.where(norms > 0, norms, np.float32(1.0))
    slab = torch.zeros((n_rows, d), dtype=dtype, device=device)
    for lo in range(0, n, ROW_CHUNK):
        hi = min(n, lo + ROW_CHUNK)
        rows = torch.from_numpy(vectors[lo:hi]).to(device)
        if similarity == "cosine":
            rows = rows / torch.from_numpy(safe[lo:hi]).to(device)[:, None]
        slab[lo:hi] = rows.to(dtype)
    return slab, norms


@functools.lru_cache(maxsize=None)
def _mm_out_dtype(device: torch.device) -> bool:
    """Whether ``torch.mm(bf16, bf16, out_dtype=torch.float32)`` runs on
    ``device`` in this PyTorch (asked once per device)."""
    if device.type != "cuda":
        return False
    a = torch.ones((2, 8), dtype=torch.bfloat16, device=device)
    try:
        out = torch.mm(a, a.T, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return False
    return out.dtype == torch.float32


def matmul_route(slab: torch.Tensor) -> str:
    """The product route a slab takes: "float32" (a float32 slab),
    "mm_out_dtype" or "upcast"."""
    if slab.dtype == torch.float32:
        return "float32"
    return "mm_out_dtype" if _mm_out_dtype(slab.device) else "upcast"


def _product_f32(q: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    """q [Q, D] @ slab [ND, D]^T -> float32 [Q, ND]; ``q`` already in the
    slab's dtype."""
    route = matmul_route(slab)
    if route == "float32":
        return q @ slab.T
    if route == "mm_out_dtype":
        return torch.mm(q, slab.T, out_dtype=torch.float32)
    q32 = q.to(torch.float32)
    out = torch.empty((q.shape[0], slab.shape[0]), dtype=torch.float32,
                      device=slab.device)
    for lo in range(0, slab.shape[0], ROW_CHUNK):
        out[:, lo:lo + ROW_CHUNK] = \
            q32 @ slab[lo:lo + ROW_CHUNK].to(torch.float32).T
    return out


@tracked_kernel("dot_scores")
def dot_scores(queries: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """queries [Q, D] float32, vectors [ND, D] (bfloat16 or float32) ->
    [Q, ND] float32."""
    return _product_f32(queries.to(vectors.dtype), vectors)


@tracked_kernel("cosine_scores")
def cosine_scores(queries: torch.Tensor,
                  unit_vectors: torch.Tensor) -> torch.Tensor:
    """Cosine against the pre-normalized slab: the queries are
    normalized in float32 first."""
    qn = torch.linalg.vector_norm(queries, dim=1, keepdim=True)
    q = queries / torch.where(qn > 0, qn, 1.0)
    return dot_scores(q, unit_vectors)


@tracked_kernel("l2_scores")
def l2_scores(queries: torch.Tensor, vectors: torch.Tensor,
              doc_sq_norms: torch.Tensor) -> torch.Tensor:
    """Negated squared L2 distance (higher = closer) through the
    ||q||^2 - 2 q.v + ||v||^2 expansion, so the product stays one
    matrix product."""
    dots = dot_scores(queries, vectors)
    q_sq = torch.sum(queries * queries, dim=1, keepdim=True)
    return -(q_sq - 2.0 * dots + doc_sq_norms[None, :])


@tracked_kernel("similarity_scores", static_argnames=("similarity",))
def similarity_scores(queries: torch.Tensor, vectors: torch.Tensor,
                      sq_norms: torch.Tensor, similarity: str) \
        -> torch.Tensor:
    """The ES kNN score of every slab row for each query [Q, D]: cosine
    and dot_product -> (1 + raw) / 2, l2_norm -> 1 / (1 + d^2).
    float32 [Q, ND]."""
    if similarity == "cosine":
        return (1.0 + cosine_scores(queries, vectors)) / 2.0
    if similarity == "dot_product":
        return (1.0 + dot_scores(queries, vectors)) / 2.0
    neg_sq = l2_scores(queries, vectors, sq_norms)
    return 1.0 / (1.0 - neg_sq)


def exact_rerank_scores(cand: np.ndarray, q32: np.ndarray,
                        similarity: str) -> np.ndarray:
    """Host exact-float32 scores (ES transforms included) of the
    candidate vectors ``cand`` [C, D] for the query ``q32`` [D]: the
    quantized slab only nominates; the candidates rank on these."""
    cand = cand.astype(np.float32)
    if similarity == "cosine":
        nrm = np.linalg.norm(cand, axis=1) * np.linalg.norm(q32)
        sim = cand @ q32 / np.where(nrm > 0, nrm, 1.0)
        return ((1.0 + sim) / 2.0).astype(np.float32)
    if similarity == "dot_product":
        return ((1.0 + cand @ q32) / 2.0).astype(np.float32)
    d2 = ((cand - q32[None, :]) ** 2).sum(axis=1)
    return (1.0 / (1.0 + d2)).astype(np.float32)


@tracked_kernel("knn_nominate_batch",
                static_argnames=("similarity", "cut"))
def knn_nominate_batch(queries: torch.Tensor, vectors: torch.Tensor,
                       sq_norms: torch.Tensor, has_value: torch.Tensor,
                       live: torch.Tensor, similarity: str,
                       cut: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch for a cohort of kNN queries [Q, D] float32 against a
    slab [ND, D]: the similarity product, the ES transform, the missing
    (``has_value``) and deleted (``live``) mask, both bool [ND], and the
    per-row stable top-``cut``. Returns (scores float32 [Q, cut], docids
    int32 [Q, cut]); a slot past the docs that pass is (-inf,
    _SENTINEL)."""
    scores = similarity_scores(queries, vectors, sq_norms, similarity)
    scores = torch.where((has_value & live)[None, :], scores,
                         float("-inf"))
    docids = torch.arange(scores.shape[1], dtype=torch.int32,
                          device=scores.device)[None].expand_as(scores)
    return stable_topk(scores, docids, cut)
