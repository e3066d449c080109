"""Feature-column scoring (counterpart of the device part of
elasticsearch_tpu/search/queries.py ``TextExpansionQuery``): a weighted
sum over a stack of numeric doc-value columns, one PyTorch op over the
[T, ND] plane rather than one per token."""

from __future__ import annotations

from typing import Tuple

import torch

from elasticsearch_tpu_torch.telemetry.engine import tracked_kernel


@tracked_kernel("feature_plane_sum")
def feature_plane_sum(plane: torch.Tensor, missing: torch.Tensor,
                      weights: torch.Tensor) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(float32 scores [ND], bool any-present [ND]) of ``plane`` float32
    [T, ND] (T feature columns), ``missing`` bool [T, ND] and
    ``weights`` float32 [T]: score = the sum over t of weights[t] x
    plane[t] where present, the reference's float32
    ``einsum("t,tn->n", w, where(present, plane, 0))``. The card and the
    CPU reduce in other orders, so their scores agree to float32
    rounding, not bit for bit."""
    scores = torch.mv(plane.masked_fill(missing, 0.0).t(), weights)
    return scores, ~missing.all(dim=0)
