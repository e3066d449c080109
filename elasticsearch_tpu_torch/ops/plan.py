"""Packed-readback id helpers (counterpart of the id packing in
elasticsearch_tpu/ops/plan.py).

Serving kernels return docids as float32 casts inside one packed float32
array, so a cohort pays one device-to-host copy. A float32 holds every
integer below 2^24 exactly; that is the ceiling on padded doc counts.
"""

from __future__ import annotations

import numpy as np

PACKED_ID_LIMIT = 1 << 24


def check_packed_id_limit(nd: int, where: str) -> None:
    """Enforce the ``nd < 2^24`` float-pack invariant loudly at build /
    register time (a violation later would corrupt docids silently)."""
    if nd >= PACKED_ID_LIMIT:
        raise ValueError(
            f"{where}: {nd} docs (padded) >= 2^24 — float32-packed "
            f"readback ids would lose precision; shard the corpus further")


def unpack_ids(buf: np.ndarray) -> np.ndarray:
    """Float-packed int lanes -> int32, sentinel-safe. The sentinel
    rides as 2^31 exactly, which float32 can represent but int32 cannot:
    widen to int64 first, then clip, then narrow."""
    return np.clip(buf.astype(np.int64), 0, 0x7FFFFFFF).astype(np.int32)
