"""BigArrays: breaker-accounted array allocation (a copy of the jax-free
elasticsearch_tpu/utils/bigarrays.py).

Mirrors Elasticsearch's BigArrays/PageCacheRecycler
(common/util/BigArrays.java): allocations are accounted against a circuit
breaker before being handed out, and released back on close. Here the
arrays are numpy host buffers read back from the card (``adopt``), so the
accounting guards host memory the way BigArrays guards the JVM heap.
"""

from __future__ import annotations

import numpy as np

from elasticsearch_tpu_torch.utils.breaker import (
    CircuitBreaker,
    HierarchyCircuitBreakerService,
    NoneCircuitBreakerService,
)


class AccountedArray:
    """A numpy array whose bytes are registered with a circuit breaker."""

    def __init__(self, array: np.ndarray, bigarrays: "BigArrays"):
        self.array = array
        self._bigarrays = bigarrays
        self._released = False

    @property
    def nbytes(self) -> int:
        return self.array.nbytes

    def close(self):
        if not self._released:
            self._bigarrays._release(self.array.nbytes)
            self._released = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BigArrays:
    def __init__(self, breaker_service: HierarchyCircuitBreakerService = None,
                 breaker_name: str = CircuitBreaker.REQUEST):
        self._service = breaker_service or NoneCircuitBreakerService()
        self._breaker = self._service.get_breaker(breaker_name)

    def new_array(self, shape, dtype, label: str = "array") -> AccountedArray:
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        self._breaker.add_estimate_bytes_and_maybe_break(nbytes, label)
        try:
            arr = np.zeros(shape, dtype=dtype)
        except MemoryError:
            self._breaker.release(nbytes)
            raise
        return AccountedArray(arr, self)

    def adopt(self, array: np.ndarray, label: str = "array") -> AccountedArray:
        """Account an existing array."""
        self._breaker.add_estimate_bytes_and_maybe_break(array.nbytes, label)
        return AccountedArray(array, self)

    def _release(self, nbytes: int):
        self._breaker.release(nbytes)

    @classmethod
    def non_breaking(cls) -> "BigArrays":
        return cls(NoneCircuitBreakerService())
