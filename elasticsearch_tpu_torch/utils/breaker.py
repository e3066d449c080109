"""Circuit breakers: hierarchical memory accounting (a copy of the
jax-free elasticsearch_tpu/utils/breaker.py).

Mirrors the reference's hierarchical circuit-breaker service (ref:
indices/breaker/HierarchyCircuitBreakerService.java, common/breaker/
ChildMemoryCircuitBreaker.java): child breakers (request, fielddata,
in_flight_requests) each with their own limit, plus a parent limit over the
sum of the host children. The ``hbm`` child accounts device memory (the
node's resident segments, search/context.py ``DeviceSegmentCache``) under
a budget of its own. In the port only ``hbm`` is charged so far: the
host children keep the reference's limits derived from the total (and
``/_nodes/stats`` reports them), but their limit settings are a typed
400 until the host-side code that charges them is ported. The
reference's metrics and tenant sinks, its no-op breakers and its payload
sizer wait for those callers too.
"""

from __future__ import annotations

import threading
from typing import Dict

from elasticsearch_tpu_torch.common.errors import CircuitBreakingException


def _human_size(n: int) -> str:
    for unit in ("b", "kb", "mb", "gb", "tb"):
        if abs(n) < 1024 or unit == "tb":
            return f"{n:.1f}{unit}" if unit != "b" else f"{n}b"
        n /= 1024
    return f"{n}b"


class CircuitBreaker:
    PARENT = "parent"
    REQUEST = "request"
    FIELDDATA = "fielddata"
    IN_FLIGHT_REQUESTS = "in_flight_requests"
    # TPU-native child: device-resident segment/filter-mask bytes — fed
    # by DeviceSegmentCache admission (search/context.py), where passing
    # the limit applies LRU eviction pressure before tripping
    HBM = "hbm"

    def __init__(self, name: str, limit_bytes: int, overhead: float = 1.0,
                 parent: "HierarchyCircuitBreakerService" = None):
        self.name = name
        self.limit = limit_bytes
        self.overhead = overhead
        self._used = 0
        self._trip_count = 0
        self._lock = threading.Lock()
        self._parent = parent

    @property
    def used(self) -> int:
        return self._used

    @property
    def trip_count(self) -> int:
        return self._trip_count

    def add_estimate_bytes_and_maybe_break(self, bytes_: int, label: str = "") -> int:
        with self._lock:
            new_used = self._used + bytes_
            if self.limit >= 0 and new_used * self.overhead > self.limit:
                self._trip_count += 1
                raise CircuitBreakingException(
                    f"[{self.name}] Data too large, data for [{label}] would be "
                    f"[{_human_size(new_used)}/{new_used}b], which is larger than "
                    f"the limit of [{_human_size(self.limit)}/{self.limit}b]",
                    bytes_wanted=new_used, bytes_limit=self.limit)
            self._used = new_used
        if self._parent is not None:
            try:
                self._parent.check_parent_limit(label)
            except CircuitBreakingException:
                with self._lock:
                    self._used -= bytes_
                raise
        return self._used

    def add_without_breaking(self, bytes_: int) -> int:
        with self._lock:
            self._used += bytes_
            return self._used

    def release(self, bytes_: int):
        self.add_without_breaking(-bytes_)


class HierarchyCircuitBreakerService:
    """Parent limit across child breakers (ref:
    indices/breaker/HierarchyCircuitBreakerService.java)."""

    def __init__(self, total_limit_bytes: int = 4 * 1024 ** 3,
                 hbm_limit_bytes: int = None):
        self.total_limit = total_limit_bytes
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._parent_trip_count = 0
        if hbm_limit_bytes is None:
            hbm_limit_bytes = total_limit_bytes
        for name, limit in [
            (CircuitBreaker.REQUEST, int(total_limit_bytes * 0.6)),
            (CircuitBreaker.FIELDDATA, int(total_limit_bytes * 0.4)),
            (CircuitBreaker.IN_FLIGHT_REQUESTS, total_limit_bytes),
            (CircuitBreaker.HBM, hbm_limit_bytes),
        ]:
            self._breakers[name] = CircuitBreaker(name, limit, parent=self)

    def get_breaker(self, name: str) -> CircuitBreaker:
        return self._breakers[name]

    def breaker_names(self):
        return list(self._breakers)

    def check_parent_limit(self, label: str):
        # HBM is device memory, not host memory: it has its own budget
        # and doesn't consume the parent (host) allowance
        total = sum(b.used for name, b in self._breakers.items()
                    if name != CircuitBreaker.HBM)
        if self.total_limit >= 0 and total > self.total_limit:
            self._parent_trip_count += 1
            raise CircuitBreakingException(
                f"[parent] Data too large, data for [{label}] would be [{total}b], "
                f"which is larger than the limit of [{self.total_limit}b]",
                bytes_wanted=total, bytes_limit=self.total_limit)

    def stats(self) -> dict:
        host_used = sum(b.used for name, b in self._breakers.items()
                        if name != CircuitBreaker.HBM)
        return {
            "parent": {"limit_size_in_bytes": self.total_limit,
                       "estimated_size_in_bytes": host_used,
                       "tripped": self._parent_trip_count},
            **{name: {"limit_size_in_bytes": b.limit,
                      "estimated_size_in_bytes": b.used,
                      "tripped": b.trip_count}
               for name, b in self._breakers.items()},
        }


def build_breaker_service(settings_get) -> HierarchyCircuitBreakerService:
    """Construct a node breaker service from settings — the ONE place
    `indices.breaker.*.limit` parsing and defaulting lives (node.py
    reads it). An explicit 0 limit is honored (reject
    everything), not silently replaced by the default. Only the total
    and ``hbm`` limits are served: nothing in the port charges the host
    children yet, so their limit settings are a typed 400
    (``unsupported_in_slice_exception``) rather than a promise of
    protection."""
    from elasticsearch_tpu_torch.common.settings import parse_byte_size
    from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported

    for child in (CircuitBreaker.REQUEST, CircuitBreaker.FIELDDATA,
                  CircuitBreaker.IN_FLIGHT_REQUESTS):
        key = f"indices.breaker.{child}.limit"
        if settings_get(key) is not None:
            raise SliceUnsupported(
                f"[{key}]: nothing in this slice of the port charges the "
                f"[{child}] breaker; only [indices.breaker.total.limit] and "
                f"[indices.breaker.hbm.limit] are served")

    def limit(key, default):
        raw = settings_get(key)
        return parse_byte_size(raw, key) if raw is not None else default

    return HierarchyCircuitBreakerService(
        total_limit_bytes=limit("indices.breaker.total.limit",
                                4 * 1024 ** 3),
        hbm_limit_bytes=limit("indices.breaker.hbm.limit", None))
