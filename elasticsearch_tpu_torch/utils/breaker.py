"""Circuit breakers: hierarchical memory accounting (a copy of the
jax-free elasticsearch_tpu/utils/breaker.py).

Mirrors the reference's hierarchical circuit-breaker service (ref:
indices/breaker/HierarchyCircuitBreakerService.java, common/breaker/
ChildMemoryCircuitBreaker.java): child breakers (request, fielddata,
in_flight_requests) each with their own limit, plus a parent limit over the
sum of the host children. The ``hbm`` child accounts device memory (the
node's resident segments, search/context.py ``DeviceSegmentCache``) under
a budget of its own. The ``request`` child is charged by the dense path's
host readbacks (search/searcher.py, through utils/bigarrays.py: the
aggregation mask of a segment and the top-k rows), released when the
shard's phase ends. ``fielddata`` (the reference charges it nowhere) and
``in_flight_requests`` (charged by a transport, which a single node does
not have) are reported, uncharged. A trip counts in the node's
metrics (``breaker.tripped{breaker}``) and against the ambient tenant.
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
    # device child: device-resident segment/filter-mask bytes — fed
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

    def set_limit(self, limit_bytes: int) -> None:
        """Dynamic resize (the `indices.breaker.*.limit` settings are
        dynamic in the reference; the memory-pressure fault in
        testing/faults.py shrinks limits mid-flight through this)."""
        with self._lock:
            self.limit = int(limit_bytes)

    def _on_trip(self, label: str) -> None:
        self._trip_count += 1
        svc = self._parent
        if svc is not None and svc.metrics is not None:
            svc.metrics.inc("breaker.tripped", breaker=self.name)
        if svc is not None and getattr(svc, "tenants", None) is not None:
            from elasticsearch_tpu_torch.telemetry import context as _telectx
            svc.tenants.record_breaker_trip(
                _telectx.current_tenant(), self.name)

    def add_estimate_bytes_and_maybe_break(self, bytes_: int, label: str = "") -> int:
        with self._lock:
            new_used = self._used + bytes_
            if self.limit >= 0 and new_used * self.overhead > self.limit:
                self._on_trip(label)
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


class NoneCircuitBreaker(CircuitBreaker):
    """Never breaks (ref: common/breaker/NoopCircuitBreaker.java)."""

    def __init__(self, name: str = "noop"):
        super().__init__(name, limit_bytes=-1)


class HierarchyCircuitBreakerService:
    """Parent limit across child breakers (ref:
    indices/breaker/HierarchyCircuitBreakerService.java)."""

    def __init__(self, total_limit_bytes: int = 4 * 1024 ** 3,
                 request_limit_bytes: int = None,
                 fielddata_limit_bytes: int = None,
                 hbm_limit_bytes: int = None,
                 metrics=None):
        self.total_limit = total_limit_bytes
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._parent_trip_count = 0
        # telemetry sink (MetricsRegistry or None) — `breaker.tripped`
        # counters per child, `breaker.parent.tripped` for the parent
        self.metrics = metrics
        # optional TenantAccounting sink: trips charged to the ambient
        # tenant so noisy-neighbor attribution sees who blew the budget
        self.tenants = None
        if request_limit_bytes is None:
            request_limit_bytes = int(total_limit_bytes * 0.6)
        if fielddata_limit_bytes is None:
            fielddata_limit_bytes = int(total_limit_bytes * 0.4)
        if hbm_limit_bytes is None:
            hbm_limit_bytes = total_limit_bytes
        for name, limit in [
            (CircuitBreaker.REQUEST, request_limit_bytes),
            (CircuitBreaker.FIELDDATA, fielddata_limit_bytes),
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
            if self.metrics is not None:
                self.metrics.inc("breaker.tripped", breaker="parent")
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


def payload_size_bytes(payload) -> int:
    """Byte-size estimate of an arbitrary request/operation payload for
    breaker and indexing-pressure accounting — THE shared sizer (the
    transport inbound charge and IndexingPressure both use it, so the
    two accountings can never drift): raw byte/str payloads by length,
    structured payloads by json-encoded length (proportional to the
    host memory they occupy in flight), with a conservative fallback."""
    if payload is None:
        return 0
    if isinstance(payload, (bytes, bytearray, str)):
        return len(payload)
    import json
    try:
        return len(json.dumps(payload, default=str))
    except (TypeError, ValueError):
        import sys
        return sys.getsizeof(payload)


def build_breaker_service(settings_get,
                          metrics=None) -> HierarchyCircuitBreakerService:
    """Construct a node breaker service from settings — the ONE place
    `indices.breaker.*.limit` parsing and defaulting lives (node.py
    reads it). An explicit 0 limit is honored (reject everything), not
    silently replaced by the default. As in the reference, the
    ``in_flight_requests`` child takes the total limit."""
    from elasticsearch_tpu_torch.common.settings import parse_byte_size

    def limit(key, default):
        raw = settings_get(key)
        return parse_byte_size(raw, key) if raw is not None else default

    total = limit("indices.breaker.total.limit", 4 * 1024 ** 3)
    request = limit("indices.breaker.request.limit", None)
    return HierarchyCircuitBreakerService(
        total_limit_bytes=total,
        request_limit_bytes=(request if request is not None
                             else int(total * 0.6)),
        fielddata_limit_bytes=limit("indices.breaker.fielddata.limit",
                                    None),
        hbm_limit_bytes=limit("indices.breaker.hbm.limit", None),
        metrics=metrics)


class NoneCircuitBreakerService(HierarchyCircuitBreakerService):
    def __init__(self):
        super().__init__(total_limit_bytes=-1)
        self._breakers = {
            name: NoneCircuitBreaker(name)
            for name in (CircuitBreaker.REQUEST, CircuitBreaker.FIELDDATA,
                         CircuitBreaker.IN_FLIGHT_REQUESTS,
                         CircuitBreaker.HBM)
        }

    def check_parent_limit(self, label: str):
        pass
