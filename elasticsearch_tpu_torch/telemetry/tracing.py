"""Distributed tracing: Dapper-style trace/span recording.

The reference exposes task management and (since 7.16) APM trace
propagation; this engine keeps the same shape in-process: a REST-boundary
root span, child spans per coordinator phase and per shard attempt, and
context propagated through transport request headers (``trace.id`` /
``span.id`` — see telemetry/context.py and the ``__headers`` carrier in
transport/transport.py).

Design for the deterministic harness:

- trace/span ids come from per-tracer COUNTERS (prefixed with the node
  name), not uuid4 — a seed-replayed ``DeterministicTaskQueue`` run
  produces the identical id sequence and span tree;
- the clock is injectable, so span timestamps read virtual time under
  simulation;
- finished spans land in a bounded per-trace ring (oldest trace evicted
  when ``max_traces`` root traces are held; within a trace, the oldest
  span drops once ``max_spans_per_trace`` is reached, with the drop
  count retained) served by ``GET /_traces`` with ``size``/``from``
  paging — long-running nodes can't grow trace memory without limit;
- open spans are tracked so the test harness can fail a test that
  starts a span and never finishes it (tests/conftest.py leak guard).
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

# every live tracer, for the test-harness span-leak guard
_TRACERS: "weakref.WeakSet[Tracer]" = weakref.WeakSet()


def all_tracers() -> List["Tracer"]:
    return list(_TRACERS)


def open_span_keys() -> set:
    """Identity keys of every span currently open on any live tracer
    (the conftest leak detector diffs this across a test)."""
    keys = set()
    for t in all_tracers():
        for s in t.open_spans():
            keys.add((id(t), s.trace_id, s.span_id, s.name))
    return keys


class Span:
    """One timed, tagged operation. ``finish()`` is idempotent."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "end", "tags", "_tracer")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str, start: float,
                 tags: Optional[Dict[str, Any]] = None):
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.tags: Dict[str, Any] = dict(tags or {})

    def tag(self, key: str, value: Any) -> "Span":
        self.tags[key] = value
        return self

    def finish(self, **tags) -> None:
        if self.end is not None:
            return
        if tags:
            self.tags.update(tags)
        self.end = self._tracer.clock()
        self._tracer._on_finish(self)

    def to_dict(self) -> Dict[str, Any]:
        end = self.end if self.end is not None else self.start
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "start_ms": round(self.start * 1000.0, 3),
                "duration_ms": round((end - self.start) * 1000.0, 3),
                "tags": dict(self.tags)}


class Tracer:
    """Per-node span factory + bounded recent-trace store."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 node: str = "", max_traces: int = 128,
                 max_spans_per_trace: int = 512):
        self.clock = clock or time.monotonic
        self.node = node
        self.max_traces = max_traces
        # span retention ring: a trace holding max_spans_per_trace
        # finished spans drops its OLDEST span per new arrival, so a
        # long-running node's pathological trace (a retry loop, a
        # runaway scroll) can't grow trace memory without limit; the
        # drop count stays visible on the trace
        self.max_spans_per_trace = max_spans_per_trace
        self._lock = threading.Lock()
        self._trace_seq = 0
        self._span_seq = 0
        # trace_id -> finished span dicts, insertion-ordered for eviction
        self._traces: "OrderedDict[str, List[Dict]]" = OrderedDict()
        self._dropped: Dict[str, int] = {}
        self.dropped_spans_total = 0
        self._open: Dict[str, Span] = {}
        _TRACERS.add(self)

    # -- span lifecycle ---------------------------------------------------

    def start_span(self, name: str, parent: Optional[Span] = None,
                   trace_id: Optional[str] = None,
                   parent_span_id: Optional[str] = None,
                   tags: Optional[Dict[str, Any]] = None) -> Span:
        """Start a span. Parent resolution, most explicit first: a
        ``parent`` Span, then an explicit remote (trace_id,
        parent_span_id) pair, then the ambient context installed by the
        transport dispatch / REST boundary, else a brand-new trace."""
        if parent is not None:
            trace_id = parent.trace_id
            parent_span_id = parent.span_id
        elif trace_id is None:
            from elasticsearch_tpu_torch.telemetry import context as _ctx
            ambient = _ctx.current()
            if ambient is not None:
                trace_id = ambient.trace_id
                parent_span_id = ambient.span_id
        with self._lock:
            if trace_id is None:
                self._trace_seq += 1
                trace_id = f"{self.node or 'node'}-t{self._trace_seq:06d}"
                parent_span_id = None
                self._bucket_locked(trace_id)
            self._span_seq += 1
            span_id = f"{self.node or 'node'}-s{self._span_seq:06d}"
            span = Span(self, trace_id, span_id, parent_span_id, name,
                        self.clock(), tags)
            self._open[span_id] = span
        return span

    def _bucket_locked(self, trace_id: str) -> List[Dict]:
        bucket = self._traces.get(trace_id)
        if bucket is None:
            bucket = []
            self._traces[trace_id] = bucket
            while len(self._traces) > self.max_traces:
                evicted, _spans = self._traces.popitem(last=False)
                self._dropped.pop(evicted, None)
        return bucket

    def _on_finish(self, span: Span) -> None:
        with self._lock:
            self._open.pop(span.span_id, None)
            bucket = self._bucket_locked(span.trace_id)
            bucket.append(span.to_dict())
            if len(bucket) > self.max_spans_per_trace:
                bucket.pop(0)
                self._dropped[span.trace_id] = \
                    self._dropped.get(span.trace_id, 0) + 1
                self.dropped_spans_total += 1

    # -- queries (REST surface) -------------------------------------------

    def open_spans(self) -> List[Span]:
        with self._lock:
            return list(self._open.values())

    def recent_traces(self, limit: int = 32,
                      offset: int = 0) -> List[Dict[str, Any]]:
        """Newest-first summaries for ``GET /_traces``; ``offset``
        (the ``from`` param) skips the newest entries so a bounded ring
        is still pageable."""
        with self._lock:
            entries = list(self._traces.items())
            dropped = dict(self._dropped)
        newest_first = list(reversed(entries))
        out = []
        for trace_id, spans in newest_first[offset:offset + limit]:
            roots = [s for s in spans if s["parent_id"] is None]
            summary = {
                "trace_id": trace_id,
                "root": roots[0]["name"] if roots else
                        (spans[0]["name"] if spans else None),
                "spans": len(spans),
                "duration_ms": (max((s["start_ms"] + s["duration_ms"]
                                     for s in spans), default=0.0)
                                - min((s["start_ms"] for s in spans),
                                      default=0.0)),
            }
            if dropped.get(trace_id):
                summary["dropped_spans"] = dropped[trace_id]
            out.append(summary)
        return out

    def trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Span list + nested tree for ``GET /_traces/{trace_id}``."""
        with self._lock:
            spans = self._traces.get(trace_id)
            spans = [dict(s) for s in spans] if spans is not None else None
            dropped = self._dropped.get(trace_id, 0)
        if spans is None:
            return None
        spans.sort(key=lambda s: (s["start_ms"], s["span_id"]))
        by_id = {s["span_id"]: {**s, "children": []} for s in spans}
        roots = []
        for s in spans:
            node = by_id[s["span_id"]]
            parent = by_id.get(s["parent_id"]) if s["parent_id"] else None
            if parent is not None:
                parent["children"].append(node)
            else:
                roots.append(node)
        out = {"trace_id": trace_id, "spans": spans, "tree": roots}
        if dropped:
            out["dropped_spans"] = dropped
        return out
