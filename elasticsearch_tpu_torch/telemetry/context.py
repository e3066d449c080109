"""Ambient telemetry context (counterpart of the jax-free
elasticsearch_tpu/telemetry/context.py, reduced to what the flight
recorder and the profile need): the ambient trace/span the recorder
stamps into its events, the tenant and workload-class reads that the
profile tree stamps (empty until the port carries those headers), and
``bind``, which carries the thread-local recorders across a thread or
scheduler boundary.

The search profiler's recorder (search/profile.py) and the node's flight
recorder (telemetry/flightrecorder.py) are thread-local: work handed to
another thread runs after the installing scope exited. ``bind(fn)``
captures them at hand-off and reinstalls them around ``fn``.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional

from elasticsearch_tpu_torch.search import profile as _profile
from elasticsearch_tpu_torch.telemetry import flightrecorder as _flight

_tls = threading.local()


@dataclass(frozen=True)
class TraceContext:
    trace_id: str
    span_id: Optional[str] = None


def current() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


@contextmanager
def activate(ctx: Optional[TraceContext]):
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def current_tenant() -> Optional[str]:
    """The tenant the current work is accounted to (None: the port does
    not carry ``X-Tenant-Id`` yet)."""
    return getattr(_tls, "tenant", None)


def current_workload_class() -> Optional[str]:
    """The request class the current work runs under (None: the port
    does not classify requests yet)."""
    return getattr(_tls, "workload", None)


def capture():
    """Snapshot (profile recorder, profile sink, recorder clock, cancel
    hook, stage hook, trace context, flight recorder); None when nothing
    is active."""
    rec = getattr(_profile._tls, "rec", None)
    sink = getattr(_profile._tls, "sink", None)
    clock = getattr(_profile._tls, "clock", None)
    cancel = getattr(_profile._tls, "cancel", None)
    stage_cb = getattr(_profile._tls, "stage_cb", None)
    ctx = getattr(_tls, "ctx", None)
    flight = getattr(_flight._tls, "rec", None)
    if rec is None and sink is None and cancel is None \
            and stage_cb is None and ctx is None and flight is None:
        return None
    return (rec, sink, clock, cancel, stage_cb, ctx, flight)


def bind(fn: Callable) -> Callable:
    """Bind the ambient contexts at call time into a task body (the
    callee's return value passes through); returns ``fn`` unchanged when
    no context is active."""
    cap = capture()
    if cap is None:
        return fn
    rec, sink, clock, cancel, stage_cb, ctx, flight = cap

    def bound():
        prev_rec = getattr(_profile._tls, "rec", None)
        prev_sink = getattr(_profile._tls, "sink", None)
        prev_clock = getattr(_profile._tls, "clock", None)
        prev_cancel = getattr(_profile._tls, "cancel", None)
        prev_stage = getattr(_profile._tls, "stage_cb", None)
        prev_ctx = getattr(_tls, "ctx", None)
        prev_flight = getattr(_flight._tls, "rec", None)
        _profile._tls.rec = rec
        _profile._tls.sink = sink
        _profile._tls.clock = clock
        _profile._tls.cancel = cancel
        _profile._tls.stage_cb = stage_cb
        _tls.ctx = ctx
        _flight._tls.rec = flight
        try:
            return fn()
        finally:
            _profile._tls.rec = prev_rec
            _profile._tls.sink = prev_sink
            _profile._tls.clock = prev_clock
            _profile._tls.cancel = prev_cancel
            _profile._tls.stage_cb = prev_stage
            _tls.ctx = prev_ctx
            _flight._tls.rec = prev_flight

    return bound
