"""Ambient telemetry context (a copy of the jax-free
elasticsearch_tpu/telemetry/context.py): the thread-local half of trace,
task, client-id, tenant and workload-class propagation, plus
capture/rebind across thread boundaries.

1. **Trace propagation.** The REST boundary installs the active
   (trace_id, span_id) so the search service parents its shard and
   fetch spans without a context argument (``Tracer.start_span``
   consults ``current()`` when no explicit parent is given). Over HTTP
   the context rides the ``trace.id`` / ``span.id`` request headers
   (rest/native_http.py joins them through ``incoming``).

2. **Attribution.** ``X-Opaque-Id``, ``X-Tenant-Id`` and
   ``X-Workload-Class`` become ambient for a request's handler
   (``activate_opaque``, ``activate_tenant``,
   ``activate_workload_class``), so every phase under it (batcher
   entries, flight events, breaker trips, profile trees, slowlog
   entries, tasks) charges the right rows. The task half
   (``activate_task``, ``task_headers``) is the reference's transport
   carrier, which a single node stamps but never sends.

3. **Thread boundaries.** The search profiler's thread-local recorder
   (search/profile.py), its cancellation hook, the node's flight
   recorder and these contexts are thread-local: work handed to another
   thread runs after the installing scope exited. ``bind(fn)`` captures
   everything at hand-off and reinstalls it around ``fn``.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from elasticsearch_tpu_torch.search import profile as _profile
from elasticsearch_tpu_torch.telemetry import flightrecorder as _flight

TRACE_HEADER = "trace.id"
SPAN_HEADER = "span.id"
TASK_HEADER = "task.id"
PARENT_TASK_HEADER = "task.parent"
OPAQUE_ID_HEADER = "X-Opaque-Id"
TENANT_HEADER = "X-Tenant-Id"
WORKLOAD_HEADER = "X-Workload-Class"

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


def activate_span(span) -> Any:
    """Install a live Span as the ambient parent (context manager)."""
    return activate(TraceContext(span.trace_id, span.span_id))


# -- ambient task ---------------------------------------------------------

def current_task():
    """The locally registered Task the calling code runs under, as the
    ``(node_id, task)`` pair installed by ``activate_task`` (None when
    none is active)."""
    return getattr(_tls, "task", None)


@contextmanager
def activate_task(node_id: str, task):
    """Install a registered Task as the ambient sender context: every
    ``send_request`` issued under it (including ones whose callbacks
    were ``bind()``-carried through a scheduler) stamps this task into
    the request headers, so the receiving handler parents its child
    task to it."""
    prev = getattr(_tls, "task", None)
    _tls.task = (node_id, task) if task is not None else None
    try:
        yield task
    finally:
        _tls.task = prev


def incoming_parent_task() -> Optional[str]:
    """The ``task.id`` string the current transport request carried
    (the REMOTE caller's task — i.e. the parent for any task this
    handler registers); None outside a task-stamped dispatch."""
    return getattr(_tls, "task_parent", None)


# -- ambient client id (X-Opaque-Id) --------------------------------------

def current_opaque_id() -> Optional[str]:
    """The caller-supplied ``X-Opaque-Id`` the current work runs under —
    the reference's ThreadContext header that lets operators attribute
    tasks and slowlog entries back to a client (ref: Task.HEADERS_TO_COPY).
    None when the originating REST request carried no such header."""
    return getattr(_tls, "opaque", None)


@contextmanager
def activate_opaque(value: Optional[str]):
    """Install an ``X-Opaque-Id`` as ambient for the request's duration
    (no-op pass-through scope when value is falsy)."""
    prev = getattr(_tls, "opaque", None)
    _tls.opaque = value or prev
    try:
        yield value
    finally:
        _tls.opaque = prev


# -- ambient tenant (X-Tenant-Id) -----------------------------------------

def current_tenant() -> Optional[str]:
    """The tenant id the current work is accounted to (header > body >
    index default, resolved at the request boundary) — the dimension
    TenantAccounting charges search latency, device launch-ms, cohort
    slots, and indexing bytes against. None for untagged work (which
    accounting folds into its ``_default`` bucket)."""
    return getattr(_tls, "tenant", None)


@contextmanager
def activate_tenant(value: Optional[str]):
    """Install a tenant id as ambient for the request's duration (no-op
    pass-through scope when value is falsy — an inner untagged scope
    never masks an outer tagged one)."""
    prev = getattr(_tls, "tenant", None)
    _tls.tenant = value or prev
    try:
        yield value
    finally:
        _tls.tenant = prev


# -- ambient workload class (X-Workload-Class) ----------------------------

def current_workload_class() -> Optional[str]:
    """The request-class label the current work runs under —
    ``interactive`` / ``bulk`` / ``aggs`` / ``scroll`` / ``async``
    (telemetry/workload.py's taxonomy, derived at the request boundary
    or carried in via the ``X-Workload-Class`` header). The dimension
    WorkloadAccounting charges latency, cohort slots, and indexing
    bytes against. None for unclassified work (accounting folds it
    into its ``_default`` bucket)."""
    return getattr(_tls, "workload", None)


@contextmanager
def activate_workload_class(value: Optional[str]):
    """Install a workload class as ambient for the request's duration
    (no-op pass-through scope when value is falsy — an inner
    unclassified scope never masks an outer classified one)."""
    prev = getattr(_tls, "workload", None)
    _tls.workload = value or prev
    try:
        yield value
    finally:
        _tls.workload = prev


# -- wire headers ---------------------------------------------------------

def headers_of(span) -> Dict[str, str]:
    return {TRACE_HEADER: span.trace_id, SPAN_HEADER: span.span_id}


def task_headers(node_id: str, task) -> Dict[str, str]:
    """The task half of the ``__headers`` carrier: the sender's own task
    id (the receiver's parent) plus the sender's parent for tree
    observability."""
    out = {TASK_HEADER: f"{node_id}:{task.id}"}
    parent = getattr(task, "parent_task_id", None)
    if parent is not None and parent.id != -1:
        out[PARENT_TASK_HEADER] = str(parent)
    return out


def stamp_task_headers(headers: Optional[Dict[str, Any]]
                       ) -> Optional[Dict[str, Any]]:
    """Merge the ambient task (if any) into outgoing request headers;
    explicit ``task.id`` headers win. Returns the original dict object
    untouched when there is nothing to add."""
    cur = getattr(_tls, "task", None)
    opaque = getattr(_tls, "opaque", None)
    tenant = getattr(_tls, "tenant", None)
    workload = getattr(_tls, "workload", None)
    if opaque is not None and not (headers and OPAQUE_ID_HEADER in headers):
        headers = dict(headers or {})
        headers[OPAQUE_ID_HEADER] = opaque
    if tenant is not None and not (headers and TENANT_HEADER in headers):
        headers = dict(headers or {})
        headers[TENANT_HEADER] = tenant
    if workload is not None and \
            not (headers and WORKLOAD_HEADER in headers):
        headers = dict(headers or {})
        headers[WORKLOAD_HEADER] = workload
    if cur is None or (headers and TASK_HEADER in headers):
        return headers
    node_id, task = cur
    merged = dict(headers or {})
    merged.update(task_headers(node_id, task))
    return merged


def from_headers(headers: Optional[Dict[str, Any]]
                 ) -> Optional[TraceContext]:
    if not headers:
        return None
    trace_id = headers.get(TRACE_HEADER)
    if not trace_id:
        return None
    return TraceContext(str(trace_id), headers.get(SPAN_HEADER))


@contextmanager
def incoming(headers: Optional[Dict[str, Any]]):
    """Dispatch-side: install the trace context AND the caller's task id
    carried by a request's headers for the duration of its handler
    (no-op without headers)."""
    ctx = from_headers(headers)
    task_id = (headers or {}).get(TASK_HEADER)
    opaque = (headers or {}).get(OPAQUE_ID_HEADER)
    tenant = (headers or {}).get(TENANT_HEADER)
    workload = (headers or {}).get(WORKLOAD_HEADER)
    if ctx is None and task_id is None and opaque is None \
            and tenant is None and workload is None:
        yield None
        return
    prev_ctx = getattr(_tls, "ctx", None)
    prev_task = getattr(_tls, "task_parent", None)
    prev_opaque = getattr(_tls, "opaque", None)
    prev_tenant = getattr(_tls, "tenant", None)
    prev_workload = getattr(_tls, "workload", None)
    if ctx is not None:
        _tls.ctx = ctx
    _tls.task_parent = str(task_id) if task_id is not None else None
    if opaque is not None:
        _tls.opaque = str(opaque)
    if tenant is not None:
        _tls.tenant = str(tenant)
    if workload is not None:
        _tls.workload = str(workload)
    try:
        yield ctx
    finally:
        _tls.ctx = prev_ctx
        _tls.task_parent = prev_task
        _tls.opaque = prev_opaque
        _tls.tenant = prev_tenant
        _tls.workload = prev_workload


# -- task-boundary carry --------------------------------------------------

def capture():
    """Snapshot (profile recorder, profile sink, recorder clock, cancel
    hook, stage hook, trace context, ambient task, opaque id, tenant,
    workload class, flight recorder); None when nothing is active — the
    common case costs a handful of getattrs."""
    rec = getattr(_profile._tls, "rec", None)
    sink = getattr(_profile._tls, "sink", None)
    clock = getattr(_profile._tls, "clock", None)
    cancel = getattr(_profile._tls, "cancel", None)
    stage_cb = getattr(_profile._tls, "stage_cb", None)
    ctx = getattr(_tls, "ctx", None)
    task = getattr(_tls, "task", None)
    opaque = getattr(_tls, "opaque", None)
    tenant = getattr(_tls, "tenant", None)
    workload = getattr(_tls, "workload", None)
    flight = getattr(_flight._tls, "rec", None)
    if rec is None and sink is None and cancel is None \
            and stage_cb is None and ctx is None and task is None \
            and opaque is None and tenant is None and workload is None \
            and flight is None:
        return None
    return (rec, sink, clock, cancel, stage_cb, ctx, task, opaque,
            tenant, workload, flight)


def bind(fn: Callable) -> Callable:
    """Bind the ambient contexts at call time into a task body (the
    callee's return value passes through, so this also wraps executor
    submissions); returns ``fn`` unchanged when no context is active
    (zero overhead at run time for un-instrumented schedules)."""
    cap = capture()
    if cap is None:
        return fn
    rec, sink, clock, cancel, stage_cb, ctx, task, opaque, tenant, \
        workload, flight = cap

    def bound():
        prev_rec = getattr(_profile._tls, "rec", None)
        prev_sink = getattr(_profile._tls, "sink", None)
        prev_clock = getattr(_profile._tls, "clock", None)
        prev_cancel = getattr(_profile._tls, "cancel", None)
        prev_stage = getattr(_profile._tls, "stage_cb", None)
        prev_ctx = getattr(_tls, "ctx", None)
        prev_task = getattr(_tls, "task", None)
        prev_opaque = getattr(_tls, "opaque", None)
        prev_tenant = getattr(_tls, "tenant", None)
        prev_workload = getattr(_tls, "workload", None)
        prev_flight = getattr(_flight._tls, "rec", None)
        _profile._tls.rec = rec
        _profile._tls.sink = sink
        _profile._tls.clock = clock
        _profile._tls.cancel = cancel
        _profile._tls.stage_cb = stage_cb
        _tls.ctx = ctx
        _tls.task = task
        _tls.opaque = opaque
        _tls.tenant = tenant
        _tls.workload = workload
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
            _tls.task = prev_task
            _tls.opaque = prev_opaque
            _tls.tenant = prev_tenant
            _tls.workload = prev_workload
            _flight._tls.rec = prev_flight

    return bound
