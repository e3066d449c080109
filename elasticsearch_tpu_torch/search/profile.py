"""Query profiling: per-stage timing for `profile: true` (a copy of the
jax-free elasticsearch_tpu/search/profile.py; its attribution table names
the port's tracked entry points).

The reference profiles per-Weight/Scorer timing types through
QueryProfiler trees (ref: search/profile/query/QueryProfiler.java:38,
QueryProfileBreakdown). This engine's execution shape is different —
one fused device launch instead of per-doc scorer calls — so the
breakdown reports the stages that actually exist here, split into HOST
and DEVICE time:

  rewrite   — query tree rewriting (host)
  compile   — logical-plan compilation / cache lookup (host)
  bind      — selection building + bucket padding (host)
  launch    — kernel dispatch + device execution wait (device)
  readback  — device→host transfer of the top-k rows (device↔host)
  score     — dense-path column scoring (device, fallback path)
  topk      — dense-path masked top-k (device, fallback path)
  merge     — cross-segment merge (host)

A threadlocal recorder keeps instrumentation out of every call
signature; it is active only under `profiling()`, so the serving hot
path pays one `is-None` check per stage.

Two consumers share the recorder seam:

- ``profiling()`` (the per-request ``profile: true`` dict), and
- ``stage_sink(fn)`` — a persistent sink the telemetry subsystem
  installs so stage timings accumulate into node-level histograms
  (``search.stage.launch`` etc.) on EVERY search, not only profiled
  ones (telemetry/__init__.py ``Telemetry.stage_sink``).

Both are temporal thread-local contexts; telemetry/context.py
``bind()`` carries them (plus the trace context) across scheduler task
boundaries so a multi-node search keeps its shard-side stages.

The stage seam doubles as the engine's cancellation poll point: a
caller that owns a CancellableTask installs its ``ensure_not_cancelled``
via ``cancellable()``, and every ``span(stage)`` entry — i.e. every
device-launch boundary of a multi-segment scan — polls it. A cancelled
search aborts between launches instead of after the full scan, without
the kernels themselves knowing tasks exist.

Per-request profiling (``profile: true``) extends the flat stage dict
with three structured channels, all allocated ONLY while a recorder is
installed (the profile-off hot path still pays one is-None check):

- ``record_device(attrs)`` — one attribution record per device launch
  (kernel name, lane×nb bucket, cohort width, batcher wait, padding
  waste, readback bytes/ms — stamped by search/batching.py and the
  searcher launch sites);
- ``note_kernel(kernel, kind, ms)`` — stamped by ``tracked_kernel``
  (telemetry/engine.py) on every tracked entry-point call under the
  recorder: ``kind`` classifies the launch as ``compile`` (the first
  call of a shape key: the host's first enqueue, with a lazy kernel
  build or load) or ``cached`` (a shape key seen before);
- dotted stage names (``aggs.collect`` …) — structured child scopes
  that ``shard_profile_tree`` groups under their parent stage.

The recorder's clock is injectable (``profiling(clock=...)``): the
distributed data-node handler passes the scheduler clock, so a
chaos-seeded run under DeterministicTaskQueue reports replay-identical
profile trees (virtual time), while production reads monotonic nanos.

``stage_hook(cb)`` installs a per-span callback (``cb(stage)``) that
the task layer uses to publish a task's CURRENT profile stage
(``GET /_tasks?detailed=true``, hot_threads) — same one-getattr cost
model as the cancellation hook.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

_tls = threading.local()


def active() -> bool:
    return getattr(_tls, "rec", None) is not None \
        or getattr(_tls, "sink", None) is not None


def recording() -> bool:
    """True only under ``profiling()`` — the guard for per-request
    attribution records (device records / kernel notes), which are
    never allocated for sink-only (metrics histogram) collection."""
    return getattr(_tls, "rec", None) is not None


def now_ns() -> int:
    """Nanos on the recorder's clock (injectable for replay-identical
    trees under the deterministic harness; monotonic otherwise)."""
    clk = getattr(_tls, "clock", None)
    return clk() if clk is not None else time.monotonic_ns()


@contextmanager
def profiling(clock=None):
    """Activate collection; yields the stage dict (stage → nanos).

    ``clock`` (optional zero-arg → nanos) pins span timing to an
    injectable clock — the distributed path passes virtual scheduler
    time so seeded runs produce identical trees."""
    rec: Dict[str, Any] = {}
    prev = getattr(_tls, "rec", None)
    prev_clock = getattr(_tls, "clock", None)
    _tls.rec = rec
    if clock is not None:
        _tls.clock = clock
    try:
        yield rec
    finally:
        _tls.rec = prev
        _tls.clock = prev_clock


@contextmanager
def stage_sink(fn):
    """Install a stage sink ``fn(stage, nanos)`` for the duration;
    stacks with (and is independent of) an active ``profiling()``."""
    prev = getattr(_tls, "sink", None)
    _tls.sink = fn
    try:
        yield
    finally:
        _tls.sink = prev


def record(stage: str, nanos: int) -> None:
    rec = getattr(_tls, "rec", None)
    if rec is not None:
        rec[stage] = rec.get(stage, 0) + nanos
    sink = getattr(_tls, "sink", None)
    if sink is not None:
        sink(stage, nanos)


def note(key: str, value) -> None:
    """Non-timing annotation (e.g. collector name)."""
    rec = getattr(_tls, "rec", None)
    if rec is not None:
        rec.setdefault("_notes", {})[key] = value   # type: ignore


def add(key: str, n: float) -> None:
    """Accumulate a numeric counter (e.g. readback bytes) into the
    per-request record; no-op (no allocation) when not recording."""
    rec = getattr(_tls, "rec", None)
    if rec is not None:
        counters = rec.setdefault("_counters", {})   # type: ignore
        counters[key] = counters.get(key, 0) + n


def record_readback(t0_ns: int, *arrays) -> None:
    """Attribute one device→host readback to the active recorder:
    bytes of the materialized arrays + elapsed ms since ``t0_ns`` (a
    ``now_ns()`` stamp taken before the transfer). The one helper both
    searcher readback sites share."""
    add("readback_bytes", sum(a.nbytes for a in arrays))
    add("readback_ms", round((now_ns() - t0_ns) / 1e6, 3))


def record_device(attrs: Dict[str, Any]) -> None:
    """Append one device-launch attribution record (kernel name, lane/
    nb bucket, cohort width, batch wait, padding waste, readback
    bytes/ms, cache-hit flag); no-op when not recording."""
    rec = getattr(_tls, "rec", None)
    if rec is not None:
        rec.setdefault("_device", []).append(attrs)   # type: ignore


def note_kernel(kernel: str, kind: str, ms: float) -> None:
    """Record one tracked entry-point call under the active recorder:
    ``kind`` is ``compile`` (first call of its shape key) or ``cached``.
    Called by telemetry/engine.py's ``tracked_kernel`` wrapper — the
    seam that gives every profiled request its kernel-name attribution.

    Aggregated by (kernel, kind): a query scanning many segments makes
    the same warm call per segment, and per-call rows would grow the
    profile linearly with segment count for zero extra information —
    the tree renders one row per (kernel, kind) with a call count and
    summed ms."""
    rec = getattr(_tls, "rec", None)
    if rec is not None:
        kernels = rec.setdefault("_kernels", {})   # type: ignore
        slot = kernels.get((kernel, kind))
        if slot is None:
            kernels[(kernel, kind)] = [1, float(ms)]
        else:
            slot[0] += 1
            slot[1] += float(ms)


@contextmanager
def cancellable(check):
    """Install a cancellation poll ``check()`` (typically a task's
    ``ensure_not_cancelled``) for the duration; ``span()`` entries —
    the device-launch boundaries — call it. telemetry/context.bind()
    carries it across scheduler task boundaries."""
    prev = getattr(_tls, "cancel", None)
    _tls.cancel = check
    try:
        yield
    finally:
        _tls.cancel = prev


def check_cancelled() -> None:
    """Poll the installed cancellation hook (raises TaskCancelledException
    through the task's ``ensure_not_cancelled``); no-op when none is
    installed — one getattr on the hot path."""
    cb = getattr(_tls, "cancel", None)
    if cb is not None:
        cb()


def checkpoint(stage: str) -> None:
    """A boundary between phases that is no timed span: the installed
    cancellation poll runs and the stage hook hears ``stage``."""
    check_cancelled()
    cb = getattr(_tls, "stage_cb", None)
    if cb is not None:
        cb(stage)


def cancel_installed() -> bool:
    """Whether a cancellation poll is installed on this thread."""
    return getattr(_tls, "cancel", None) is not None


def cancelled_error() -> Optional[BaseException]:
    """The installed poll's TaskCancelledException when the work was
    cancelled, else None (the poll without the raise)."""
    try:
        check_cancelled()
    except Exception as e:
        return e
    return None


@contextmanager
def stage_hook(cb):
    """Install a per-span stage callback ``cb(stage)`` — the task layer
    publishes the task's current profile stage through it so
    ``GET /_tasks?detailed=true`` and hot_threads show WHERE a
    long-running search is, not just how long it has run."""
    prev = getattr(_tls, "stage_cb", None)
    _tls.stage_cb = cb
    try:
        yield
    finally:
        _tls.stage_cb = prev


@contextmanager
def span(stage: str):
    check_cancelled()
    cb = getattr(_tls, "stage_cb", None)
    if cb is not None:
        cb(stage)
    if not active():
        yield
        return
    clk = getattr(_tls, "clock", None)
    if clk is None:
        clk = time.monotonic_ns
    t0 = clk()
    try:
        yield
    finally:
        record(stage, clk() - t0)


DEVICE_STAGES = ("launch", "readback", "score", "topk")
HOST_STAGES = ("rewrite", "compile", "bind", "merge")

# ---------------------------------------------------------------------------
# Kernel → profile attribution registry.
#
# Every `tracked_kernel` entry point in ops/ MUST have a row here — the
# KEY SET is the wiring contract: tests/test_torch_profile.py fails on a
# tracked kernel without a row, forcing the author to decide (and
# document) which profile stage its launches are timed under. The VALUE
# documents that stage — it must name a real stage — but is not
# consulted at run time; the actual timing comes from the `span()` call
# site wrapping the launch.
# ---------------------------------------------------------------------------

KERNEL_ATTRIBUTION: Dict[str, str] = {
    # ops/plan.py: the plan path's launch and the dense BM25 scorer
    "plan_topk": "launch",
    "plan_topk_batch": "launch",
    # the mesh's program (ops/plan.py), one launch a shard and the merge
    "plan_topk_mesh": "launch",
    "mesh_merge": "merge",
    "bm25_dense_scores_sorted": "launch",
    # ops/bm25.py: the dense executor's match columns
    "match_mask": "score",
    "match_count": "score",
    # the positional queries' candidate filter
    "conjunction_mask": "score",
    # ops/features.py: text_expansion's weighted sum of feature columns
    "feature_plane_sum": "score",
    # ops/topk.py (stable_topk has no reference counterpart: it runs
    # inside the other entries, as lax.top_k does in the reference's)
    "masked_topk": "topk",
    "stable_topk": "topk",
    "merge_topk": "merge",
    # ops/bm25.py: the RRF fusion's segmented sum (parallel/sharded.py)
    "segmented_topk": "topk",
    # ops/aggs.py, under the reference's names
    "terms_counts": "aggs.collect",
    "agg_metric_stats": "aggs.collect",
    "agg_bucket_counts": "aggs.collect",
    "agg_bucket_metrics": "aggs.collect",
    # ops/fastpath.py: the fast path's cohort launches
    "bm25_topk_total_batch": "launch",
    "bm25_essential_topk_batch": "launch",
    "bm25_essential_dense_topk_batch": "launch",
    "bm25_topk_total_merge_batch": "launch",
    "bm25_candidates_rerank_batch": "launch",
    # ops/vector.py
    "dot_scores": "score",
    "cosine_scores": "score",
    "l2_scores": "score",
    "similarity_scores": "score",
    "knn_nominate_batch": "launch",
    # parallel/mesh_executor.py: the mesh kNN programs
    "mesh_knn_nominate": "launch",
    "mesh_knn_step": "launch",
    # the hand-written CUDA kernels (csrc/): the contribution kernel
    # (the reference's bm25_contrib_pallas) and the merge (inside the
    # reference's merge batch)
    "gather_bm25_contrib": "launch",
    "merge_sorted_slots": "launch",
}


# ---------------------------------------------------------------------------
# ES-shaped shard profile tree — ONE function for every shard entry (the
# single-node SearchService now; the data-node handler when the port
# keeps several shards), so the per-shard response shape cannot drift
# between paths (ref:
# search/profile/SearchProfileResults — per-shard query/collector/
# aggregation breakdowns merged at the coordinator).
# ---------------------------------------------------------------------------

def shard_profile_tree(shard_id: str, body: Optional[Dict[str, Any]],
                       rec: Dict[str, Any], total_ns: int,
                       collected_ns: Optional[int] = None
                       ) -> Dict[str, Any]:
    """Build one shard's ES-shaped profile entry from a finished
    recorder dict.

    ``rec`` is consumed: structured channels (`_notes`, `_device`,
    `_kernels`, `_counters`) pop out of the flat stage dict. Dotted
    stages (``aggs.collect``) render as child breakdowns under their
    parent scope. The per-shard invariant pinned by tests:
    ``device_time_in_nanos + host_time_in_nanos == time_in_nanos`` and
    every breakdown stage ≤ ``time_in_nanos``."""
    notes = rec.pop("_notes", {})
    device_records: List[Dict[str, Any]] = rec.pop("_device", [])
    kernel_notes = [
        {"kernel": kernel, "kind": kind, "calls": slot[0],
         "ms": round(slot[1], 3)}
        for (kernel, kind), slot in sorted(rec.pop("_kernels",
                                                   {}).items())]
    counters: Dict[str, float] = rec.pop("_counters", {})
    stages = {k: v for k, v in rec.items()}

    # structured child scopes: dotted stages group under their parent
    children: Dict[str, Dict[str, int]] = {}
    flat: Dict[str, int] = {}
    for k, v in stages.items():
        if "." in k:
            parent, _, child = k.partition(".")
            children.setdefault(parent, {})[child] = v
        else:
            flat[k] = v

    device_ns = sum(flat.get(k, 0) for k in DEVICE_STAGES)
    # a child of a timed stage (``score.verify``) is inside that stage's
    # time already
    host_ns = sum(flat.get(k, 0) for k in HOST_STAGES) \
        + sum(sum(c.values()) for p, c in children.items()
              if p not in flat)
    total_ns = max(int(total_ns), device_ns + host_ns)

    breakdown: Dict[str, Any] = dict(flat)
    breakdown["device_time_in_nanos"] = device_ns
    breakdown["host_time_in_nanos"] = total_ns - device_ns

    qtype = next(iter((body or {}).get("query") or {"match_all": {}}))
    collector_name = notes.get("collector", "FusedPlanTopDocsCollector")
    entry: Dict[str, Any] = {
        "id": shard_id,
        "searches": [{
            "query": [{
                "type": qtype,
                "description": str((body or {}).get("query", {})),
                "time_in_nanos": total_ns,
                # the execution stages (compile/bind are host;
                # launch/readback are device — ref: QueryProfiler.java
                # breaks down per-Scorer timing types; here the stages
                # ARE the execution model)
                "breakdown": breakdown,
            }],
            "rewrite_time": flat.get("rewrite", 0),
            "collector": [{
                "name": collector_name,
                "reason": "search_top_hits",
                "time_in_nanos": (
                    collected_ns if collected_ns is not None
                    else flat.get("launch", 0) + flat.get("topk", 0)
                    + flat.get("score", 0)),
            }],
        }],
        "aggregations": [],
    }
    for parent in sorted(children):
        child_stages = children[parent]
        node = {
            "type": parent,
            "time_in_nanos": sum(child_stages.values()),
            "breakdown": dict(child_stages),
        }
        if parent in ("aggs", "aggregations"):
            node["type"] = "aggregations"
            spec = (body or {}).get("aggs",
                                    (body or {}).get("aggregations"))
            node["description"] = ",".join(sorted(spec)) \
                if isinstance(spec, dict) else ""
            entry["aggregations"].append(node)
        else:
            entry["searches"][0].setdefault("children", []).append(node)
    device_section: Dict[str, Any] = {}
    if device_records:
        device_section["launches"] = device_records
    if kernel_notes:
        device_section["kernels"] = kernel_notes
    if counters:
        device_section.update(
            {k: (int(v) if float(v).is_integer() else round(v, 3))
             for k, v in counters.items()})
    if device_section:
        # the attribution block the reference has no analogue for: WHY
        # the device time was what it was (cohorts, padding, compile
        # vs cache, HBM churn, readback volume)
        entry["device"] = device_section
    # tenant stamp: the ambient X-Tenant-Id rides every shard entry so
    # a profiled tree is attributable without joining against tasks
    # (lazy import — telemetry/context.py imports this module)
    from elasticsearch_tpu_torch.telemetry import context as _telectx
    tenant = _telectx.current_tenant()
    if tenant is not None:
        entry["tenant"] = tenant
    wclass = _telectx.current_workload_class()
    if wclass is not None:
        entry["search.class"] = wclass
    return entry
