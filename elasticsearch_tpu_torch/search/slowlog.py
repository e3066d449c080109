"""The search slow log's threshold check (the port's copy of
elasticsearch_tpu/search/slowlog.py).

Ref: index/SearchSlowLog.java: per-index, per-level thresholds under
``index.search.slowlog.threshold.query.{warn,info,debug,trace}``; -1
disables a level. The search service (search/service.py) keeps a
bounded ``slowlog_recent`` list of entries::

    {"index": name, "took_ms": int, "level": "warn", "source": "...",
     "trace.id"?, "slowest_stage"?, "x_opaque_id"?, "tenant"?,
     "search.class"?, "cohort_fill_pct"?, "readbacks"?, "regime"?}

``slowest_stage`` is the profile's slowest stage when the body asked
``profile: true`` (``slowest_stage_summary``), else the search task's
stage timeline's (transport/tasks.py ``Task.slowest_stage``); the flight
recorder's summary of the request's trace (telemetry/flightrecorder.py
``summary_for_trace``: its launches, readbacks, worst cohort fill and
regime) rides along when the request ran under a trace.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.common.settings import parse_time_value

_slowlog_logger = logging.getLogger("index.search.slowlog")

LEVELS = ("warn", "info", "debug", "trace")
_LEVEL_NUM = {"warn": 30, "info": 20, "debug": 10, "trace": 5}

MAX_RECENT = 128


def slowest_stage_summary(response: Optional[Dict[str, Any]]
                          ) -> Optional[str]:
    """One-line summary of the slowest profile stage of a finished
    search response (``"launch 1.24ms [idx][0]"``), or None when the
    response carries no profile section. Coordinator phases compete
    with the shards' stages, except the ones that wrap them (``query_ns``
    always, ``fetch_ns`` when the shards carry their fetch entries)."""
    profile = (response or {}).get("profile") or {}
    worst: Optional[tuple] = None
    shard_fetch_seen = False
    for shard in profile.get("shards", []):
        try:
            bd = shard["searches"][0]["query"][0]["breakdown"]
        except (KeyError, IndexError, TypeError):
            continue
        for stage, ns in bd.items():
            if stage.endswith("_time_in_nanos") \
                    or not isinstance(ns, (int, float)):
                continue
            if worst is None or ns > worst[0]:
                worst = (ns, stage, shard.get("id", "?"))
        fetch = shard.get("fetch")
        if fetch:
            shard_fetch_seen = True
            if worst is None or fetch["time_in_nanos"] > worst[0]:
                worst = (fetch["time_in_nanos"], "fetch",
                         shard.get("id", "?"))
    phases = (profile.get("coordinator") or {}).get("phases") or {}
    for stage, ns in phases.items():
        if stage == "query_ns" or (stage == "fetch_ns"
                                   and shard_fetch_seen):
            continue
        if worst is None or ns > worst[0]:
            worst = (ns, stage.replace("_ns", ""), "coordinator")
    if worst is None:
        return None
    ns, stage, where = worst
    return f"{stage} {ns / 1e6:.2f}ms {where}"


def record_search_slowlog(
        settings_of: Callable[[str], Optional[Any]],
        index_names: List[str], took_ms: float, body: Dict[str, Any],
        recent: List[Dict[str, Any]],
        trace_id: Optional[str] = None,
        slowest_stage: Optional[str] = None,
        flight: Optional[Dict[str, Any]] = None,
        opaque_id: Optional[str] = None,
        tenant: Optional[str] = None,
        workload_class: Optional[str] = None) -> List[Dict[str, Any]]:
    """Check every searched index's thresholds against the search's took
    time; append the matches (the highest matching level an index) to
    ``recent`` and return the new entries. ``settings_of(name)`` yields
    a ``.get``-able settings view, or None for an unknown index.
    ``opaque_id`` (the ``X-Opaque-Id`` header), ``tenant`` and
    ``workload_class`` attribute the entry (``x_opaque_id``, ``tenant``,
    ``search.class``)."""
    new_entries: List[Dict[str, Any]] = []
    for name in index_names:
        settings = settings_of(name)
        if settings is None:
            continue
        for level in LEVELS:
            thr = settings.get(
                f"index.search.slowlog.threshold.query.{level}")
            if thr is None:
                continue
            thr_ms = parse_time_value(str(thr), "slowlog") * 1000
            if thr_ms < 0:
                continue                # -1 disables the level
            if took_ms >= thr_ms:
                entry = {"index": name, "took_ms": int(took_ms),
                         "level": level,
                         "source": json.dumps(body or {},
                                              default=str)[:1000]}
                if trace_id is not None:
                    entry["trace.id"] = trace_id
                if slowest_stage is not None:
                    entry["slowest_stage"] = slowest_stage
                if opaque_id is not None:
                    entry["x_opaque_id"] = opaque_id
                if tenant is not None:
                    entry["tenant"] = tenant
                if workload_class is not None:
                    entry["search.class"] = workload_class
                if flight:
                    entry["cohort_fill_pct"] = flight.get(
                        "cohort_fill_pct")
                    entry["readbacks"] = flight.get("readbacks")
                    entry["regime"] = flight.get("regime")
                _slowlog_logger.log(
                    _LEVEL_NUM[level],
                    "[%s] took[%dms], source[%s]",
                    name, took_ms, entry["source"])
                recent.append(entry)
                new_entries.append(entry)
                while len(recent) > MAX_RECENT:
                    recent.pop(0)
                break
    return new_entries


def indexing_thresholds(settings: Dict[str, Any]) -> List[tuple]:
    """(level, logging level, seconds) of each enabled
    ``index.indexing.slowlog.threshold.index.{level}``, parsed once a
    settings change (ref: index/IndexingSlowLog.java)."""
    out = []
    for level in LEVELS:
        thr = settings.get(f"index.indexing.slowlog.threshold.index.{level}")
        if thr is None:
            continue
        thr_s = parse_time_value(str(thr), "slowlog")
        if thr_s >= 0:               # -1 disables the level
            out.append((level, _LEVEL_NUM[level], thr_s))
    return out


def record_indexing_slowlog(thresholds: List[tuple], index: str,
                            doc_id: str, took_s: float,
                            recent: List[Dict[str, Any]]) -> None:
    """The indexing slow log: the first (highest) level whose threshold
    ``took_s`` reaches appends ``{"index", "id", "level", "took_ms"}``
    to ``recent`` (bounded)."""
    for level, py_level, thr_s in thresholds:
        if took_s >= thr_s:
            logging.getLogger("index.indexing.slowlog").log(
                py_level, "[%s] took[%.1fms], id[%s]", index,
                took_s * 1000, doc_id)
            recent.append({"index": index, "id": doc_id, "level": level,
                           "took_ms": took_s * 1000})
            while len(recent) > MAX_RECENT:
                recent.pop(0)
            break
