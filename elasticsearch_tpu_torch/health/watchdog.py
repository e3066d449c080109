"""Stalled-progress watchdog: detects work that stopped moving (the
port's copy of elasticsearch_tpu/health/watchdog.py).

Point-in-time surfaces show a recovery at ``stage=index, 40%`` — they
cannot show that the same recovery reported 40% for the last five
minutes. The watchdog keeps a tiny progress fingerprint per tracked
resource and, when the fingerprint stops changing past a threshold,
emits a typed finding and bumps ``watchdog.stalls{kind}`` (on the
*transition* into stalled, not per sweep). It never kills anything —
findings surface through ``GET /_health_report`` (recovery_progress
indicator) and the counter; operators decide.

Tracked resources:

- **recovery** — a live recovery (a ``RecoveryState``) whose
  ``recovered_bytes + translog_ops_replayed`` and stage are both
  unchanged for ``stall_after_s``;
- **task** — a registered task running past ``task_deadline_s``
  whose ``profile_stage`` hasn't changed for ``stall_after_s``;
- **cluster_state_lag** — a follower whose applied-version lag (the
  detector, leader view) has been non-zero and non-shrinking for
  ``stall_after_s``.

Runs on the injected clock only (the node's metrics clock). Lazy —
callers (HealthService) invoke ``sweep()`` before reading — with an
opt-in periodic mode via ``start(scheduler)``; the port's node has no
scheduler and sweeps once a report. One node tracks its tasks; it has
no recoveries in flight, no followers and no cluster snapshots.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

DEFAULT_STALL_AFTER_S = 30.0
DEFAULT_TASK_DEADLINE_S = 120.0
DEFAULT_SWEEP_INTERVAL_S = 15.0

KIND_RECOVERY = "recovery"
KIND_TASK = "task"
KIND_STATE_LAG = "cluster_state_lag"
KIND_SNAPSHOT = "snapshot"


class StalledProgressWatchdog:
    def __init__(self, clock: Callable[[], float],
                 metrics=None,
                 recoveries_fn: Optional[Callable[[], Dict]] = None,
                 tasks_fn: Optional[Callable[[], List[Any]]] = None,
                 lag_fn: Optional[Callable[[], Dict[str, int]]] = None,
                 snapshots_fn: Optional[Callable[[], Dict]] = None,
                 stall_after_s: float = DEFAULT_STALL_AFTER_S,
                 task_deadline_s: float = DEFAULT_TASK_DEADLINE_S):
        self.clock = clock
        self.metrics = metrics
        self.recoveries_fn = recoveries_fn
        self.tasks_fn = tasks_fn
        self.lag_fn = lag_fn
        self.snapshots_fn = snapshots_fn
        self.stall_after_s = stall_after_s
        self.task_deadline_s = task_deadline_s
        self._lock = threading.Lock()
        # resource key -> (fingerprint, last_change_ts, stalled?)
        self._progress: Dict[Tuple[str, str], Tuple[Any, float, bool]] = {}
        self._findings: List[Dict[str, Any]] = []
        self._task = None  # periodic-mode Cancellable

    # -- sweep ------------------------------------------------------------

    def sweep(self) -> List[Dict[str, Any]]:
        """One detection pass; returns (and caches) current findings in
        deterministic (kind, resource) order."""
        now = self.clock()
        observations: List[Tuple[str, str, Any, Dict[str, Any]]] = []
        if self.recoveries_fn is not None:
            for rec in self.recoveries_fn().values():
                if rec.stage in ("done", "failed", "cancelled"):
                    continue
                resource = f"{rec.index}[{rec.shard_id}]"
                fp = (rec.stage, rec.recovered_bytes,
                      rec.translog_ops_replayed)
                observations.append((KIND_RECOVERY, resource, fp, {
                    "stage": rec.stage,
                    "recovered_bytes": rec.recovered_bytes,
                    "total_bytes": rec.total_bytes,
                }))
        if self.tasks_fn is not None:
            for t in self.tasks_fn():
                running_s = t.running_time_nanos() / 1e9
                if running_s < self.task_deadline_s:
                    continue
                resource = f"task:{t.id}"
                observations.append((KIND_TASK, resource,
                                     t.profile_stage, {
                                         "action": t.action,
                                         "running_s": running_s,
                                         "profile_stage": t.profile_stage,
                                     }))
        if self.snapshots_fn is not None:
            for handle in self.snapshots_fn().values():
                if handle.get("state") != "STARTED":
                    continue
                snap_uuid, index, shard_id = handle["key"]
                resource = f"{snap_uuid}:{index}[{shard_id}]"
                # bytes-uploaded progress fingerprint: an in-flight shard
                # snapshot whose upload counters stop moving is stalled
                fp = (handle.get("bytes_uploaded", 0),
                      handle.get("bytes_skipped", 0),
                      handle.get("files_done", 0))
                observations.append((KIND_SNAPSHOT, resource, fp, {
                    "snapshot": handle.get("snapshot"),
                    "bytes_uploaded": handle.get("bytes_uploaded", 0),
                    "bytes_total": handle.get("bytes_total", 0),
                    "files_done": handle.get("files_done", 0),
                }))
        if self.lag_fn is not None:
            for node_id, lag in sorted((self.lag_fn() or {}).items()):
                if lag <= 0:
                    continue
                # fingerprint is the lag itself: a shrinking lag is
                # progress, a constant one is a stuck follower
                observations.append((KIND_STATE_LAG, node_id, lag,
                                     {"versions_behind": lag}))
        findings: List[Dict[str, Any]] = []
        with self._lock:
            seen = set()
            for kind, resource, fp, detail in observations:
                key = (kind, resource)
                seen.add(key)
                prev = self._progress.get(key)
                if prev is None or prev[0] != fp:
                    self._progress[key] = (fp, now, False)
                    continue
                stalled_for = now - prev[1]
                if stalled_for < self.stall_after_s:
                    continue
                if not prev[2]:
                    # transition into stalled: count it once
                    self._progress[key] = (fp, prev[1], True)
                    if self.metrics is not None:
                        self.metrics.inc("watchdog.stalls", kind=kind)
                findings.append({
                    "kind": kind, "resource": resource,
                    "stalled_for_s": stalled_for, "detail": detail,
                })
            # resources that finished/vanished stop being tracked
            self._progress = {k: v for k, v in self._progress.items()
                              if k in seen}
            findings.sort(key=lambda f: (f["kind"], f["resource"]))
            self._findings = findings
        return list(findings)

    def findings(self) -> List[Dict[str, Any]]:
        """Findings from the most recent sweep (no re-sweep)."""
        with self._lock:
            return list(self._findings)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "tracked": len(self._progress),
                "stalled": len(self._findings),
                "stall_after_s": self.stall_after_s,
                "task_deadline_s": self.task_deadline_s,
            }

    # -- periodic mode (opt-in) ------------------------------------------

    def start(self, scheduler,
              interval: float = DEFAULT_SWEEP_INTERVAL_S) -> None:
        if self._task is not None:
            return

        def _tick() -> None:
            self.sweep()
            self._task = scheduler.schedule(
                interval, _tick, "watchdog-sweep")

        self._task = scheduler.schedule(interval, _tick, "watchdog-sweep")

    def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
