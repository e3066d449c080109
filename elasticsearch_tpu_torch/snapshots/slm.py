"""Snapshot lifecycle management (the port's copy of
elasticsearch_tpu/snapshots/slm.py, the single-node half).

ref: x-pack/plugin/ilm SLM half (SnapshotLifecycleService,
SnapshotRetentionTask): named policies — repository + snapshot-name
template + indices config + retention — persisted in
``_slm_policies.json`` under the data path, executed on demand via
``POST /_slm/policy/{id}/_execute`` (the reference schedules via its
cron trigger engine). Execution resolves the policy's indices on the
node and snapshots them inline; retention (``expire_after``,
``min_count``, ``max_count``) is applied after every execution, and
each execution's name gets a random suffix, so two on the same day
never collide.

Policies may carry a ``schedule`` interval (``"30m"``-style). There is
no background timer thread — scheduling is evaluated lazily against the
injected clock whenever the policy surface is read (``tick()`` from
``get_policies``). The cluster backend (a snapshot handed to the
distributed snapshot service) comes with the cluster slice.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    ResourceNotFoundException,
)


class SnapshotLifecycleService:
    def __init__(self, repositories_service, indices_service,
                 data_path: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.repositories = repositories_service
        self.indices = indices_service
        # injectable wall-clock seam: retention cutoffs, success stamps
        # and date-math snapshot names all derive from one clock so
        # deterministic tests can replay retention decisions
        self.clock = clock or time.time
        self._policies: Dict[str, Dict[str, Any]] = {}
        self._stats: Dict[str, Dict[str, Any]] = {}
        self._last_run: Dict[str, float] = {}
        self._path = (os.path.join(data_path, "_slm_policies.json")
                      if data_path else None)
        if data_path:
            os.makedirs(data_path, exist_ok=True)
        if self._path and os.path.exists(self._path):
            with open(self._path) as fh:
                self._policies = json.load(fh)

    # ------------------------------------------------------------ registry
    def put_policy(self, policy_id: str, policy: Dict[str, Any]):
        if not isinstance(policy, dict) or "repository" not in policy:
            raise IllegalArgumentException(
                "[repository] is required for a snapshot lifecycle policy")
        # validate the repository exists up front (as the reference does)
        self.repositories.get_repository(policy["repository"])
        self._policies[policy_id] = policy
        # a freshly-put scheduled policy first fires one full interval
        # from now, never retroactively
        self._last_run[policy_id] = self.clock()
        self._persist()

    def get_policies(self, policy_id: Optional[str] = None) -> Dict[str, Any]:
        self.tick()
        if policy_id is None:
            return {pid: self._describe(pid) for pid in self._policies}
        if policy_id not in self._policies:
            raise ResourceNotFoundException(
                f"snapshot lifecycle policy [{policy_id}] not found")
        return {policy_id: self._describe(policy_id)}

    def _describe(self, pid: str) -> Dict[str, Any]:
        out = {"policy": self._policies[pid], "version": 1}
        out.update(self._stats.get(pid, {}))
        return out

    def delete_policy(self, policy_id: str):
        if policy_id not in self._policies:
            raise ResourceNotFoundException(
                f"snapshot lifecycle policy [{policy_id}] not found")
        del self._policies[policy_id]
        self._last_run.pop(policy_id, None)
        self._stats.pop(policy_id, None)
        self._persist()

    def _persist(self):
        if self._path:
            tmp = self._path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(self._policies, fh)
            os.replace(tmp, self._path)

    # ---------------------------------------------------------- scheduling
    def tick(self) -> List[str]:
        """Lazily evaluate interval schedules against the injected clock
        and execute any policy whose interval has elapsed. Returns the
        policy ids fired this tick (deterministic order)."""
        now = self.clock()
        fired: List[str] = []
        for pid in sorted(self._policies):
            sched = self._policies[pid].get("schedule")
            # cron-style schedules ("0 30 1 * * ?") are stored and
            # executable via explicit _execute, but only interval
            # schedules ("1h") fire from the lazy clock tick
            interval = _interval_ms(sched) if sched else None
            if interval is None:
                continue
            last = self._last_run.get(pid)
            if last is None:
                # policy loaded from disk: seed, don't fire retroactively
                self._last_run[pid] = now
                continue
            if now - last < interval / 1000.0:
                continue
            fired.append(pid)
            try:
                self.execute_policy(pid)
            except Exception as exc:  # noqa: BLE001 — surfaced in stats
                self._stats.setdefault(pid, {})["last_failure"] = {
                    "time": int(now * 1000), "details": str(exc)}
        return fired

    # ----------------------------------------------------------- execution
    def execute_policy(self, policy_id: str) -> Dict[str, Any]:
        if policy_id not in self._policies:
            raise ResourceNotFoundException(
                f"snapshot lifecycle policy [{policy_id}] not found")
        policy = self._policies[policy_id]
        repo = self.repositories.get_repository(policy["repository"])
        name = self._resolve_name(policy.get("name", f"<{policy_id}-{{now/d}}>"),
                                  now=self.clock())
        config = policy.get("config", {})
        index_expr = config.get("indices", "*")
        if isinstance(index_expr, list):
            index_expr = ",".join(index_expr)
        metadata = {"policy": policy_id}
        self._last_run[policy_id] = self.clock()
        try:
            names = self.indices.resolve(index_expr)
            indices = [self.indices.get(n) for n in names]
            repo.snapshot(name, indices, metadata=metadata)
        except Exception as exc:
            self._stats.setdefault(policy_id, {})["last_failure"] = {
                "snapshot_name": name,
                "time": int(self.clock() * 1000),
                "details": str(exc)}
            raise
        self._stats.setdefault(policy_id, {})["last_success"] = {
            "snapshot_name": name, "time": int(self.clock() * 1000)}
        self._apply_retention(policy_id, policy, repo)
        return {"snapshot_name": name}

    def _apply_retention(self, policy_id: str, policy: Dict[str, Any],
                         repo) -> None:
        retention = policy.get("retention")
        if not retention:
            return
        mine = [s for s in repo.list_snapshots()
                if s.get("metadata", {}).get("policy") == policy_id]
        mine.sort(key=lambda s: s["start_time_in_millis"])
        max_count = retention.get("max_count")
        expire_after = retention.get("expire_after")
        to_delete: List[str] = []
        if expire_after:
            cutoff = self.clock() * 1000 - _parse_ms(expire_after)
            min_count = retention.get("min_count", 0)
            expired = [s for s in mine
                       if s["start_time_in_millis"] < cutoff]
            keepable = len(mine) - len(expired)
            while expired and keepable < min_count:
                expired.pop()  # keep the newest expired ones
                keepable += 1
            to_delete.extend(s["snapshot"] for s in expired)
        if max_count is not None and len(mine) - len(to_delete) > max_count:
            surviving = [s for s in mine
                         if s["snapshot"] not in set(to_delete)]
            excess = len(surviving) - max_count
            to_delete.extend(s["snapshot"] for s in surviving[:excess])
        for name in to_delete:
            repo.delete_snapshot(name)

    @staticmethod
    def _resolve_name(template: str, now: float) -> str:
        """``<prefix-{now/d}>`` date-math names (ref: date-math index name
        resolver used for snapshot names) stamped from the service clock.
        A random suffix is appended — as the reference does — so
        re-executions within one date bucket never collide."""
        import uuid
        name = template.strip()
        if name.startswith("<") and name.endswith(">"):
            name = name[1:-1]
        stamp = time.strftime("%Y.%m.%d", time.gmtime(now))
        name = re.sub(r"\{now(?:/[dhm])?(?:\{.*?\})?\}", stamp, name)
        return f"{name.lower()}-{uuid.uuid4().hex[:8]}"


def _parse_ms(v: str) -> float:
    units = {"ms": 1.0, "s": 1000.0, "m": 60_000.0, "h": 3_600_000.0,
             "d": 86_400_000.0}
    for suffix in ("ms", "s", "m", "h", "d"):
        if str(v).endswith(suffix):
            return float(str(v)[: -len(suffix)]) * units[suffix]
    return float(v)


def _interval_ms(v: str) -> Optional[float]:
    """``_parse_ms`` for schedules: None for non-interval (cron) forms."""
    try:
        return _parse_ms(v)
    except (TypeError, ValueError):
        return None
