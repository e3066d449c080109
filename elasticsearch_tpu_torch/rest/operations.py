"""The node's operational routes (counterparts of the reference's
handlers in elasticsearch_tpu/rest/api.py), mixed into
``RestController``:

    GET  /_cluster/health         GET /_cat/health
    GET  /_health_report, /_health_report/{indicator}
    GET  /_cat/thread_pool        (and ``thread_pool`` in /_nodes/stats)
    POST /{index}/_freeze         POST /{index}/_unfreeze
    GET  /_migration/deprecations
    PUT|POST|GET|DELETE /_snapshot[/{repo}]     GET /_cat/repositories
    PUT|POST /_snapshot/{repo}/{snap}           ?wait_for_completion=false
    GET|DELETE /_snapshot/{repo}/{snap}         GET /_cat/snapshots/{repo}
    GET  /_snapshot/{repo}/{snap}/_status
    POST /_snapshot/{repo}/{snap}/_restore      {"indices", "rename_pattern",
                                                 "rename_replacement"}
    POST /_snapshot/{repo}/{snap}/_mount        {"index", "renamed_index"},
                                                ?storage=full_copy|shared_cache
    GET  /_searchable_snapshots/stats
    PUT|GET|DELETE /_slm/policy[/{id}]          POST /_slm/policy/{id}/_execute

One node has no routing table: ``_cluster/health`` counts every shard
of its indices active (``shard_availability_summary``, the one
implementation the ``shards_availability`` indicator renders too), and
``_health_report`` is the node's local report in the cluster report's
shape (details nested under the node's id). An unknown indicator is a
400 ``illegal_argument_exception``.

A snapshot with ``wait_for_completion=false`` runs as the task
``cluster:admin/snapshot/create`` on a background thread of the node's
(``Node.spawn``) and answers ``{"accepted": true, "task": ...}``; its
``{"snapshot": ...}`` (or its failure) is kept for ``GET /_tasks/{id}``.
A restore or a mount opens its index under the node's index lock.
"""

from __future__ import annotations

import time
from typing import Optional

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.health import (UnknownIndicatorError,
                                            merge_node_reports,
                                            shard_availability_summary)
from elasticsearch_tpu_torch.telemetry import flightrecorder as _flight
from elasticsearch_tpu_torch.xpack import searchable_snapshots as _ss

CLUSTER_NAME = "elasticsearch"
SNAPSHOT_CREATE_ACTION = "cluster:admin/snapshot/create"
# the node-level roots these routes take
OPS_ROOTS = ("_cluster", "_health_report", "_migration", "_snapshot",
             "_searchable_snapshots", "_slm")


class OperationsRoutes:
    """The operational handlers of ``RestController`` (rest/api.py)."""

    def _ops_handler(self, method: str, parts, params: dict, body):
        """The handler of a route under one of ``OPS_ROOTS``, or None."""
        n, root = len(parts), parts[0]
        if method == "GET" and parts == ["_cluster", "health"]:
            return lambda: (200, self._cluster_health())
        if method == "GET" and root == "_health_report" and n <= 2:
            return lambda: self._health_report(parts[1] if n == 2
                                               else None)
        if method == "GET" and parts == ["_migration", "deprecations"]:
            return self._deprecations
        if method == "GET" and parts == ["_searchable_snapshots", "stats"]:
            return self._searchable_snapshot_stats
        if root == "_snapshot":
            return self._snapshot_handler(method, parts[1:], params, body)
        if root == "_slm" and n >= 2 and parts[1] == "policy":
            return self._slm_handler(method, parts[2:], body)
        return None

    # ---------------------------------------------------------- health
    def _cluster_health(self) -> dict:
        summary = shard_availability_summary(None)
        # one node: every shard of its indices is local and started
        shards = self.node.shard_count()
        summary["active_primary_shards"] = shards
        summary["active_shards"] = shards
        total = (summary["active_shards"] + summary["unassigned_shards"]
                 + summary["initializing_shards"])
        pct = (100.0 * summary["active_shards"] / total) if total else 100.0
        return {
            "cluster_name": CLUSTER_NAME,
            "status": summary["status"],
            "timed_out": False,
            "number_of_nodes": 1,
            "number_of_data_nodes": 1,
            "active_primary_shards": summary["active_primary_shards"],
            "active_shards": summary["active_shards"],
            "relocating_shards": summary["relocating_shards"],
            "initializing_shards": summary["initializing_shards"],
            "unassigned_shards": summary["unassigned_shards"],
            "delayed_unassigned_shards": 0,
            "number_of_pending_tasks": 0,
            "number_of_in_flight_fetch": len(
                self.node.task_manager.list_tasks(actions="*phase/fetch*")),
            "active_shards_percent_as_number": pct,
        }

    def _health_report(self, indicator: Optional[str]):
        health = self.node.health
        try:
            local = health.local_report(indicator)
        except UnknownIndicatorError:
            return 400, {"error": {
                "type": "illegal_argument_exception",
                "reason": f"unknown health indicator [{indicator}]; one of "
                          f"{health.indicator_names()}"}}
        report = merge_node_reports({self.node.node_id: local})
        report["cluster_name"] = CLUSTER_NAME
        return 200, report

    def _cat_health(self, params: dict) -> str:
        h = self._cluster_health()
        return (f"{int(time.time())} {CLUSTER_NAME} {h['status']} "
                f"{h['number_of_nodes']} {h['number_of_data_nodes']}")

    def _cat_thread_pool(self, params: dict) -> str:
        """node pool active queue rejected, a row a pool."""
        return "\n".join(
            f"{self.node.node_id} {name} {st['active']} {st['queue']} "
            f"{st['rejected']}"
            for name, st in sorted(self.node.threadpool.stats().items()))

    # ---------------------------------------------------------- frozen
    def _freeze(self, expression: str, params: dict, body):
        for name in self.node.indices.resolve(expression):
            self.node.freeze_index(name)
        return 200, {"acknowledged": True, "shards_acknowledged": True}

    def _unfreeze(self, expression: str, params: dict, body):
        for name in self.node.indices.resolve(expression):
            self.node.unfreeze_index(name)
        return 200, {"acknowledged": True, "shards_acknowledged": True}

    def _targets_only_frozen(self, expression: str) -> bool:
        """Whether every index ``expression`` names is frozen (a search
        of them runs on ``search_throttled``)."""
        try:
            names = self.node.indices.resolve(expression)
        except Exception:   # resolution errors surface in the search
            return False
        return bool(names) and all(self.node.indices[n].is_frozen
                                   for n in names)

    def _deprecations(self):
        index_issues = {}
        for name in sorted(self.node.indices):
            if self.node.indices[name].is_frozen:
                index_issues[name] = [{
                    "level": "warning",
                    "message": "frozen indices are deprecated",
                    "details": "use searchable snapshots or the cold tier "
                               "instead of freezing indices",
                    "url": "https://ela.st/es-deprecation-7-frozen-index"}]
        return 200, {"cluster_settings": [], "node_settings": [],
                     "index_settings": index_issues, "ml_settings": []}

    # ------------------------------------------------------- snapshots
    def _snapshot_handler(self, method: str, rest, params: dict, body):
        repos = self.node.repositories_service
        n = len(rest)
        if n == 0 and method == "GET":
            return lambda: (200, repos.get_configs(None))
        if n == 1:
            name = rest[0]
            if method in ("PUT", "POST"):
                return lambda: (repos.put_repository(name, body or {}),
                                (200, {"acknowledged": True}))[1]
            if method == "GET":
                return lambda: (200, repos.get_configs(name))
            if method == "DELETE":
                return lambda: (repos.delete_repository(name),
                                (200, {"acknowledged": True}))[1]
        if n == 2:
            repo, snap = rest
            if method in ("PUT", "POST"):
                return lambda: self._create_snapshot(repo, snap, params,
                                                     body)
            if method == "GET":
                return lambda: self._get_snapshots(repo, snap)
            if method == "DELETE":
                return lambda: self._delete_snapshots(repo, snap)
        if n == 3:
            repo, snap, action = rest
            if method == "GET" and action == "_status":
                return lambda: (200, {"snapshots": [
                    repos.get_repository(repo).snapshot_status(s)
                    for s in snap.split(",")]})
            if method == "POST" and action == "_restore":
                return lambda: self._restore(repo, snap, body)
            if method == "POST" and action == "_mount":
                return lambda: self._mount(repo, snap, params, body)
        return None

    def _create_snapshot(self, repo_name: str, snap: str, params: dict,
                         body):
        body = body or {}
        repo = self.node.repositories_service.get_repository(repo_name)
        expression = body.get("indices", "_all")
        if isinstance(expression, list):
            expression = ",".join(expression)
        indices = [self.node.indices[n]
                   for n in self.node.indices.resolve(expression)]

        def run():
            return {"snapshot": repo.snapshot(
                snap, indices,
                include_global_state=body.get("include_global_state",
                                              True),
                metadata=body.get("metadata"))}

        if params.get("wait_for_completion") != "false":
            return 200, run()
        tm = self.node.task_manager
        task = tm.register("transport", SNAPSHOT_CREATE_ACTION,
                           cancellable=True)

        def runner():
            from elasticsearch_tpu_torch.rest.api import error_answer
            try:
                with _flight.activate(self.node.flight):
                    result = run()
            except Exception as e:   # a background failure is stored
                result = {"error": error_answer(e)[1]}
            try:
                self.node.task_results.store(task.id, result)
            finally:
                tm.unregister(task)

        try:
            self.node.spawn(f"{SNAPSHOT_CREATE_ACTION}[{task.id}]", runner)
        except BaseException:
            tm.unregister(task)
            raise
        return 200, {"accepted": True,
                     "task": f"{self.node.node_id}:{task.id}"}

    def _get_snapshots(self, repo_name: str, snap: str):
        repo = self.node.repositories_service.get_repository(repo_name)
        if snap in ("_all", "*"):
            return 200, {"snapshots": repo.list_snapshots()}
        return 200, {"snapshots": [repo.get_snapshot(s)["info"]
                                   for s in snap.split(",")]}

    def _delete_snapshots(self, repo_name: str, snap: str):
        repo = self.node.repositories_service.get_repository(repo_name)
        for s in snap.split(","):
            repo.delete_snapshot(s)
        return 200, {"acknowledged": True}

    def _restore(self, repo_name: str, snap: str, body):
        body = body or {}
        repo = self.node.repositories_service.get_repository(repo_name)
        indices = body.get("indices")
        if isinstance(indices, str):
            indices = indices.split(",")
        with self.node._indices_lock:
            return 200, repo.restore(
                snap, self.node.indices, indices=indices,
                rename_pattern=body.get("rename_pattern"),
                rename_replacement=body.get("rename_replacement"))

    def _mount(self, repo_name: str, snap: str, params: dict, body):
        body = body or {}
        index = body.get("index")
        if not index:
            raise IllegalArgumentException("[index] is required")
        with self.node._indices_lock:
            return 200, _ss.mount(self.node, repo_name, snap, index,
                                  body.get("renamed_index", index),
                                  storage=params.get("storage",
                                                     "full_copy"))

    def _searchable_snapshot_stats(self):
        indices = {}
        for name in sorted(self.node.indices):
            settings = self.node.indices[name].settings
            if str(settings.get("index.store.type", "")) == "snapshot":
                indices[name] = {
                    "repository": settings.get(
                        "index.store.snapshot.repository_name"),
                    "snapshot": settings.get(
                        "index.store.snapshot.snapshot_name"),
                    "storage": settings.get(
                        "index.store.snapshot.storage", "full_copy")}
        return 200, {"total": len(indices), "indices": indices,
                     "shared_cache": _ss.node_cache(
                         self.node.data_path).stats()}

    def _cat_repositories(self, params: dict) -> str:
        return "\n".join(f"{name} fs" for name in sorted(
            self.node.repositories_service.get_configs(None)))

    def _cat_snapshots(self, repo_name: str) -> str:
        """id status start_epoch end_epoch duration indices
        successful_shards failed_shards total_shards, a row a snapshot."""
        repo = self.node.repositories_service.get_repository(repo_name)
        lines = []
        for s in repo.list_snapshots():
            start = s.get("start_time_in_millis", 0)
            end = s.get("end_time_in_millis", 0)
            duration_s = max(0, end - start) // 1000 if end else 0
            shards = s.get("shards", {}) or {}
            lines.append(
                f"{s['snapshot']} {s.get('state', 'SUCCESS')} "
                f"{start // 1000} {end // 1000} {duration_s}s "
                f"{len(s.get('indices', []))} "
                f"{shards.get('successful', 0)} {shards.get('failed', 0)} "
                f"{shards.get('total', 0)}")
        return "\n".join(lines)

    # ------------------------------------------------------------- SLM
    def _slm_handler(self, method: str, rest, body):
        slm = self.node.slm_service
        n = len(rest)
        if n == 0 and method == "GET":
            return lambda: (200, slm.get_policies(None))
        if n == 1:
            pid = rest[0]
            if method == "PUT":
                return lambda: (slm.put_policy(pid, body or {}),
                                (200, {"acknowledged": True}))[1]
            if method == "GET":
                return lambda: (200, slm.get_policies(pid))
            if method == "DELETE":
                return lambda: (slm.delete_policy(pid),
                                (200, {"acknowledged": True}))[1]
        if n == 2 and rest[1] == "_execute" and method == "POST":
            return lambda: (200, slm.execute_policy(rest[0]))
        return None
