"""Task management: every action execution is a registered task (the
port's copy of the single-node half of elasticsearch_tpu/transport/
tasks.py).

Ref: tasks/TaskManager.java — every action registers a Task; tasks form
a parent/child tree; cancellable tasks support cooperative cancellation
with bans (a cancelled parent bans its id, so a child registered after
the cancel is cancelled on arrival); the `_tasks` list/cancel APIs sit
on top.

A task records the trace that was ambient at registration
(telemetry/context.py), and its current profile stage (search/
profile.py ``stage_hook``): ``GET /_tasks?detailed=true`` and
``GET /_nodes/hot_threads`` show where a long-running search is. The
port also keeps each task's stage timeline (``enter_stage``): the
nanoseconds spent in each stage since the previous one was entered,
from which the slow log names a search's slowest stage.

What waits for the cluster layer: bans sent to other nodes and the
registration of a remote caller's children (the reference's
``register_child_of_incoming``); tenant and workload stamps wait for
the port's telemetry of them.
"""

from __future__ import annotations

import base64
import fnmatch
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException, ResourceNotFoundException,
    TaskCancelledException)
from elasticsearch_tpu_torch.telemetry import context as _telectx

# every live TaskManager, for the tests' leak guard: a task registered
# during a test and never unregistered is a leak
_MANAGERS: "weakref.WeakSet[TaskManager]" = weakref.WeakSet()


def open_task_keys() -> set:
    """(node_id, task_id, action) of every currently registered task,
    across all live managers in the process."""
    out = set()
    for mgr in list(_MANAGERS):
        with mgr._lock:
            for t in mgr._tasks.values():
                out.add((mgr.node_id, t.id, t.action))
    return out


@dataclass(frozen=True)
class TaskId:
    node_id: str
    id: int

    def __str__(self) -> str:
        return f"{self.node_id}:{self.id}"

    @staticmethod
    def parse(s: str) -> "TaskId":
        node, _, num = s.rpartition(":")
        try:
            return TaskId(node, int(num))
        except ValueError:
            raise IllegalArgumentException(f"malformed task id {s}")


EMPTY_TASK_ID = TaskId("", -1)


def encode_node_scoped_id(node_id: str, seq: int) -> str:
    """An opaque id that embeds its owning node (the reference's
    AsyncExecutionId: the async-search id encodes node + task)."""
    raw = f"{node_id}:{seq}"
    return base64.urlsafe_b64encode(raw.encode()).decode().rstrip("=")


def decode_node_scoped_id(s: str) -> TaskId:
    """Inverse of ``encode_node_scoped_id``; a malformed id raises
    ResourceNotFoundException (an unroutable id is a missing
    resource)."""
    try:
        pad = "=" * (-len(s) % 4)
        raw = base64.urlsafe_b64decode((s + pad).encode()).decode()
        node_id, _, num = raw.rpartition(":")
        if not node_id:
            raise ValueError(raw)
        return TaskId(node_id, int(num))
    except Exception:
        raise ResourceNotFoundException(s)


class Task:
    def __init__(self, task_id: int, type_: str, action: str,
                 description: str = "",
                 parent_task_id: TaskId = EMPTY_TASK_ID):
        self.id = task_id
        self.type = type_
        self.action = action
        self.description = description
        self.parent_task_id = parent_task_id
        # the epoch display field of `_tasks`; running time reads the
        # monotonic clock
        self.start_time = time.time()
        # the task's current profile stage (rewrite, bind, launch,
        # fetch, ...), published by the profile's stage hook
        self.profile_stage: Optional[str] = None
        self._start = time.monotonic()
        # nanoseconds a stage, each stage's time running until the
        # next stage is entered (``enter_stage``)
        self.stage_ns: Dict[str, int] = {}
        self._stage_t0: Optional[int] = None
        ctx = _telectx.current()
        self.trace_id: Optional[str] = ctx.trace_id if ctx else None

    def running_time_nanos(self) -> int:
        return int((time.monotonic() - self._start) * 1e9)

    def enter_stage(self, stage: str) -> None:
        """The stage hook's callback: the time since the previous stage
        was entered goes to that stage, and ``stage`` is current."""
        now = time.monotonic_ns()
        prev = self.profile_stage
        if prev is not None and self._stage_t0 is not None:
            self.stage_ns[prev] = self.stage_ns.get(prev, 0) \
                + now - self._stage_t0
        self.profile_stage = stage
        self._stage_t0 = now

    def slowest_stage(self) -> Optional[str]:
        """``"launch 1.24ms task"``: the stage of the timeline (the
        current one counted to now) that took longest, or None."""
        spent = dict(self.stage_ns)
        if self.profile_stage is not None and self._stage_t0 is not None:
            spent[self.profile_stage] = spent.get(self.profile_stage, 0) \
                + time.monotonic_ns() - self._stage_t0
        if not spent:
            return None
        stage = max(spent, key=spent.get)
        return f"{stage} {spent[stage] / 1e6:.2f}ms task"

    def to_dict(self, node_id: str) -> Dict[str, Any]:
        d = {
            "node": node_id,
            "id": self.id,
            "type": self.type,
            "action": self.action,
            "description": self.description,
            "start_time_in_millis": int(self.start_time * 1000),
            "running_time_in_nanos": self.running_time_nanos(),
            "cancellable": isinstance(self, CancellableTask),
        }
        if self.trace_id is not None:
            d["trace.id"] = self.trace_id
        if self.profile_stage is not None:
            d["profile_stage"] = self.profile_stage
        if self.parent_task_id is not EMPTY_TASK_ID and \
                self.parent_task_id.id != -1:
            d["parent_task_id"] = str(self.parent_task_id)
        if isinstance(self, CancellableTask):
            d["cancelled"] = self.is_cancelled()
        return d


class CancellableTask(Task):
    """Cooperative cancellation: long-running work polls
    ``ensure_not_cancelled()`` (ref: CancellableTask.java)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._cancelled = threading.Event()
        self._reason: Optional[str] = None
        self._listeners: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    def cancel(self, reason: str = "by user request") -> None:
        with self._lock:
            if self._cancelled.is_set():
                return
            self._reason = reason
            self._cancelled.set()
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn()
            except Exception:
                pass

    def add_cancellation_listener(self, fn: Callable[[], None]) -> None:
        with self._lock:
            run_now = self._cancelled.is_set()
            if not run_now:
                self._listeners.append(fn)
        if run_now:
            fn()

    def is_cancelled(self) -> bool:
        return self._cancelled.is_set()

    def cancellation_reason(self) -> Optional[str]:
        return self._reason

    def ensure_not_cancelled(self) -> None:
        if self.is_cancelled():
            raise TaskCancelledException(
                f"task cancelled [{self._reason}]")


class TaskManager:
    """The node's live-task registry and its cancellation bans (ref:
    TaskManager.register / cancelTaskAndDescendants / setBan)."""

    def __init__(self, node_id: str, first_id: int = 0):
        self.node_id = node_id
        # the last id handed out (a restarted node starts past the task
        # results it stored)
        self._seq = first_id
        self._lock = threading.Lock()
        self._tasks: Dict[int, Task] = {}
        # banned parent ids: children arriving after the ban are
        # cancelled immediately
        self._bans: Dict[TaskId, str] = {}
        self.started_total = 0
        self.completed_total = 0
        self.cancelled_total = 0
        self.peak_concurrent = 0
        _MANAGERS.add(self)

    def register(self, type_: str, action: str, description: str = "",
                 parent_task_id: TaskId = EMPTY_TASK_ID,
                 cancellable: bool = False) -> Task:
        with self._lock:
            self._seq += 1
            cls = CancellableTask if cancellable else Task
            task = cls(self._seq, type_, action, description,
                       parent_task_id)
            self._tasks[task.id] = task
            self.started_total += 1
            self.peak_concurrent = max(self.peak_concurrent,
                                       len(self._tasks))
            ban_reason = self._bans.get(parent_task_id)
        if ban_reason is not None and isinstance(task, CancellableTask):
            self._count_cancelled(task)
            task.cancel(f"parent banned [{ban_reason}]")
        return task

    def unregister(self, task: Task) -> None:
        with self._lock:
            removed = self._tasks.pop(task.id, None)
            if removed is not None:
                self.completed_total += 1
            # the ban (if any) dies with the task
            self._bans.pop(TaskId(self.node_id, task.id), None)

    def get_task(self, task_id: int) -> Optional[Task]:
        with self._lock:
            return self._tasks.get(task_id)

    def list_tasks(self, actions: Optional[str] = None) -> List[Task]:
        with self._lock:
            tasks = list(self._tasks.values())
        if actions:
            patterns = [p.strip() for p in actions.split(",") if p.strip()]
            tasks = [t for t in tasks
                     if any(fnmatch.fnmatch(t.action, p) for p in patterns)]
        return tasks

    def cancel(self, task: CancellableTask, reason: str,
               ban_children: bool = True) -> None:
        self._count_cancelled(task)
        # the ban goes up before listeners run: a listener may complete
        # and unregister the task, and unregistration sweeps the ban
        if ban_children:
            with self._lock:
                self._bans[TaskId(self.node_id, task.id)] = reason
        task.cancel(reason)
        if ban_children:
            for child in self._children_of(TaskId(self.node_id, task.id)):
                if isinstance(child, CancellableTask):
                    self.cancel(child, reason, ban_children=True)

    def _count_cancelled(self, task: CancellableTask) -> None:
        with self._lock:
            if task.is_cancelled():
                return      # an idempotent cancel counts once
            self.cancelled_total += 1

    def ban_count(self) -> int:
        with self._lock:
            return len(self._bans)

    def _children_of(self, parent: TaskId) -> List[Task]:
        with self._lock:
            return [t for t in self._tasks.values()
                    if t.parent_task_id == parent]

    def task_scope(self, type_: str, action: str, description: str = "",
                   parent_task_id: TaskId = EMPTY_TASK_ID,
                   cancellable: bool = False) -> "_TaskScope":
        return _TaskScope(self, type_, action, description, parent_task_id,
                          cancellable)

    def stats(self) -> Dict[str, Any]:
        """The ``tasks`` section of ``GET /_nodes/stats``."""
        with self._lock:
            current = len(self._tasks)
        return {"current": current,
                "peak_concurrent": self.peak_concurrent,
                "started": self.started_total,
                "completed": self.completed_total,
                "cancelled": self.cancelled_total,
                "bans": self.ban_count()}


class TaskResultStore:
    """Completed results of background (``wait_for_completion=false``)
    actions, keyed by task number: the in-memory half of the reference's
    ``.tasks`` result index, so ``GET /_tasks/{id}`` answers after the
    task unregistered. Bounded FIFO: the oldest result falls off past
    ``capacity``. ``persist(task_id, result)`` (the node's ``.tasks``
    index) is called for each stored result, best effort: storing a
    result never fails the action that produced it."""

    def __init__(self, capacity: int = 256,
                 persist: Optional[Callable[[int, Any], None]] = None):
        self.capacity = capacity
        self.persist = persist
        self._lock = threading.Lock()
        self._results: Dict[int, Any] = {}
        self._order: List[int] = []

    def store(self, task_id: int, result: Any) -> None:
        with self._lock:
            if task_id not in self._results:
                self._order.append(task_id)
            self._results[task_id] = result
            while len(self._order) > self.capacity:
                self._results.pop(self._order.pop(0), None)
        if self.persist is not None:
            try:
                self.persist(task_id, result)
            except Exception:   # noqa: BLE001 -- best effort, as the
                pass            # reference's TaskResultsService.storeResult

    def get(self, task_id: int) -> Optional[Any]:
        with self._lock:
            return self._results.get(task_id)


class _TaskScope:
    def __init__(self, manager: TaskManager, type_: str, action: str,
                 description: str, parent: TaskId, cancellable: bool):
        self._manager = manager
        self._args = (type_, action, description, parent, cancellable)
        self.task: Optional[Task] = None

    def __enter__(self) -> Task:
        t, a, d, p, c = self._args
        self.task = self._manager.register(t, a, d, p, c)
        return self.task

    def __exit__(self, *exc) -> None:
        if self.task is not None:
            self._manager.unregister(self.task)


# ---------------------------------------------------------------------------
# `_tasks` response shaping, one code path for every surface that renders
# the per-node task lists (ref: RestListTasksAction's group-by rendering)
# ---------------------------------------------------------------------------

def filter_task_dicts(tasks: List[Dict[str, Any]],
                      actions: Optional[str] = None,
                      parent_task_id: Optional[str] = None,
                      detailed: bool = True) -> List[Dict[str, Any]]:
    """Apply the `_tasks` request filters to serialized task dicts."""
    out = []
    patterns = [p.strip() for p in (actions or "").split(",") if p.strip()]
    for t in tasks:
        if patterns and not any(fnmatch.fnmatch(t.get("action", ""), p)
                                for p in patterns):
            continue
        if parent_task_id and t.get("parent_task_id") != parent_task_id:
            continue
        if not detailed:
            t = {k: v for k, v in t.items()
                 if k not in ("description", "profile_stage")}
        out.append(t)
    return out


def build_tasks_response(node_infos: Dict[str, Dict[str, Any]],
                         group_by: str = "nodes") -> Dict[str, Any]:
    """Render the `_tasks` response from per-node task lists.

    ``node_infos``: node_id -> {"name": str, "tasks": [task dicts]}.
    ``group_by``: nodes (default, the per-node map), none (flat map), or
    parents (top-level tasks with nested ``children``).
    """
    out: Dict[str, Any] = {}
    if group_by == "none":
        out["tasks"] = {
            f"{nid}:{t['id']}": t
            for nid, info in node_infos.items()
            for t in info.get("tasks", [])}
        return out
    if group_by == "parents":
        by_id: Dict[str, Dict] = {}
        for nid, info in node_infos.items():
            for t in info.get("tasks", []):
                by_id[f"{nid}:{t['id']}"] = dict(t)
        roots: Dict[str, Dict] = {}
        for tid, t in by_id.items():
            parent = t.get("parent_task_id")
            if parent and parent in by_id:
                by_id[parent].setdefault("children", []).append(t)
            else:
                roots[tid] = t
        for t in by_id.values():
            if "children" in t:
                t["children"].sort(key=lambda c: (c["node"], c["id"]))
        out["tasks"] = roots
        return out
    if group_by != "nodes":
        raise IllegalArgumentException(
            f"unknown group_by [{group_by}], expected one of "
            "[nodes, parents, none]")
    out["nodes"] = {
        nid: {"name": info.get("name", nid),
              "tasks": {f"{nid}:{t['id']}": t
                        for t in info.get("tasks", [])}}
        for nid, info in node_infos.items()}
    return out


def render_cat_tasks(node_infos: Dict[str, Dict[str, Any]]) -> str:
    """`_cat/tasks` lines from the per-node task lists: action, task id,
    parent, type, start time, node."""
    lines = []
    for nid, info in sorted(node_infos.items()):
        name = info.get("name", nid)
        for t in sorted(info.get("tasks", []), key=lambda t: t["id"]):
            lines.append(
                f"{t['action']} {nid}:{t['id']} "
                f"{t.get('parent_task_id', '-')} {t['type']} "
                f"{t['start_time_in_millis']} {name}")
    return "\n".join(lines)


def node_task_slice(task_manager: TaskManager, node_id: str,
                    name: Optional[str] = None,
                    actions: Optional[str] = None,
                    parent_task_id: Optional[str] = None,
                    detailed: bool = True) -> Dict[str, Any]:
    """One node's slice of the `_tasks` shape (``{"name": ...,
    "tasks": [task dicts]}``)."""
    tasks = [t.to_dict(node_id) for t in task_manager.list_tasks()]
    return {"name": name or node_id,
            "tasks": filter_task_dicts(tasks, actions=actions,
                                       parent_task_id=parent_task_id,
                                       detailed=detailed)}


def hot_threads_text(task_manager: TaskManager, node_name: str,
                     node_id: str, limit: int = 3) -> str:
    """One node's `_nodes/hot_threads` section: the top running tasks
    with their running time and current profile stage, in the
    reference's text format (the schedulable unit here is the task, so
    the occupancy report is the task table)."""
    tasks = sorted(task_manager.list_tasks(),
                   key=lambda t: -t.running_time_nanos())
    lines = [f"::: {{{node_name}}}{{{node_id}}}", ""]
    total_ns = sum(t.running_time_nanos() for t in tasks) or 1
    for t in tasks[:limit]:
        ns = t.running_time_nanos()
        pct = 100.0 * ns / total_ns
        stage = t.profile_stage or "-"
        lines.append(
            f"   {pct:.1f}% ({ns / 1e6:.1f}ms out of "
            f"{total_ns / 1e6:.1f}ms) occupancy by task "
            f"'{t.action}' (id {node_id}:{t.id}, stage {stage})")
        if t.description:
            lines.append(f"     {t.description}")
        lines.append("")
    if len(tasks) == 0:
        lines.append("   0.0% occupancy — no running tasks")
        lines.append("")
    return "\n".join(lines)


def parse_bool_param(value: Any, default: bool = False) -> bool:
    """A REST boolean parameter: real bools and the strings
    "true"/"false"; None gives ``default``."""
    if value is None:
        return default
    if isinstance(value, bool):
        return value
    return str(value).strip().lower() == "true"
