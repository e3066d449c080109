"""Async search: submit, poll, cancel (the port's copy of
elasticsearch_tpu/search/async_search.py ``AsyncSearchService``).

ref: x-pack/plugin/async-search (AsyncSearchTask.java,
MutableSearchResponse.java): ``POST /{index}/_async_search`` starts the
search on a background thread as a cancellable task
(``indices:data/read/async_search/submit``); ``GET /_async_search/{id}``
polls; answers carry ``is_running`` and ``is_partial``.
``wait_for_completion_timeout`` (default 1s) lets a fast search answer
at once, a slow one answers its id; ``keep_alive`` (default 5d) bounds
how long the entry lives: an expired entry is reaped at the next call,
its search cancelled if it still runs. ``DELETE /_async_search/{id}``
cancels a running search and forgets the entry. A failed search answers
its failure's own status (a cancelled one 400
``task_cancelled_exception``), never a partial 200.

The search runs through ``search_fn(index_expression, body, task)``,
the node's `_search` (rest/api.py: the fast path or the search service,
polling the task between shards and at every device launch), on a
thread started by ``spawn(name, fn)`` (the node's, which ``Node.close``
joins); ``error_of(exc)`` gives a failure's (status, error object).
``close`` cancels every running search. The reference's tenant and
workload stamps wait for the port's telemetry of them.
"""

from __future__ import annotations

import base64
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional, Tuple

from elasticsearch_tpu_torch.common.errors import (ResourceNotFoundException,
                                                   TaskCancelledException)
from elasticsearch_tpu_torch.common.settings import parse_time_value

SUBMIT_ACTION = "indices:data/read/async_search/submit"


class _AsyncSearch:
    def __init__(self, search_id: str, index_expression: str,
                 body: Dict[str, Any], keep_alive: float,
                 clock: Callable[[], float]):
        self.clock = clock
        self.id = search_id
        self.index_expression = index_expression
        self.body = body
        self.start_ms = int(self.clock() * 1000)
        self.expires_at = self.clock() + keep_alive
        self.done = threading.Event()
        self.response: Optional[Dict[str, Any]] = None
        self.error: Optional[Dict[str, Any]] = None
        self.error_status = 500
        self.completed_ms: Optional[int] = None
        self.task = None  # the CancellableTask once started


class AsyncSearchService:
    def __init__(self, search_fn, task_manager,
                 spawn: Callable[[str, Callable[[], None]], Any],
                 error_of: Callable[[BaseException], Tuple[int, Dict]]):
        self.search_fn = search_fn
        self.task_manager = task_manager
        # the wall clock of expiry and the display epochs (a test drives
        # keep-alive reaping by replacing it)
        self.clock = time.time
        self.spawn = spawn
        self.error_of = error_of
        self._searches: Dict[str, _AsyncSearch] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- submit
    def submit(self, index_expression: str, body: Dict[str, Any],
               params: Dict[str, str]) -> Dict[str, Any]:
        wait = parse_time_value(
            params.get("wait_for_completion_timeout", "1s"),
            "wait_for_completion_timeout")
        keep_alive = parse_time_value(params.get("keep_alive", "5d"),
                                      "keep_alive")
        search_id = base64.urlsafe_b64encode(
            uuid.uuid4().bytes).decode().rstrip("=")
        search = _AsyncSearch(search_id, index_expression, body or {},
                              keep_alive, self.clock)
        task = self.task_manager.register(
            "transport", SUBMIT_ACTION,
            description=f"async_search indices[{index_expression}]",
            cancellable=True)
        search.task = task
        with self._lock:
            self._reap_locked()
            self._searches[search_id] = search

        def run():
            try:
                search.response = self.search_fn(index_expression,
                                                 search.body, task)
            except TaskCancelledException:
                search.error = {"type": "task_cancelled_exception",
                                "reason": "async search was cancelled"}
                search.error_status = 400
            except Exception as e:  # the failure's own status and body
                search.error_status, search.error = self.error_of(e)
            finally:
                search.completed_ms = int(self.clock() * 1000)
                self.task_manager.unregister(task)
                search.done.set()

        try:
            self.spawn(f"async_search-{search_id[:8]}", run)
        except BaseException:
            # never started (a closed node): the task goes with it
            self.task_manager.unregister(task)
            with self._lock:
                self._searches.pop(search_id, None)
            raise
        if wait > 0:
            search.done.wait(timeout=wait)
        return self._render(search)

    # ---------------------------------------------------------------- get
    def get(self, search_id: str,
            params: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        params = params or {}
        search = self._lookup(search_id)
        if "keep_alive" in params:
            search.expires_at = self.clock() + parse_time_value(
                params["keep_alive"], "keep_alive")
        if "wait_for_completion_timeout" in params:
            search.done.wait(timeout=parse_time_value(
                params["wait_for_completion_timeout"],
                "wait_for_completion_timeout"))
        return self._render(search)

    def delete(self, search_id: str) -> None:
        search = self._lookup(search_id)
        if search.task is not None and not search.done.is_set():
            self.task_manager.cancel(search.task, "async search deleted")
        with self._lock:
            self._searches.pop(search_id, None)

    def close(self) -> None:
        """Cancel every running search (the node closes)."""
        with self._lock:
            running = [a for a in self._searches.values()
                       if a.task is not None and not a.done.is_set()]
            self._searches.clear()
        for a in running:
            self.task_manager.cancel(a.task, "node closed")

    def _lookup(self, search_id: str) -> _AsyncSearch:
        with self._lock:
            self._reap_locked()
            search = self._searches.get(search_id)
        if search is None:
            raise ResourceNotFoundException(search_id)
        return search

    def _reap_locked(self):
        """The caller holds the lock. Expired entries are removed; any
        whose search still runs is cancelled, so it cannot run on as an
        unaddressable orphan."""
        now = self.clock()
        expired = [a for a in self._searches.values()
                   if a.expires_at < now]
        for a in expired:
            del self._searches[a.id]
        for a in expired:
            if a.task is not None and not a.done.is_set():
                self.task_manager.cancel(a.task, "async search expired")

    # ------------------------------------------------------------- render
    def _render(self, search: _AsyncSearch) -> Dict[str, Any]:
        running = not search.done.is_set()
        out: Dict[str, Any] = {
            "id": search.id,
            "is_partial": running or search.error is not None,
            "is_running": running,
            "start_time_in_millis": search.start_ms,
            "expiration_time_in_millis": int(search.expires_at * 1000),
        }
        if search.error is not None:
            out["error"] = search.error
            # the REST handler answers the stored failure's status
            out["_http_status"] = search.error_status
        elif search.response is not None:
            out["response"] = search.response
            out["completion_time_in_millis"] = (
                search.completed_ms or int(self.clock() * 1000))
        else:
            # still running: the skeleton partial response
            out["response"] = {
                "took": int(self.clock() * 1000) - search.start_ms,
                "timed_out": False,
                "hits": {"total": {"value": 0, "relation": "gte"},
                         "max_score": None, "hits": []},
            }
        return out
