"""Named thread pools with EWMA execution tracking (the port's copy of
elasticsearch_tpu/common/threadpool.py, Elasticsearch's ThreadPool).

Each pool is a fixed number of worker threads over a bounded queue: a
task submitted to a full queue is rejected with
``EsRejectedExecutionException`` (a retryable 429) and counted in
``rejected``. A pool keeps its active workers, completed tasks and an
EWMA of a task's execution time (alpha 0.3), which ``_nodes/stats``
(``thread_pool``) and ``_cat/thread_pool`` render.

The node's pools (``ThreadPool``), sized from the processor count as
the reference's are:

- ``search`` (``3 * p // 2 + 1`` threads, queue 1000): `_msearch`'s
  bodies;
- ``search_throttled`` (1 thread, queue 100): searches that target only
  frozen indices, one at a time, so rehydrating a frozen index's device
  state never starves the hot searches;
- ``write`` (p, 10000), ``get`` (p, 1000), ``management`` (p / 2, 100)
  and ``snapshot`` (p / 2, 1000).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional

from elasticsearch_tpu_torch.common.errors import \
    EsRejectedExecutionException


class TaskTrackingPool:
    """One named pool: fixed workers, a bounded queue, EWMA tracking."""

    def __init__(self, name: str, size: int, queue_size: int = 1000):
        self.name = name
        self.size = size
        self.queue_size = queue_size
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue(queue_size)
        self._threads = []
        self._shutdown = False
        self.active = 0
        self.completed = 0
        self.rejected = 0
        self.ewma_ms = 0.0           # task execution time EWMA (alpha .3)
        self._lock = threading.Lock()
        for i in range(size):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"estpu[{name}][{i}]")
            t.start()
            self._threads.append(t)

    # ----------------------------------------------------------- execution
    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, kwargs, done = item
            with self._lock:
                self.active += 1
            t0 = time.monotonic()
            try:
                result, error = fn(*args, **kwargs), None
            except BaseException as e:   # delivered to ``done``
                result, error = None, e
            dt_ms = (time.monotonic() - t0) * 1000.0
            with self._lock:
                self.active -= 1
                self.completed += 1
                self.ewma_ms = (dt_ms if self.completed == 1
                                else 0.7 * self.ewma_ms + 0.3 * dt_ms)
            if done is not None:
                done(result, error)

    def execute(self, fn: Callable, *args,
                done: Optional[Callable] = None, **kwargs) -> None:
        """Queue ``fn(*args, **kwargs)``; ``done(result, error)`` hears
        its outcome on the worker. A full queue (or a pool shut down)
        rejects it with EsRejectedExecutionException."""
        if self._shutdown:
            raise EsRejectedExecutionException(
                f"pool [{self.name}] is shut down")
        try:
            self._q.put_nowait((fn, args, kwargs, done))
        except queue.Full:
            with self._lock:
                self.rejected += 1
            raise EsRejectedExecutionException(
                f"rejected execution on [{self.name}]: queue capacity "
                f"{self.queue_size} reached")

    def submit(self, fn: Callable, *args, **kwargs):
        """``execute`` with a future: its ``result(timeout)`` waits for
        the task and returns its value or raises its exception."""
        ev = threading.Event()
        box: Dict[str, Any] = {}

        def done(result, error):
            box["r"], box["e"] = result, error
            ev.set()

        self.execute(fn, *args, done=done, **kwargs)

        class _Future:
            def result(self_, timeout: Optional[float] = None):
                if not ev.wait(timeout):
                    raise TimeoutError(f"task on [{self.name}] timed out")
                if box["e"] is not None:
                    raise box["e"]
                return box["r"]

        return _Future()

    # ---------------------------------------------------------------- info
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"threads": self.size, "queue": self._q.qsize(),
                    "active": self.active, "completed": self.completed,
                    "rejected": self.rejected,
                    "ewma_task_ms": round(self.ewma_ms, 3)}

    def shutdown(self) -> None:
        """Refuse new tasks; each worker ends after the tasks queued
        before (``join`` waits for them)."""
        self._shutdown = True
        for _ in self._threads:
            try:
                self._q.put_nowait(None)
            except queue.Full:
                pass

    def join(self, timeout: Optional[float] = None) -> None:
        for t in self._threads:
            t.join(timeout)


class ThreadPool:
    """The node's named pools, sized from ``processors`` (the CPU count
    by default) as Elasticsearch sizes them."""

    def __init__(self, processors: Optional[int] = None):
        p = processors or os.cpu_count() or 4
        half = max(1, p // 2)
        self.pools: Dict[str, TaskTrackingPool] = {
            "search": TaskTrackingPool("search", 3 * p // 2 + 1, 1000),
            "search_throttled": TaskTrackingPool("search_throttled", 1,
                                                 100),
            "write": TaskTrackingPool("write", p, 10000),
            "get": TaskTrackingPool("get", p, 1000),
            "management": TaskTrackingPool("management", half, 100),
            "snapshot": TaskTrackingPool("snapshot", half, 1000),
        }

    def executor(self, name: str) -> TaskTrackingPool:
        return self.pools[name]

    def stats(self) -> Dict[str, Any]:
        return {name: pool.stats() for name, pool in self.pools.items()}

    def shutdown(self, timeout: Optional[float] = None) -> None:
        """Shut every pool down; with ``timeout``, wait up to that long
        for each worker to end."""
        for pool in self.pools.values():
            pool.shutdown()
        if timeout is not None:
            for pool in self.pools.values():
                pool.join(timeout)
