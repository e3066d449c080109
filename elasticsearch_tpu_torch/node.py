"""A single port node (counterpart of elasticsearch_tpu/node.py): the
indices (index/service.py: each of 1 to 1024 shards), the REST routes of
the `_search` slices, the HTTP front, the device-resident segments, and
the two serving paths on one device: the fast path (its v2m, v1 and
θ-warm essential lanes, for an index of one shard) and the search
service's per-shard loop over the plan path with its PlanBatcher and
the dense executor.

    node = Node(device=None)              # CUDA unless device="cpu"
    node = Node(settings={"indices.breaker.hbm.limit": "40gb"})
    node = Node(device="cpu", devices=["cpu"] * 8)   # the mesh's grid
    node = Node(data_path="/var/lib/estpu")          # durable indices
    port = node.start(0)                  # returns the bound port
    ...
    node.close()

``data_path`` (else the ``path.data`` setting) is where the node keeps
its indices (index/service.py): each index's ``_meta.json``, and a
directory a shard with its segments, commit point and translog
(index/engine.py). A node opened on a path reopens every index found
there (a data path of the reference's too) and replays the translogs,
so every acknowledged write survives a restart: ``close`` one node and
open another on the same path. With neither given, the node keeps its
indices in a temporary directory of its own and removes it at
``close``. ``indexing_pressure.memory.limit`` (64mb by default) bounds
the in-flight ``_bulk`` bytes (index/pressure.py): past it a bulk
answers a retryable 429.

``settings`` (flat dotted keys, nested objects, or both) sets the
circuit breakers: ``indices.breaker.{total,request,fielddata,
in_flight_requests,hbm}.limit`` (utils/breaker.py
``build_breaker_service``). The ``hbm`` child accounts the device memory
of the resident segments (search/context.py ``DeviceSegmentCache``); its
default is the reference's, the host total of 4 GiB, which a deployment
holding more on the card must raise. The ``request`` child is charged by
the dense path's host readbacks (search/searcher.py).

``telemetry`` (telemetry/__init__.py) is the node's metrics registry,
tracer (``telemetry.traces.max`` traces of at most
``telemetry.traces.max_spans`` spans), history ring
(``telemetry.history.interval`` / ``.retention`` seconds), flight
recorder (``flight``) and tenant and workload-class accounting
(``tenants.max``, ``workload.max`` and their SLO settings). The breakers,
the indexing pressure, the task manager, the batchers and the mesh feed
it. The flight recorder is ambient on every thread that serves: each
REST dispatch (the HTTP front's fallback workers included, and the
batchers' leaders inside them) and the fast path's drain thread.
``http.ip_filter.allow`` / ``.deny`` (comma lists of IPv4 CIDRs) filter
the connections the front accepts.

``devices`` is the node's device list, the grid of the mesh
(parallel/): every visible CUDA card by default, the one device on the
CPU. An index of N shards runs on the mesh when the list holds at least
N devices, else through the per-shard loop; with two or more devices
the plan cohorts and the fast path's v1 cohorts also split their rows
over the list. The mesh's copies on a card other than ``device`` are
charged to the same ``hbm`` breaker as the node's own.

``start`` serves through the C++ front (rest/native_http.py, built with
``g++`` at first use), which parses the hot ``_search`` bodies of the
index the node registers with it (``refresh_front``) in C++ and hands
them to the fast path as arrays; every other request reaches
``RestController.dispatch`` through the front's fallback workers.

The node's metadata (index/metadata.py ``MetadataService``: aliases,
templates, data streams; ``_metadata.json``) and stored scripts
(search/script.py ``StoredScripts``; ``_scripts.json``) live under the
data path beside the indices. ``close_index`` and ``open_index`` set
``index.state``: a closed index keeps its files, and its segments leave
the device and the front. ``_msearch`` runs its sub-searches on
``search_pool``, Elasticsearch's search pool: ``3 * cores // 2 + 1``
threads (at most 32) and a queue of 1000, past which a sub-search
answers its own 429.

Tasks (transport/tasks.py): ``task_manager`` registers every `_search`,
`_count`, scroll page, `_msearch` (a parent and a child a body), async
search and reindex-family job the REST routes run; ``task_results``
keeps the results of background jobs (``wait_for_completion=false``)
and persists each in the ``.tasks`` index under the data path, so
``GET /_tasks/{id}`` resolves it after a restart (the task numbering
then starts past the stored ones). ``async_search_service`` runs
``_async_search`` (search/async_search.py). Background work runs on
daemon threads started by ``spawn``; ``close`` cancels every running
task and async search and joins those threads before it closes the
indices.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, Optional

from elasticsearch_tpu_torch.common.errors import (
    CircuitBreakingException, EsRejectedExecutionException)
from elasticsearch_tpu_torch.common.settings import flat_settings
from elasticsearch_tpu_torch.device import (DeviceLike, resolve_device,
                                            resolve_devices)
from elasticsearch_tpu_torch.utils.breaker import (CircuitBreaker,
                                                   build_breaker_service)
from elasticsearch_tpu_torch.index.mapper import TextFieldType
from elasticsearch_tpu_torch.index.metadata import MetadataService
from elasticsearch_tpu_torch.index.pressure import IndexingPressure
from elasticsearch_tpu_torch.index.service import IndicesService
from elasticsearch_tpu_torch.rest.api import RestController
from elasticsearch_tpu_torch.rest.api import error_answer
from elasticsearch_tpu_torch.search.async_search import AsyncSearchService
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.fastpath import FastPathServer
from elasticsearch_tpu_torch.search.script import StoredScripts
from elasticsearch_tpu_torch.search.service import SearchService
from elasticsearch_tpu_torch.telemetry import Telemetry
from elasticsearch_tpu_torch.telemetry import context as _telectx
from elasticsearch_tpu_torch.utils.bigarrays import BigArrays
from elasticsearch_tpu_torch.transport.tasks import (CancellableTask,
                                                     TaskManager,
                                                     TaskResultStore)

VERSION = "8.0.0-torch-slice23"
# the search pool's queue (Elasticsearch's thread_pool.search.queue_size)
SEARCH_QUEUE_SIZE = 1000
# the system index of background tasks' results (the reference's)
TASKS_INDEX = ".tasks"
TASKS_MAPPINGS = {"properties": {"completed": {"type": "boolean"},
                                 "task_id": {"type": "keyword"},
                                 "task_num": {"type": "long"}}}
# how long ``close`` waits for each background thread after the cancel
CLOSE_JOIN_S = 30.0


class Node:
    def __init__(self, device: DeviceLike = None,
                 settings: Optional[Dict[str, Any]] = None, devices=None,
                 data_path: Optional[str] = None):
        self.device = resolve_device(device)
        # the device list the mesh lays shards over (device.py
        # ``resolve_devices``): every visible card on CUDA, else the one
        # device, unless the caller gives it (the CPU tests: ["cpu"] * 8)
        self.devices = resolve_devices(devices, self.device)
        self.node_id = "node-0"
        self.settings: Dict[str, Any] = flat_settings(settings)
        self.breaker_service = build_breaker_service(self.settings.get)
        self.indexing_pressure = IndexingPressure.from_settings(
            self.settings.get)
        # the node's telemetry (telemetry/__init__.py): metrics, the
        # bounded trace ring, the history ring, the flight recorder and
        # the tenant and workload-class accounting, on one clock
        get = self.settings.get
        self.telemetry = Telemetry(
            node=self.node_id,
            max_traces=int(get("telemetry.traces.max", 128)),
            max_spans_per_trace=int(get("telemetry.traces.max_spans", 512)),
            history_interval=float(get("telemetry.history.interval",
                                       10.0)),
            history_retention=float(get("telemetry.history.retention",
                                        600.0)),
            settings_get=get)
        self.flight = self.telemetry.flight
        # breaker trips and indexing-pressure rejections feed the
        # registry and the ambient tenant's (and class's) rows
        self.breaker_service.metrics = self.telemetry.metrics
        self.breaker_service.tenants = self.telemetry.tenants
        self.indexing_pressure.metrics = self.telemetry.metrics
        self.indexing_pressure.tenants = self.telemetry.tenants
        self.indexing_pressure.workloads = self.telemetry.workload
        data_path = data_path or self.settings.get("path.data")
        # a node given no path keeps its indices in a directory of its own
        self._own_data_path = data_path is None
        self.data_path = (tempfile.mkdtemp(prefix="estpu-node-")
                          if data_path is None else str(data_path))
        self.indices = IndicesService(self.data_path,
                                      on_retire=self._retire)
        self._indices_lock = threading.Lock()
        self.metadata_service = MetadataService(self.indices, self.data_path)
        self.stored_scripts = StoredScripts(self.data_path)
        # one device copy of each segment, shared by both paths
        self.device_cache = DeviceSegmentCache(self.device)
        self.device_cache.set_breaker(
            self.breaker_service.get_breaker(CircuitBreaker.HBM))
        # the dense path's host readbacks charge the request breaker
        self.device_cache.bigarrays = BigArrays(self.breaker_service)
        self.search_service = SearchService(self.device_cache, self.indices,
                                            self.devices,
                                            self.stored_scripts)
        svc = self.search_service
        svc.telemetry = self.telemetry
        # each batcher entry charges one cohort slot to its tenant and
        # class; the mesh's dispatches and fallbacks feed the registry
        for batcher in (svc.plan_batcher, svc.knn_batcher):
            batcher.tenants = self.telemetry.tenants
            batcher.workloads = self.telemetry.workload
        svc.mesh_executor.metrics = self.telemetry.metrics
        self.search_pool = ThreadPoolExecutor(
            max_workers=min(32, 3 * (os.cpu_count() or 1) // 2 + 1),
            thread_name_prefix="search")
        self._search_queue = threading.BoundedSemaphore(SEARCH_QUEUE_SIZE)
        # v1 cohorts split their rows over the device list (below two
        # devices a registration binds no replica mesh)
        self.fastpath = FastPathServer(
            self.device, self.device_cache, flight=self.flight,
            mesh_backend=self.search_service.mesh_executor)
        self.rest_controller = RestController(self)
        # every index under the data path, recovered
        self.indices.open_all()
        # tasks: the live registry (its numbering past the results the
        # .tasks index already holds), the background jobs' results, and
        # the daemon threads of background work (``spawn``)
        self.task_manager = TaskManager(self.node_id,
                                        self._stored_task_max(),
                                        metrics=self.telemetry.metrics)
        self.task_results = TaskResultStore(256, self._persist_task_result)
        self._threads: list = []
        self._threads_lock = threading.Lock()
        self._closing = False
        self.async_search_service = AsyncSearchService(
            self.rest_controller.async_search_fn, self.task_manager,
            spawn=self.spawn, error_of=error_answer)
        self._http = None     # the NativeHttpFront, once started
        self._fastpath_started = False
        # the segment the front's registration could not admit (it alone
        # passes the hbm limit): not tried again until it changes
        self._front_refused = None

    def info(self) -> Dict[str, Any]:
        return {"name": self.node_id, "cluster_name": "elasticsearch",
                "version": {"number": VERSION,
                            "build_flavor": "pytorch-cuda-port",
                            "device": str(self.device)},
                "tagline": "You Know, for Search"}

    def create_index(self, name: str, mappings=None, settings=None):
        """An index of ``index.number_of_shards`` shards (dotted or
        nested under ``index``; 1 by default, 1 to 1024, final), as the
        reference reads it: a value that does not parse or lies out of
        bounds is a SettingsException (400). A bare ``number_of_shards``
        outside ``index`` is not that setting and leaves one shard, as
        in the reference. ``index.similarity.default.{k1,b}`` set the
        BM25 similarity. No template applies (``PUT /{index}`` and a
        first write apply them: index/metadata.py)."""
        with self._indices_lock:
            return self.indices.create_index(name, settings, mappings)

    def create_index_from_template(self, name: str, body=None):
        """``PUT /{index}`` and a write's auto-create: the matching index
        template, then ``body`` on top (index/metadata.py)."""
        with self._indices_lock:
            return self.metadata_service.create_index_from_template(name,
                                                                    body)

    def delete_index(self, name: str) -> None:
        """Remove the index and its files; its segments leave the device
        and the fast path, and its aliases and data streams forget it."""
        with self._indices_lock:
            self.indices.delete_index(name)

    def close_index(self, name: str) -> None:
        """Close an index (``index.state: close``, persisted): its device
        copies and fast-path registrations go, and the front serves it
        no more."""
        svc = self.indices.require(name)
        svc.update_settings({"index.state": "close"})
        names = svc.segment_names()
        self.fastpath.retire(names)
        self.device_cache.evict(names)
        self.search_service.mesh_executor.evict(names)
        if self._http is not None:
            self.refresh_front()

    def open_index(self, name: str) -> None:
        """Open a closed index again; a started node registers it with
        the front again when it is the one to serve."""
        self.indices.require(name).update_settings({"index.state": "open"})
        if self._http is not None:
            self.refresh_front()

    def submit_search(self, fn, *args):
        """``fn(*args)`` on the search pool: its future, or an
        EsRejectedExecutionException (a 429) when the queue is full."""
        if not self._search_queue.acquire(blocking=False):
            raise EsRejectedExecutionException(
                "rejected execution of a search: the search queue is full")

        def run():
            try:
                return fn(*args)
            finally:
                self._search_queue.release()
        # the caller's ambient contexts (trace, client id, tenant, class,
        # recorders) go with the work onto the pool's thread
        return self.search_pool.submit(_telectx.bind(run))

    def spawn(self, name: str, fn) -> threading.Thread:
        """Run ``fn`` on a daemon thread of the node's, which ``close``
        joins; a closing node refuses (a 429)."""
        with self._threads_lock:
            if self._closing:
                raise EsRejectedExecutionException(
                    f"rejected execution of [{name}]: the node is closing")
            self._threads = [t for t in self._threads if t.is_alive()]
            t = threading.Thread(target=fn, name=name, daemon=True)
            self._threads.append(t)
            t.start()
        return t

    def background_threads(self) -> int:
        """The background threads still running."""
        with self._threads_lock:
            return sum(t.is_alive() for t in self._threads)

    def _stored_task_max(self) -> int:
        """The largest task number the .tasks index holds (0: none), so
        a restarted node numbers its tasks past the stored results."""
        svc = self.indices.get(TASKS_INDEX)
        if svc is None:
            return 0
        nums = [int(str(i).rpartition(":")[2]) for shard in svc.shards
                for seg in shard.segments for i in seg.stored.ids
                if str(i).rpartition(":")[2].isdigit()]
        return max(nums, default=0)

    def _persist_task_result(self, task_id: int, result) -> None:
        """A background task's result into the .tasks index, flushed
        (the reference's TaskResultsService): it survives a restart."""
        with self._indices_lock:
            svc = self.indices.get(TASKS_INDEX)
            if svc is None:
                svc = self.indices.create_index(TASKS_INDEX, None,
                                                TASKS_MAPPINGS)
        key = f"{self.node_id}:{task_id}"
        svc.index_doc(key, {"completed": True, "task_id": key,
                            "task_num": int(task_id), "response": result})
        svc.flush()

    def stored_task_result(self, task_num: int):
        """The stored result of this node's task ``task_num`` in the
        .tasks index, or None. The node's id survives a restart, so the
        document id resolves a bare task number too (the reference,
        whose node ids change, searches ``task_num`` for it)."""
        svc = self.indices.get(TASKS_INDEX)
        if svc is None or svc.is_closed:
            return None
        got = svc.get_doc(f"{self.node_id}:{task_num}")
        return got.source.get("response") if got.found else None

    def _retire(self, names: Iterable[str]):
        """Segments a merge or an install retired: no registration of the
        fast path and no device copy may keep them."""
        names = list(names)
        self.fastpath.retire(names)
        self.device_cache.evict(names)
        self.search_service.mesh_executor.evict(names)

    @property
    def fastpath_running(self) -> bool:
        return self._fastpath_started

    def serving_lane(self) -> FastPathServer:
        """The fast path, started on first use (dispatch works without
        ``start``)."""
        with self._indices_lock:
            if not self._fastpath_started:
                self.fastpath.start()
                self._fastpath_started = True
        return self.fastpath

    def start(self, port: int = 9200) -> int:
        """Start the serving lane and the C++ HTTP front on
        127.0.0.1:``port`` (0 picks a free port); returns the bound port.
        The front is built at first use; the node registers its
        eligible index with the fast path (``refresh_front``) and starts
        the drain. A failed build or bind raises."""
        from elasticsearch_tpu_torch.rest.native_http import NativeHttpFront
        allow = str(self.settings.get("http.ip_filter.allow", "") or "")
        deny = str(self.settings.get("http.ip_filter.deny", "") or "")
        front = NativeHttpFront(self.rest_controller)
        bound = front.start(port)
        try:
            if allow or deny:
                front.set_ipfilter(allow, deny)
            self.fastpath.attach_front(front, self.refresh_front)
            self.refresh_front()
            self.serving_lane()
        except BaseException:
            front.stop()
            raise
        self._http = front
        return bound

    def refresh_front(self) -> None:
        """Point the C++ front at the index it should serve fast: of the
        open indices without a read block, of one shard with one segment
        and exactly one text field in it, that field indexing and
        searching with the builtin standard analyzer, the one with the most
        documents (the first on a tie); none when there is none, or when
        that segment alone passes the hbm limit. An index of several
        shards is never registered (the reference registers
        ``len(idx.shards) == 1`` only): the search service serves it.
        The fast path's drain calls it about once a second and before
        each batch the front hands over."""
        best = None
        for name, svc in list(self.indices.items()):
            if svc.num_shards != 1 or svc.is_closed or svc.read_blocked:
                continue
            segs = svc.engine.segments
            if len(segs) != 1:
                continue
            text = [f for f in segs[0].postings
                    if isinstance(svc.mapper.field_type(f), TextFieldType)]
            # the C++ tokenizer mirrors the builtin standard analyzer
            # only: a field of another analyzer (a redefined standard or
            # default included) is served by the plan path (the
            # reference checks the search analyzer's name only)
            if len(text) != 1 or not svc.mapper.standard_analyzed(
                    svc.mapper.field_type(text[0])):
                continue
            if best is None or segs[0].n_docs > best[1].n_docs:
                best = (svc, segs[0], text[0])
        if best is None:
            self.fastpath.unregister_front()
            return
        svc, seg, field = best
        if seg is self._front_refused:
            return
        try:
            self.fastpath.register_front(svc.name, seg, field, svc.k1, svc.b)
        except CircuitBreakingException:
            # the fallback workers serve the index, and answer its 429
            self._front_refused = seg
            self.fastpath.unregister_front()

    def http_stats(self) -> Dict[str, int]:
        """The C++ front's counters (requests, fast, fallback, open
        connections, ip_rejected), the fast path's bounces (``bounced``,
        of which ``bounced_stale`` were parsed under a registration the
        front no longer held) and its C++ registrations. Needs
        ``start``."""
        if self._http is None:
            raise RuntimeError("http_stats needs a started node")
        stats = self._http.stats()
        for key in ("bounced", "bounced_stale", "front_registrations"):
            stats[key] = self.fastpath.stats[key]
        return stats

    def close(self):
        """Cancel every running task and async search and join the
        background threads, stop serving and close every engine (their
        translogs); a node that made its own data directory removes
        it."""
        with self._threads_lock:
            self._closing = True
            threads = list(self._threads)
        self.async_search_service.close()
        for task in self.task_manager.list_tasks():
            if isinstance(task, CancellableTask):
                self.task_manager.cancel(task, "node closed")
        for t in threads:
            t.join(CLOSE_JOIN_S)
        http, self._http = self._http, None
        if http is not None:
            http.stop()         # the front stops the fast path too
        with self._indices_lock:
            if self._fastpath_started:
                self.fastpath.stop()
                self._fastpath_started = False
            self.indices.close()
        self.search_pool.shutdown(wait=False, cancel_futures=True)
        if self._own_data_path:
            shutil.rmtree(self.data_path, ignore_errors=True)
