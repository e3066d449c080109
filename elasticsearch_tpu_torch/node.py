"""A single port node (counterpart of elasticsearch_tpu/node.py): the
indices, the REST routes of the `_search` slices, the HTTP front, the
device-resident segments, and the two serving paths on one device: the
fast path (its v2m, v1 and θ-warm essential lanes) and the plan path
with its PlanBatcher.

    node = Node(device=None)              # CUDA unless device="cpu"
    port = node.start(0)                  # returns the bound port
    ...
    node.close()

``start`` serves through the C++ front (rest/native_http.py, built with
``g++`` at first use), which parses the hot ``_search`` bodies of the
index the node registers with it (``refresh_front``) in C++ and hands
them to the fast path as arrays; every other request reaches
``RestController.dispatch`` through the front's fallback workers.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterable

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.index.mapper import DocumentMapper, TextFieldType
from elasticsearch_tpu_torch.rest.api import RestController
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.fastpath import FastPathServer
from elasticsearch_tpu_torch.search.service import SearchService

VERSION = "8.0.0-torch-slice6"


@dataclass
class IndexService:
    name: str
    mapper: DocumentMapper
    engine: Engine
    k1: float = 1.2
    b: float = 0.75


class Node:
    """Keeps its indices in memory: this slice has no translog and writes
    no segment files."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.indices: Dict[str, IndexService] = {}
        self._indices_lock = threading.Lock()
        # one device copy of each segment, shared by both paths
        self.device_cache = DeviceSegmentCache(self.device)
        self.fastpath = FastPathServer(self.device, self.device_cache)
        self.search_service = SearchService(self.device_cache)
        self.rest_controller = RestController(self)
        self._http = None     # the NativeHttpFront, once started
        self._fastpath_started = False

    def info(self) -> Dict[str, Any]:
        return {"name": "node-0", "cluster_name": "elasticsearch",
                "version": {"number": VERSION,
                            "build_flavor": "pytorch-cuda-port",
                            "device": str(self.device)},
                "tagline": "You Know, for Search"}

    def create_index(self, name: str, mappings=None, settings=None):
        settings = settings or {}
        sim = (settings.get("index", settings).get("similarity", {})
               .get("default", {}))
        mapper = DocumentMapper(mappings)
        engine = Engine(mapper, name, on_retire=self._retire)
        svc = IndexService(name, mapper, engine,
                           k1=float(sim.get("k1", 1.2)),
                           b=float(sim.get("b", 0.75)))
        with self._indices_lock:
            if name in self.indices:
                raise ValueError(f"index [{name}] already exists")
            self.indices[name] = svc
        return svc

    def _retire(self, names: Iterable[str]):
        """Segments a merge or an install retired: no registration of the
        fast path and no device copy may keep them."""
        names = list(names)
        self.fastpath.retire(names)
        self.device_cache.evict(names)

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
        front = NativeHttpFront(self.rest_controller)
        bound = front.start(port)
        try:
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
        indices with one segment and exactly one text field in it, the
        one with the most documents (the first on a tie); none when
        there is none. The fast path's drain calls it about once a
        second and before each batch the front hands over."""
        best = None
        for name, svc in list(self.indices.items()):
            segs = svc.engine.segments
            if len(segs) != 1:
                continue
            text = [f for f in segs[0].postings
                    if isinstance(svc.mapper.field_type(f), TextFieldType)]
            if len(text) != 1:
                continue
            if best is None or segs[0].n_docs > best[1].n_docs:
                best = (svc, segs[0], text[0])
        if best is None:
            self.fastpath.unregister_front()
            return
        svc, seg, field = best
        self.fastpath.register_front(svc.name, seg, field, svc.k1, svc.b)

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
        http, self._http = self._http, None
        if http is not None:
            http.stop()         # the front stops the fast path too
        with self._indices_lock:
            if self._fastpath_started:
                self.fastpath.stop()
                self._fastpath_started = False
