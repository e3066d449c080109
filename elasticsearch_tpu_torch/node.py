"""A single port node (counterpart of elasticsearch_tpu/node.py): the
indices, the REST routes of the `_search` BM25 slice, the stdlib HTTP
server and the v2m serving lane on one device.

    node = Node(device=None)              # CUDA unless device="cpu"
    port = node.start(0)                  # returns the bound port
    ...
    node.close()
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.rest.api import RestController
from elasticsearch_tpu_torch.rest.http_server import HttpServer
from elasticsearch_tpu_torch.search.fastpath import FastPathServer

VERSION = "8.0.0-torch-slice1"


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
        self.fastpath = FastPathServer(self.device)
        self.rest_controller = RestController(self)
        self._http: Optional[HttpServer] = None
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
        svc = IndexService(name, mapper, Engine(mapper),
                           k1=float(sim.get("k1", 1.2)),
                           b=float(sim.get("b", 0.75)))
        with self._indices_lock:
            if name in self.indices:
                raise ValueError(f"index [{name}] already exists")
            self.indices[name] = svc
        return svc

    def serving_lane(self) -> FastPathServer:
        """The v2m lane, started on first use (dispatch works without
        ``start``)."""
        with self._indices_lock:
            if not self._fastpath_started:
                self.fastpath.start()
                self._fastpath_started = True
        return self.fastpath

    def start(self, port: int = 9200, host: str = "127.0.0.1") -> int:
        """Start the serving lane and the HTTP server; returns the bound
        port (``port=0`` picks a free one)."""
        self.serving_lane()
        self._http = HttpServer(self.rest_controller, host, port)
        self._http.start()
        return self._http.port

    def close(self):
        if self._http is not None:
            self._http.stop()
            self._http = None
        with self._indices_lock:
            if self._fastpath_started:
                self.fastpath.stop()
                self._fastpath_started = False
