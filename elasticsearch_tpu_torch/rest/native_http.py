"""The native HTTP front (counterpart of
elasticsearch_tpu/rest/native_http.py): ctypes bindings for the port's
``native/src/estpu_http.cpp``.

- a C++ epoll thread owns accept/read/parse/write (no GIL);
- hot ``_search`` bodies of the registered index are parsed and tokenized
  in C++, their term ids resolved against the registered dictionary, and
  drained by the fast path (search/fastpath.py) as per-cohort arrays
  through ``es_fast_poll``; their responses are serialized in C++
  (``es_fast_respond``);
- every other request lands on the fallback queue, served by the worker
  threads below through ``RestController.dispatch`` (query parameters,
  JSON bodies, NDJSON for ``_bulk``), and so does every request the fast
  path bounces back (a stale registration, or more blocks than its
  largest bucket).

The library is built from the port's own sources with ``g++`` at first
use into ``_build/<hash>/`` (the hash covers the sources and the flags),
as ops/_build.py builds the CUDA kernels. A failed build raises, and so
does a failed bind: there is no other HTTP server to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional
from urllib.parse import parse_qsl, urlsplit

import numpy as np

logger = logging.getLogger("elasticsearch_tpu_torch.rest.native_http")

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "native" / "src"
SOURCES = ("estpu_http.cpp", "estpu_tokenize.h")
BUILD_ROOT = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}


def build_dir() -> Path:
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def get_lib() -> ctypes.CDLL:
    """The front's library, built if needed and loaded; thread-safe, and
    several processes may build at once (each writes a temporary file
    and renames it). Raises RuntimeError when the build fails."""
    out = build_dir()
    with _lock:
        lib = _libs.get(out)
        if lib is not None:
            return lib
        so = out / "libestpu_http.so"
        if not so.exists():
            out.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [CXX, *CXX_FLAGS, str(SRC_DIR / SOURCES[0]), "-o",
                   str(tmp)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeError(f"native HTTP front build failed: "
                                   f"{' '.join(cmd)}: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"native HTTP front build failed (rc="
                    f"{proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, so)
        lib = _bind(ctypes.CDLL(str(so)))
        _libs[out] = lib
        return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    H = c.c_int64
    i32p = c.POINTER(c.c_int32)
    lib.es_http_start.restype = c.c_int
    lib.es_http_start.argtypes = [c.c_int, c.POINTER(H)]
    lib.es_http_stop.restype = None
    lib.es_http_stop.argtypes = [H]
    lib.es_fast_register.restype = c.c_int
    lib.es_fast_register.argtypes = [
        H, c.c_int32, c.c_char_p, c.c_char_p, c.c_char_p,
        c.POINTER(c.c_int64), c.c_int32, c.c_char_p,
        c.POINTER(c.c_int64), c.c_int32, c.c_int32, c.c_int32]
    lib.es_fast_unregister.restype = None
    lib.es_fast_unregister.argtypes = [H]
    lib.es_fast_poll.restype = c.c_int
    lib.es_fast_poll.argtypes = [
        H, c.POINTER(c.c_uint64), i32p, i32p, i32p, i32p, i32p, i32p,
        c.c_int, c.c_int]
    lib.es_fast_wake.restype = None
    lib.es_fast_wake.argtypes = [H]
    lib.es_fast_pending.restype = c.c_int
    lib.es_fast_pending.argtypes = [H]
    lib.es_fast_respond.restype = c.c_int
    lib.es_fast_respond.argtypes = [
        H, c.c_uint64, c.c_char_p, c.c_void_p, c.c_void_p, c.c_int,
        c.c_longlong, c.c_char_p, c.c_int]
    lib.es_fast_bounce.restype = c.c_int
    lib.es_fast_bounce.argtypes = [H, c.c_uint64]
    lib.es_fallback_next.restype = c.c_int
    lib.es_fallback_next.argtypes = [
        H, c.POINTER(c.c_uint64), c.c_char_p,
        c.POINTER(c.c_char_p), c.POINTER(c.c_int64),
        c.POINTER(c.c_char_p), c.POINTER(c.c_int64),
        c.POINTER(c.c_char_p), c.POINTER(c.c_int64), c.c_int]
    lib.es_respond.restype = c.c_int
    lib.es_respond.argtypes = [H, c.c_uint64, c.c_int, c.c_char_p,
                               c.c_char_p, c.c_int64, c.c_int, c.c_char_p]
    lib.es_http_stats.restype = None
    lib.es_http_stats.argtypes = [H, c.POINTER(c.c_longlong)]
    lib.es_loadgen.restype = c.c_longlong
    lib.es_loadgen.argtypes = [
        c.c_int, c.c_char_p, c.c_char_p, c.POINTER(c.c_int64),
        c.c_int, c.c_int, c.c_longlong, c.c_int,
        c.POINTER(c.c_double), c.POINTER(c.c_double),
        c.POINTER(c.c_longlong)]
    return lib


def string_blob(strings):
    """(bytes, int64 offsets [n + 1]) of UTF-8 strings laid end to end."""
    enc = [s.encode("utf-8") for s in strings]
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum(np.fromiter(map(len, enc), np.int64, len(enc)), out=offs[1:])
    return b"".join(enc), offs


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class NativeHttpFront:
    """Owns one C++ server (an opaque handle) and the fallback workers.
    The fast path (``FastPathServer.attach_front``) drains its parsed
    requests; ``stop`` stops that drain too, before it frees the
    server."""

    def __init__(self, controller, n_fallback_threads: int = 2):
        self.controller = controller
        self.lib = get_lib()
        self.h: Optional[int] = None
        self.port: Optional[int] = None
        self.n_fallback = n_fallback_threads
        self._threads = []
        self._running = False
        self.fastpath = None
        # (terms, ids, their string_blobs) of the last registration: a
        # new live mask re-registers the same lists under a new generation
        self._blobs = None

    def start(self, port: int) -> int:
        """Bind 127.0.0.1:``port`` (0 picks a free port) and start the
        fallback workers; returns the bound port. Raises OSError when
        the bind fails."""
        h = ctypes.c_int64()
        bound = self.lib.es_http_start(port, ctypes.byref(h))
        if bound < 0:
            raise OSError(f"native HTTP front failed to bind 127.0.0.1:"
                          f"{port}")
        self.h = h.value
        self.port = bound
        self._running = True
        for i in range(self.n_fallback):
            t = threading.Thread(target=self._fallback_loop,
                                 name=f"http-fallback-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        return bound

    def stop(self) -> bool:
        """Stop the fallback workers and the attached fast path; free the
        C++ server only when every thread that may touch it has exited
        (a straggler leaks it instead). True on a clean stop."""
        self._running = False
        clean = True
        if self.fastpath is not None:
            clean = self.fastpath.stop()
            self.fastpath = None
        for t in self._threads:
            t.join(timeout=5.0)
            clean = clean and not t.is_alive()
        self._threads = []
        if self.h is not None:
            if clean:
                self.lib.es_http_stop(self.h)
            else:
                logger.warning("native HTTP front: a thread outlived stop; "
                               "the C++ server is leaked, not freed")
            self.h = None
            self.port = None
        return clean

    # ------------------------------------------------------ fast protocol
    def register(self, gen: int, index: str, field: str, terms, ids,
                 default_k: int, max_k: int):
        """Make ``index``'s ``field`` the fast index in C++ under
        generation ``gen``: its term dictionary (the terms, in term-id
        order) and its external doc ids (in docid order), laid out here
        (once per pair of lists) and copied by C++ before it returns."""
        if (self._blobs is None or self._blobs[0] is not terms
                or self._blobs[1] is not ids):
            self._blobs = (terms, ids, string_blob(terms), string_blob(ids))
        (term_blob, term_offs), (id_blob, id_offs) = self._blobs[2:]
        rc = self.lib.es_fast_register(
            self.h, gen, index.encode(), field.encode(), term_blob,
            _i64p(term_offs), len(term_offs) - 1, id_blob, _i64p(id_offs),
            len(id_offs) - 1, default_k, max_k)
        if rc != 0:
            raise RuntimeError(f"es_fast_register failed for [{index}]")

    def unregister(self):
        self._blobs = None
        self.lib.es_fast_unregister(self.h)

    def poll(self, bufs, timeout_ms: int) -> int:
        """Fill ``bufs`` (search/fastpath.py ``PollBuffers``) with up to
        ``bufs.max_n`` parsed requests,
        waiting at most ``timeout_ms`` (``wake`` ends the wait); returns
        how many."""
        return self.lib.es_fast_poll(self.h, *bufs.args, bufs.max_n,
                                     timeout_ms)

    def wake(self):
        self.lib.es_fast_wake(self.h)

    def respond(self, token: int, index: bytes, docids: np.ndarray,
                scores: np.ndarray, total: int, took_ms: int):
        """Answer a fast request: contiguous int32 docids and float32
        scores (copied before the call returns), the exact total."""
        self.lib.es_fast_respond(
            self.h, token, index, docids.ctypes.data, scores.ctypes.data,
            len(docids), total, b"eq", took_ms)

    def bounce(self, token: int):
        """Send a fast request to the fallback workers."""
        self.lib.es_fast_bounce(self.h, token)

    def respond_error(self, token: int, status: int, payload: dict):
        data = json.dumps(payload).encode()
        self.lib.es_respond(self.h, token, status,
                            b"application/json; charset=UTF-8", data,
                            len(data), 0, b"")

    def stats(self) -> dict:
        buf = (ctypes.c_longlong * 8)()
        self.lib.es_http_stats(self.h, buf)
        return {"requests": buf[0], "fast": buf[1], "fallback": buf[2],
                "open_connections": buf[3], "ip_rejected": buf[4]}

    # ------------------------------------------------------------ fallback
    def _fallback_loop(self):
        c = ctypes
        token = c.c_uint64()
        method = c.create_string_buffer(16)
        path_p, hdr_p, body_p = c.c_char_p(), c.c_char_p(), c.c_char_p()
        path_len, hdr_len, body_len = c.c_int64(), c.c_int64(), c.c_int64()
        while self._running:
            got = self.lib.es_fallback_next(
                self.h, c.byref(token), method, c.byref(path_p),
                c.byref(path_len), c.byref(hdr_p), c.byref(hdr_len),
                c.byref(body_p), c.byref(body_len), 200)
            if not got:
                continue
            tok = token.value
            try:
                self._serve_one(tok, method.value.decode("latin-1"),
                                c.string_at(path_p, path_len.value),
                                c.string_at(hdr_p, hdr_len.value),
                                c.string_at(body_p, body_len.value))
            except Exception as e:  # the boundary: report, keep serving
                logger.exception("native HTTP fallback request failed")
                self.respond_error(tok, 500, {"error": {
                    "type": "exception", "reason": f"{type(e).__name__}: "
                                                   f"{e}"}, "status": 500})

    def _serve_one(self, token: int, method: str, raw_path: bytes,
                   raw_headers: bytes, raw_body: bytes):
        """One request: its query parameters and its body (NDJSON text
        for ``_bulk`` or an x-ndjson content type, else JSON; a body that
        does not parse is a 400) through ``RestController.dispatch``."""
        url = urlsplit(raw_path.decode("utf-8", "replace"))
        params = dict(parse_qsl(url.query))
        content_type = ""
        for line in raw_headers.decode("latin-1").split("\r\n"):
            name, sep, val = line.partition(":")
            if sep and name.strip().lower() == "content-type":
                content_type = val.strip().lower()
        body = None
        if raw_body:
            if "x-ndjson" in content_type or url.path.rstrip("/").endswith(
                    "_bulk"):
                body = raw_body.decode("utf-8")
            else:
                try:
                    body = json.loads(raw_body)
                except json.JSONDecodeError as e:
                    self._send(token, 400, {"error": {
                        "type": "parsing_exception",
                        "reason": f"Failed to parse request body: {e}"},
                        "status": 400}, method)
                    return
        status, payload = self.controller.dispatch(method, url.path, params,
                                                   body)
        self._send(token, status, payload, method)

    def _send(self, token: int, status: int, payload, method: str):
        data = json.dumps(payload).encode()
        self.lib.es_respond(self.h, token, status,
                            b"application/json; charset=UTF-8", data,
                            len(data), 1 if method == "HEAD" else 0, b"")


def loadgen(port: int, path: str, bodies, n_conns: int, total: int,
            timeout_s: float = 600.0) -> dict:
    """Drive ``total`` POSTs of the JSON ``bodies`` at
    127.0.0.1:``port``/``path`` from ``n_conns`` keep-alive connections
    with the front's C++ load generator (``es_loadgen``, off the GIL):
    connection c sends bodies c, c + n_conns, ... round-robin, so how
    often each body goes out depends on which connections answer
    first.
    Returns the requests done, the responses outside 2xx, the wall
    seconds and the per-request latencies (seconds, in completion
    order)."""
    lib = get_lib()
    blob, offs = string_blob(json.dumps(b) for b in bodies)
    lat = np.zeros(total, np.float64)
    wall = ctypes.c_double()
    non2xx = ctypes.c_longlong()
    done = lib.es_loadgen(
        port, path.encode(), blob, _i64p(offs), len(offs) - 1, n_conns,
        total, int(timeout_s * 1000),
        lat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(wall), ctypes.byref(non2xx))
    return {"done": int(done), "non2xx": int(non2xx.value),
            "wall_s": wall.value, "lat_s": lat[:min(done, total)] / 1e6}
