"""Engine-level device observability: the launch tracker (counterpart of
elasticsearch_tpu/telemetry/engine.py).

``tracked_kernel`` wraps the ops/ entry points, the twin of the
reference's ``tracked_jit``. It derives a **shape key** from each call
(a tensor or array argument by shape and dtype, a static argument by its
value, a short sequence element-wise, a longer one by its length: a
Python list of term ids is never walked) and records into the
process-global ``TRACKER``:

- every call, under its kernel name and shape key;
- the first call of each key, timed on the host and classified
  ``"compile"``. PyTorch compiles nothing per shape, so that time is the
  host's first enqueue plus, for a hand-written CUDA kernel, its lazy
  build or load (ops/_build.py). The stream is not synchronized to take
  it.

Each tracked call also records one launch event in the ambient flight
recorder (telemetry/flightrecorder.py) with the batcher's cohort
annotation, notes its kernel name in an active ``profile: true``
recorder (search/profile.py). Calls nest (the v2m lane's batch launches the contribution
kernel and the merge): every level is recorded, since on the card each
is a launch of its own.

Surfaces: ``GET /_kernels`` (per kernel: calls, shapes seen, first-call
ms and the last new key's trigger), the ``engine.compile`` block of
``GET /_nodes/stats``. The table is process-global, as the kernel builds
it mirrors are (one build serves every node of the process).

Hot-path cost per tracked call: one key tuple over the arguments (its
text is formatted once per key), one lock-guarded dict probe, a TLS read
each for the flight and profile recorders, and the flight recorder's
event when one is ambient (PERF.md §6 has what a call costs on the
host).
"""

from __future__ import annotations

import functools
import inspect
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.search import profile as _profile
from elasticsearch_tpu_torch.telemetry import flightrecorder as _flight

_prof_tls = _profile._tls
_flight_tls = _flight._tls

__all__ = ["CompileTracker", "TRACKER", "tracked_kernel"]

# a sequence argument up to this long keys element by element (the plan
# launch's field streams); a longer one keys by its length alone
_SEQ_WALK = 16


# -- shape keys -------------------------------------------------------------

_SCALARS = (bool, int, float, complex)


def _dyn_desc(value) -> tuple:
    """A dynamic argument's part of the key: a tensor or array by shape
    (a ``torch.Size`` is a tuple) and dtype, a short sequence
    element-wise, a longer one by length, a Python scalar by its type
    only (its value is data, not shape)."""
    if value is None or isinstance(value, _SCALARS):
        return ("scalar", type(value).__name__)
    shape = getattr(value, "shape", None)
    if shape is not None:
        return (shape, value.dtype)
    if isinstance(value, (tuple, list)):
        if len(value) > _SEQ_WALK:
            return ("seq", len(value))
        return ("seq", tuple(_dyn_desc(v) for v in value))
    return (type(value).__name__,)


def _static_desc(value) -> Any:
    """Statics key by value; unhashable statics by identity."""
    try:
        hash(value)
        return value
    except TypeError:
        return f"<{type(value).__name__}#{id(value):x}>"


def _component(pname: str, value, is_static: bool) -> tuple:
    if is_static:
        return (pname, "static", _static_desc(value))
    return (pname,) + _dyn_desc(value)


def _fmt_component(comp: tuple) -> str:
    pname = comp[0]
    if len(comp) >= 2 and comp[1] == "static":
        return f"{pname}={comp[2]!r}"
    if len(comp) == 3 and isinstance(comp[1], tuple):
        dims = "x".join(str(d) for d in comp[1])
        dtype = str(comp[2]).replace("torch.", "")
        return f"{pname}[{dims}]{dtype}"
    if len(comp) == 3 and comp[1] == "scalar":
        return f"{pname}:{comp[2]}"
    if len(comp) == 3 and comp[1] == "seq":
        if isinstance(comp[2], int):
            return f"{pname}:seq{comp[2]}"
        return f"{pname}:seq{len(comp[2])}"
    return f"{pname}:{comp[1]}"


def format_key(key: tuple) -> str:
    """Human-readable shape key for the ``_kernels`` table: tensors,
    sequences and statics (a scalar's value never changes the key)."""
    return " ".join(_fmt_component(c) for c in key
                    if not (len(c) >= 2 and c[1] == "scalar"))


def _diff_trigger(prev: Optional[tuple], key: tuple) -> str:
    """What changed against the kernel's previous new key: the
    last-compile trigger column."""
    if prev is None:
        return "cold"
    changed = []
    for a, b in zip(prev, key):
        if a != b:
            changed.append(f"{_fmt_component(a)} -> {_fmt_component(b)}")
    if len(prev) != len(key):
        changed.append(f"arity {len(prev)} -> {len(key)}")
    return "; ".join(changed) if changed else "new shape"


# -- the tracker ------------------------------------------------------------

class _Kernel:
    __slots__ = ("name", "calls", "compiles", "cum_ms", "shapes",
                 "last_key", "last_ms", "last_trigger")

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.compiles = 0
        self.cum_ms = 0.0
        # key -> [first-call ms (None while the first call is in
        # flight), format_key(key)]
        self.shapes: Dict[tuple, list] = {}
        self.last_key: Optional[tuple] = None
        self.last_ms: Optional[float] = None
        self.last_trigger: Optional[str] = None


class CompileTracker:
    """Thread-safe per-kernel table of calls and first calls per key."""

    MAX_SHAPES_LISTED = 16   # per-kernel cap in to_dict (table stays small)

    def __init__(self):
        self._lock = threading.Lock()
        self._kernels: Dict[str, _Kernel] = {}
        # node registries (telemetry/metrics.py) that receive
        # ``engine.compile.count`` / ``engine.compile.ms``; weak, so a
        # closed node drops out on its own
        self._sinks: "weakref.WeakSet" = weakref.WeakSet()

    def add_sink(self, metrics) -> None:
        self._sinks.add(metrics)

    # -- record path (called by tracked_kernel wrappers) -------------------

    def on_call(self, kernel: str, key: tuple) -> Tuple[bool, str]:
        """Count a call: (True when ``key`` is new for ``kernel``, and the
        caller then times the call and reports on_compile; the key's
        ``format_key`` text, formatted once per key)."""
        with self._lock:
            k = self._kernels.get(kernel)
            if k is None:
                k = self._kernels[kernel] = _Kernel(kernel)
            k.calls += 1
            seen = k.shapes.get(key)
            if seen is not None:
                return False, seen[1]
            # reserve: concurrent racers record once
            text = format_key(key)
            k.shapes[key] = [None, text]
            return True, text

    def on_error(self, kernel: str, key: tuple) -> None:
        """A first call for a reserved key raised: un-reserve it, so a
        later successful call is timed and counted."""
        with self._lock:
            k = self._kernels.get(kernel)
            seen = k.shapes.get(key) if k is not None else None
            if seen is not None and seen[0] is None:
                del k.shapes[key]

    def on_compile(self, kernel: str, key: tuple, ms: float) -> str:
        """Record the first call of a key; returns its classification
        (``"compile"``) for the per-request profile."""
        with self._lock:
            k = self._kernels[kernel]
            trigger = _diff_trigger(k.last_key, key)
            k.shapes[key][0] = ms
            k.compiles += 1
            k.cum_ms += ms
            k.last_key, k.last_ms, k.last_trigger = key, ms, trigger
            sinks = list(self._sinks)
        for m in sinks:
            m.inc("engine.compile.count")
            m.inc("engine.compile.ms", ms)
        return "compile"

    # -- read path ---------------------------------------------------------

    def totals(self) -> Dict[str, Any]:
        """The ``engine.compile`` rollup for ``_nodes/stats``."""
        with self._lock:
            kernels = list(self._kernels.values())
            return {
                "count": sum(k.compiles for k in kernels),
                "ms": round(sum(k.cum_ms for k in kernels), 3),
                "calls": sum(k.calls for k in kernels),
                "kernels": len(kernels),
            }

    def calls(self, kernel: str) -> int:
        """The calls of ``kernel`` so far (0 before its first)."""
        with self._lock:
            k = self._kernels.get(kernel)
            return k.calls if k is not None else 0

    def total_compiles(self) -> int:
        with self._lock:
            return sum(k.compiles for k in self._kernels.values())

    def to_dict(self) -> Dict[str, Any]:
        """The ``GET /_kernels`` table: per kernel, calls, shapes seen,
        first calls and their summed ms, and the last new key's
        trigger."""
        with self._lock:
            out: Dict[str, Any] = {}
            for name in sorted(self._kernels):
                k = self._kernels[name]
                shapes = [
                    {"key": text,
                     "ms": round(ms, 3) if ms is not None else None}
                    for ms, text in list(k.shapes.values())
                    [-self.MAX_SHAPES_LISTED:]]
                out[name] = {
                    "calls": k.calls,
                    "compiles": k.compiles,
                    "shapes_seen": len(k.shapes),
                    "cum_ms": round(k.cum_ms, 3),
                    "last_compile": {
                        "key": (format_key(k.last_key)
                                if k.last_key is not None else None),
                        "ms": (round(k.last_ms, 3)
                               if k.last_ms is not None else None),
                        "trigger": k.last_trigger,
                    },
                    "shapes": shapes,
                }
            return out

    @staticmethod
    def persistent_stats() -> Dict[str, Any]:
        """The ``persistent_cache`` block of ``GET /_kernels``: the
        hand-written kernels' build directory (ops/_build.py) with the
        builds and loads this process made. PyTorch keeps no compiled
        program per shape, so there is no other cache to report."""
        from elasticsearch_tpu_torch.ops import _build
        return _build.stats()


# THE tracker: process-global, like the kernel builds it mirrors.
TRACKER = CompileTracker()


# -- the decorator ----------------------------------------------------------

def tracked_kernel(name: str, *, static_argnames: Tuple[str, ...] = ()):
    """Record every call of an ops/ entry point under ``name``::

        @tracked_kernel("masked_topk", static_argnames=("k",))
        def masked_topk(scores, mask, k): ...

    The wrapper keys the call (``static_argnames`` by value, the rest
    by shape), counts it in ``TRACKER``, times a key's first call, and
    records the call in the ambient flight recorder and profile
    recorder. ``TRACKER.calls(name)`` has the calls; a hand-written
    kernel's launches are counted where it launches (its ``launches``)."""
    statics = frozenset(static_argnames)

    def deco(fn):
        params: List[str] = list(inspect.signature(fn).parameters)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            parts = [_component(p, a, p in statics)
                     for p, a in zip(params, args)]
            if kwargs:
                parts += [_component(p, kwargs[p], p in statics)
                          for p in sorted(kwargs)]
            key = tuple(parts)
            fr = getattr(_flight_tls, "rec", None)
            first, text = TRACKER.on_call(name, key)
            t0 = time.perf_counter() if first else 0.0
            tfr = fr.clock() if fr is not None else 0.0
            try:
                out = fn(*args, **kwargs)
            except BaseException:
                if first:
                    TRACKER.on_error(name, key)
                raise
            kind, ms = "cached", 0.0
            if first:
                ms = (time.perf_counter() - t0) * 1000.0
                kind = TRACKER.on_compile(name, key, ms)
            if fr is not None:
                # a first call's time is the tracker's story: it would
                # poison the regime EMA
                info = getattr(_flight_tls, "launch_info", None) or {}
                fr.record_launch(
                    name, text,
                    dispatch_ns=0 if first else int(
                        (fr.clock() - tfr) * 1e9),
                    **info)
            if getattr(_prof_tls, "rec", None) is not None:
                _profile.note_kernel(name, kind, ms)
            return out

        wrapper.kernel_name = name
        return wrapper
    return deco
