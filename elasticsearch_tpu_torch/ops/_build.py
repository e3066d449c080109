"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library with
a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). All sources compile in parallel, one ``nvcc`` each,
at first use, into ``_build/<hash>/``, where the hash covers the sources
and the flags: an edited source builds anew, an unchanged one loads the
library already built. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"

# --fmad=false: no multiply-add contraction, so the kernels' float
# arithmetic rounds at the same places as their PyTorch twins
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# sources compiled and libraries loaded by this process
_counts = {"builds": 0, "loads": 0}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "elasticsearch_tpu_torch build only where the CUDA "
                       "toolkit is installed")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library; returns
    ``{source stem: CDLL}``. Thread-safe; later calls are free."""
    with _lock:
        if _libs:
            return _libs
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        todo = [(src, out / f"lib{src.stem}.so") for src in _sources()]
        pending = [(src, so) for src, so in todo if not so.exists()]
        if pending:
            nvcc = _nvcc()
            t0 = time.time()
            procs = []
            for src, so in pending:
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                log = open(out / f"{src.stem}.log", "w")
                procs.append((src, so, tmp, log, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=log, stderr=subprocess.STDOUT)))
            failed = []
            for src, so, tmp, log, proc in procs:
                rc = proc.wait()
                log.close()
                if rc == 0:
                    os.replace(tmp, so)
                else:
                    failed.append(f"{src.name} (rc={rc}): "
                                  + (out / f"{src.stem}.log").read_text())
            if failed:
                raise RuntimeError("CUDA kernel build failed:\n"
                                   + "\n".join(failed))
            (out / "build_seconds").write_text(f"{time.time() - t0:.3f}\n")
            _counts["builds"] += len(pending)
        for src, so in todo:
            _libs[src.stem] = ctypes.CDLL(str(so))
        _counts["loads"] += len(todo)
        return _libs


def stats() -> Dict[str, object]:
    """The build directory of the current sources, and the sources this
    process compiled (``builds``) and the libraries it loaded
    (``loads``): a load without a build found the libraries built."""
    with _lock:
        return {"path": str(build_dir()), **_counts}


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    return build_all()[name]


def build_log() -> str:
    """The compiler output (``-Xptxas -v``: registers, shared memory,
    spills per kernel) of the current build, one section per source."""
    out = build_dir()
    parts = []
    for src in _sources():
        log = out / f"{src.stem}.log"
        if log.exists():
            parts.append(f"== {src.name}\n{log.read_text().strip()}")
    return "\n".join(parts)
