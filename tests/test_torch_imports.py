"""The port stands alone: importing every module of elasticsearch_tpu_torch
loads neither ``jax`` nor any module of the reference package, no source
file of the port (nor chip_smoke.py) imports them, no source of the port
names the reference's native directory, its HTTP front maps the library
built from its own sources (never the reference's libestpu_http.so), and
without CUDA an entry point that is not told ``device="cpu"`` raises."""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "elasticsearch_tpu_torch"


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "elasticsearch_tpu"
            or name.startswith("elasticsearch_tpu."))


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import elasticsearch_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'elasticsearch_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps({'modules': names, 'loaded': sorted(sys.modules)}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "elasticsearch_tpu_torch.search.fastpath" in res["modules"]
    assert "elasticsearch_tpu_torch.ops._build" in res["modules"]
    assert ("elasticsearch_tpu_torch.rest.native_http"
            in res["modules"])
    for name in ("common.errors", "script.painless", "script.interp",
                 "search.script", "common.settings", "utils.breaker",
                 "search.profile", "telemetry.context",
                 "telemetry.flightrecorder", "telemetry.engine"):
        assert f"elasticsearch_tpu_torch.{name}" in res["modules"]
    assert [m for m in res["loaded"] if _forbidden(m)] == []


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_imports_jax_or_the_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f) if _forbidden(name)]
    assert bad == []


def test_no_source_names_the_reference_native_dir():
    """The port's front is built from its own sources only: no Python,
    C++ or header file of the port points into the reference package's
    native directory (its sources or its prebuilt libraries)."""
    files = [f for f in sorted(PKG.rglob("*"))
             if f.suffix in (".py", ".cpp", ".h", ".cu", ".cuh")]
    assert {f.suffix for f in files} >= {".py", ".cpp", ".h", ".cu"}
    bad = [str(f.relative_to(ROOT)) for f in files
           if "elasticsearch_tpu/native" in f.read_text()
           or "elasticsearch_tpu.native" in f.read_text()]
    assert bad == []


def test_front_loads_the_ports_own_library():
    """A port node serving through its native front maps the library
    built under elasticsearch_tpu_torch/_build/ and never the reference's
    libestpu_http.so (checked in a fresh process)."""
    code = (
        "import json\n"
        "from elasticsearch_tpu_torch.node import Node\n"
        "from elasticsearch_tpu_torch.rest import native_http\n"
        "node = Node(device='cpu')\n"
        "node.start(0)\n"
        "maps = open('/proc/self/maps').read()\n"
        "node.close()\n"
        "print(json.dumps({'maps': [l.split()[-1] for l in "
        "maps.splitlines() if 'estpu' in l], "
        "'build': str(native_http.build_dir())}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    libs = set(res["maps"])
    assert libs == {str(pathlib.Path(res["build"]) / "libestpu_http.so")}
    assert str(PKG / "_build") in res["build"]
    assert not any("elasticsearch_tpu/native" in m for m in libs)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_cuda_raise(no_cuda):
    from elasticsearch_tpu_torch.device import resolve_device
    from elasticsearch_tpu_torch.index.segment import segment_from_numpy
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops.device import DeviceSegment
    from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
    from elasticsearch_tpu_torch.search.fastpath import FastPathServer
    seg = segment_from_numpy(dict(
        terms=["a"], doc_freq=[1], term_block_start=[0], term_block_count=[1],
        block_docids=np.zeros((1, 128), np.int32),
        block_tfs=np.eye(1, 128, dtype=np.float32),
        field_lengths=np.ones(1, np.float32)))
    for make in (resolve_device, Node, DeviceSegmentCache,
                 lambda: FastPathServer(None, DeviceSegmentCache("cpu")),
                 lambda: DeviceSegment(seg), lambda: resolve_device("cuda:0")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert resolve_device("cpu").type == "cpu"
    assert DeviceSegment(seg, "cpu").live.device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No card: exit non-zero and print no result, in the repository and
    alone in a directory without the package."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert out.stdout.strip() == ""
