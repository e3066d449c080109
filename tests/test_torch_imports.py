"""The port stands alone: importing every module of elasticsearch_tpu_torch
loads neither ``jax`` nor any module of the reference package, no source
file of the port (nor chip_smoke.py) imports them, and without CUDA an
entry point that is not told ``device="cpu"`` raises."""

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


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_cuda_raise(no_cuda):
    from elasticsearch_tpu_torch.device import resolve_device
    from elasticsearch_tpu_torch.index.segment import segment_from_numpy
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops.device import DeviceSegment
    from elasticsearch_tpu_torch.search.fastpath import FastPathServer
    seg = segment_from_numpy(dict(
        terms=["a"], doc_freq=[1], term_block_start=[0], term_block_count=[1],
        block_docids=np.zeros((1, 128), np.int32),
        block_tfs=np.eye(1, 128, dtype=np.float32),
        field_lengths=np.ones(1, np.float32)))
    for make in (resolve_device, Node, FastPathServer,
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
