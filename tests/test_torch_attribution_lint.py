"""The attribution lint of the port (its analogue of the reference's
ESTPU-JIT01 and JIT03 rules): every public function of
``elasticsearch_tpu_torch/ops/`` that launches device work is a
``tracked_kernel`` (telemetry/engine.py) and has a ``KERNEL_ATTRIBUTION``
row (search/profile.py) naming a real profile stage; what is left is
host code or a device building block that only tracked entry points
call, which no module outside ops/ may call. A function added to ops/
must be put in one of the three, so a launch cannot go untracked."""

import ast
import importlib
import pathlib

import pytest

from elasticsearch_tpu_torch.search import profile

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "elasticsearch_tpu_torch"
OPS = PKG / "ops"
# the mesh's own tracked programs (parallel/mesh_executor.py)
PARALLEL = PKG / "parallel"

# public ops functions that launch nothing: host numpy and arithmetic
HOST = {"pow2_buckets", "idf", "scan_run_bound", "bm25_reference_scores",
        "tensor_bytes", "round_up", "block_bucket", "host_any_mask",
        "check_packed_id_limit", "unpack_ids", "unpack_result",
        "build_term_impacts", "select_blocks_impact",
        "select_blocks_prefix", "impact_safe_termination", "host_norms",
        "exact_rerank_scores", "matmul_route"}
# device work that runs only inside tracked entry points (or, for
# prepare_vectors, inside a DeviceSegment's build)
INNER = {"bm25_contrib", "doubling_scan", "gather_bm25_contrib_plain",
         "merge_sorted_slots_plain", "plan_topk_body", "pack_result",
         "prepare_vectors"}
# the device -> host funnel, which records each readback on its own
FUNNEL = {"readback"}


def _ops_functions(where=OPS, public_only=True):
    """{(module, name): tracked kernel name or None} of the public
    module-level functions of the public ops modules (of ``where``;
    with ``public_only`` False its private functions too)."""
    out = {}
    for f in sorted(where.glob("*.py")):
        if f.name.startswith("_"):
            continue
        tree = ast.parse(f.read_text(), str(f))
        for node in tree.body:
            if not isinstance(node, ast.FunctionDef) or (
                    public_only and node.name.startswith("_")):
                continue
            name = None
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call) and \
                        getattr(dec.func, "id", None) == "tracked_kernel":
                    name = dec.args[0].value
            out[(f.stem, node.name)] = name
    return out


def test_every_ops_function_is_tracked_host_or_inner():
    funcs = _ops_functions()
    assert len(funcs) > 40
    unclassified = [f"{m}.{n}" for (m, n), k in funcs.items()
                    if k is None and n not in HOST | INNER | FUNNEL]
    assert unclassified == []
    tracked = [(m, n) for (m, n), k in funcs.items() if k is not None]
    assert not {n for _m, n in tracked} & (HOST | INNER | FUNNEL)


def test_host_functions_launch_nothing():
    """A HOST function's body names no ``torch`` (annotations aside)."""
    for f in sorted(OPS.glob("*.py")):
        tree = ast.parse(f.read_text(), str(f))
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and node.name in HOST:
                body = ast.Module(body=node.body, type_ignores=[])
                names = {n.id for n in ast.walk(body)
                         if isinstance(n, ast.Name)}
                if node.name == "matmul_route":
                    continue        # reads the slab's dtype and device
                assert "torch" not in names, f"{f.stem}.{node.name}"


def test_tracked_kernels_have_attribution_rows_and_real_stages():
    funcs = _ops_functions()
    mesh = {(f"parallel.{m}", n): k for (m, n), k in
            _ops_functions(PARALLEL, public_only=False).items()}
    names = [k for k in list(funcs.values()) + list(mesh.values())
             if k is not None]
    assert len(names) == len(set(names)), "a kernel name is tracked twice"
    assert set(names) == set(profile.KERNEL_ATTRIBUTION)
    for name, stage in profile.KERNEL_ATTRIBUTION.items():
        assert stage.split(".", 1)[0] in (profile.DEVICE_STAGES
                                          + profile.HOST_STAGES
                                          + ("aggs",)), name
    for (mod, fn), kname in funcs.items():
        if kname is None:
            continue
        obj = getattr(importlib.import_module(
            f"elasticsearch_tpu_torch.ops.{mod}"), fn)
        assert obj.kernel_name == kname


def _ops_references(path: pathlib.Path):
    """(ops module, function) pairs that ``path`` names: through
    ``from ...ops.<m> import f`` and through ``alias.f`` of a module
    imported from ops."""
    tree = ast.parse(path.read_text(), str(path))
    aliases = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            if node.module.startswith("elasticsearch_tpu_torch.ops."):
                mod = node.module.rsplit(".", 1)[1]
                for a in node.names:
                    yield mod, a.name
            elif node.module == "elasticsearch_tpu_torch.ops":
                for a in node.names:
                    aliases[a.asname or a.name] = a.name
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in aliases:
            yield aliases[node.value.id], node.attr


@pytest.mark.parametrize("where", ["package", "chip_smoke"])
def test_no_inner_building_block_is_called_from_outside_ops(where):
    files = ([f for f in sorted(PKG.rglob("*.py"))
              if OPS not in f.parents] if where == "package"
             else [ROOT / "chip_smoke.py"])
    funcs = _ops_functions()
    seen = set()
    for f in files:
        for mod, name in _ops_references(f):
            if (mod, name) in funcs:
                seen.add((mod, name))
    assert seen, "no ops entry point found"
    inner = sorted(f"{m}.{n}" for m, n in seen if n in INNER)
    if where == "chip_smoke":
        # chip_smoke holds each kernel against its plain twin
        inner = [n for n in inner if not n.endswith("_plain")]
    assert inner == []
