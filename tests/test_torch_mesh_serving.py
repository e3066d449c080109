"""The mesh's serving contract (tests/test_mesh_serving.py's cases, run
against both packages): on the reference's eight virtual jax devices and
the port's grid of ``["cpu"] * 8``, a mesh-served `_search` equals the
per-shard loop it replaces for the pinned bm25 / bool / kNN mix,
deletes included; every refusal falls back to the loop with the same
typed ``fallback.<reason>`` in both packages (the whole matrix, and a
mesh that raises counts ``fallback.error``); a PlanBatcher cohort and a
fast-path v1 cohort split over the replica devices give the unsplit
launch's rows byte for byte; ``GET /_kernels`` carries the ``mesh``
section and ``profile: true`` the ``[index][_mesh]`` entry.

Compares as tests/test_torch_mesh_executor.py: the port's mesh against
its own loop bit for bit, against the reference exact ids, order and
totals with scores rtol 1e-6 (tie-aware rtol 1e-4 where the reference
splits a tie). A kNN body of several shards, pure (``_source: false``, ids
and scores only) or not, meets the mesh merged into its query, whose
loop is the dense executor's KnnQuery a shard in both packages."""

import gc
import logging

import numpy as np
import pytest
import torch

from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.ops import plan as jax_plan
from elasticsearch_tpu.search.batching import PlanBatcher as JaxBatcher
from elasticsearch_tpu.search.batching import _Entry as JaxEntry
from elasticsearch_tpu.search.plan import bind_plan as jax_bind
from elasticsearch_tpu.search.plan import compile_plan as jax_compile
from elasticsearch_tpu.search.queries import parse_query as jax_parse
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import device as port_device
from elasticsearch_tpu_torch.ops import plan as port_plan
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.parallel import mesh_executor
from elasticsearch_tpu_torch.search import fastpath as srv
from elasticsearch_tpu_torch.search.batching import PlanBatcher, _Entry
from elasticsearch_tpu_torch.search.plan import bind_plan, compile_plan
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.telemetry.engine import TRACKER
from elasticsearch_tpu_torch.utils.breaker import CircuitBreaker
from test_torch_mesh_executor import (DIMS, VOCAB, assert_bit_equal,
                                      assert_parity, bulk, counter, do,
                                      hits_of, mesh, port_loop, search,
                                      searched, seed)
# the module-scoped pair of nodes (a fixture: pytest finds it by name)
from test_torch_mesh_executor import nodes  # noqa: F401


def pinned_mix(rng):
    """The acceptance mix: bm25 match, bool (+filter, +msm), kNN."""
    return [
        {"query": {"match": {"title": "amber dune"}}, "size": 50},
        {"query": {"match": {"title": {"query": "cedar fjord mesa",
                                       "operator": "and"}}}, "size": 50},
        {"query": {"bool": {
            "must": [{"match": {"title": "granite"}}],
            "filter": [{"term": {"tag": "x"}}]}}, "size": 50},
        {"query": {"bool": {
            "should": [{"match": {"title": "krill"}},
                       {"match": {"title": "lagoon harbor"}}],
            "minimum_should_match": 1}}, "size": 50},
        {"knn": {"field": "vec",
                 "query_vector": rng.standard_normal(DIMS).tolist(),
                 "k": 20, "num_candidates": 64}, "size": 20},
    ]


def check_mesh(nodes, index, body):
    """The port's mesh answer: it engaged the mesh as the reference's
    did, equals the port's loop bit for bit and the reference's
    answer."""
    jax_node, node = nodes
    got, engaged = searched(node, index, body)
    _, ref_engaged = searched(jax_node, index, body)
    assert engaged == ref_engaged == 1, body
    assert_bit_equal(got, port_loop(node, index, body))
    assert_parity(got, jax_node, index, body)
    return got


# ---------------------------------------------------------------- parity


def test_pinned_mix_byte_identical(nodes):
    rng = seed(nodes, "p8", n_shards=8, vec=True)
    for body in pinned_mix(rng):
        got = check_mesh(nodes, "p8", body)
        assert got["hits"]["hits"], body


@pytest.mark.chaos(seed=17)
def test_chaos_seeded_parity_with_deletes(nodes, chaos_seed):
    """A seeded corpus, query mix and deletes (the live masks refresh
    alone on the resident corpus): every body equals the loop, and no
    deleted doc comes back."""
    rng = seed(nodes, "cx", n_shards=4, n_docs=90, seed_=chaos_seed,
               vec=True)
    victims = [str(int(v)) for v in rng.choice(90, size=12, replace=False)]
    lines = "".join('{"delete": {"_id": "%s"}}\n' % v for v in victims)
    for n in nodes:
        r = do(n, "POST", "/cx/_bulk", {"refresh": "true"}, lines)
        assert not r["errors"]
    queries = []
    for _ in range(6):
        w = [str(x) for x in rng.choice(VOCAB, rng.integers(1, 4))]
        queries.append({"query": {"match": {"title": " ".join(w)}},
                        "size": 30})
        queries.append({"query": {"bool": {
            "should": [{"match": {"title": t}} for t in w],
            "minimum_should_match": 1,
            "filter": [{"term": {"tag": str(rng.choice(["x", "y"]))}}],
        }}, "size": 30})
    queries.append({"knn": {
        "field": "vec", "query_vector": rng.standard_normal(DIMS).tolist(),
        "k": 15, "num_candidates": 40}, "size": 15})
    for body in queries:
        got = check_mesh(nodes, "cx", body)
        for h in got["hits"]["hits"]:
            assert h["_id"] not in victims, body


def test_per_shard_idf_semantics(nodes):
    """The mesh scores each shard with its own statistics, as the
    default loop does; dfs_query_then_fetch takes the loop
    (``fallback.dfs_stats``) in both packages."""
    jax_node, node = nodes
    seed(nodes, "idf8", n_shards=8, n_docs=100, seed_=7)
    body = {"query": {"match": {"title": "amber"}}, "size": 40}
    check_mesh(nodes, "idf8", body)
    params = {"search_type": "dfs_query_then_fetch"}
    for n in nodes:
        fb = counter(n, "fallback.dfs_stats")
        r, engaged = searched(n, "idf8", body, params)
        assert engaged == 0
        assert counter(n, "fallback.dfs_stats") == fb + 1
        assert r["hits"]["hits"]


def test_pure_knn_answers_alike_on_any_device_count(nodes, monkeypatch):
    """A pure kNN body (ids and scores only) on several shards takes the
    cohort launch in neither package: it meets the mesh on eight devices
    and the per-shard loop on one, each shard's KnnQuery cutting to k
    before it drops the deleted docs, so with deletes both answer the
    reference's ids, order and total (less than k a shard). The same
    body asking for ``_source`` answers alike."""
    jax_node, node = nodes
    rng = seed(nodes, "kdel", n_shards=4, n_docs=90, seed_=31, vec=True)
    victims = [str(int(v)) for v in rng.choice(90, size=12, replace=False)]
    lines = "".join('{"delete": {"_id": "%s"}}\n' % v for v in victims)
    for n in nodes:
        r = do(n, "POST", "/kdel/_bulk", {"refresh": "true"}, lines)
        assert not r["errors"]
    pure = {"knn": {"field": "vec",
                    "query_vector": rng.standard_normal(DIMS).tolist(),
                    "k": 15, "num_candidates": 40},
            "_source": False, "size": 15}
    many = check_mesh(nodes, "kdel", pure)
    monkeypatch.setattr(type(mesh(node)), "available_devices",
                        staticmethod(lambda: 1))
    one, engaged = searched(node, "kdel", pure)
    monkeypatch.undo()
    assert engaged == 0
    assert_bit_equal(many, one)
    assert_parity(one, jax_node, "kdel", pure)
    live = [sum(1 for d in shard.segments[0].live if d)
            for shard in node.indices["kdel"].shards]
    assert many["hits"]["total"]["value"] < sum(min(15, n) for n in live)
    assert not {h["_id"] for h in many["hits"]["hits"]} & set(victims)
    full = {k: v for k, v in pure.items() if k != "_source"}
    got = check_mesh(nodes, "kdel", full)
    assert hits_of(got) == hits_of(many)
    assert got["hits"]["total"] == many["hits"]["total"]


def test_mesh_copies_on_other_devices_are_charged():
    """A grid whose devices are not the node's (``cpu:0`` against
    ``cpu``, as a second card would be) makes the mesh keep its own copy
    of each shard there: the answer is still the loop's bit for bit, the
    copies are charged to the node's ``hbm`` breaker and shown in
    ``mesh.residency``, a merge's retired segments leave with their
    charge, and ``clear`` gives every byte back. A replicated array's
    copies are charged too and leave when the source is freed."""
    node = Node(device="cpu", devices=["cpu:0"] * 4)
    try:
        br = node.breaker_service.get_breaker(CircuitBreaker.HBM)
        be = mesh(node)

        def mesh_bytes():
            return sum(sum(c.values()) for c in be.residency().values())

        def agrees():
            node.device_cache.wait_evictions_heard(5.0)
            assert br.used == (node.device_cache.hbm_stats()["total_bytes"]
                               + mesh_bytes()
                               + be.stats()["replica_corpus_bytes"])
        seed([node], "oc", n_shards=4, n_docs=120, seed_=5)
        body = {"query": {"match": {"title": "amber dune"}}, "size": 50}
        got, engaged = searched(node, "oc", body)
        assert engaged == 1
        assert_bit_equal(got, port_loop(node, "oc", body))
        res = be.residency()
        assert list(res) == ["cpu:0"] and res["cpu:0"]["postings"] > 0
        agrees()
        old = {seg.name for shard in node.indices["oc"].shards
               for seg in shard.segments}
        bulk([node], "oc", [{"title": "amber basalt", "tag": "x"}] * 8,
             [f"n{i}" for i in range(8)])
        do(node, "POST", "/oc/_forcemerge")
        got, engaged = searched(node, "oc", body)
        assert engaged == 1
        assert_bit_equal(got, port_loop(node, "oc", body))
        held = set(be._owned[torch.device("cpu:0")]._cache)
        assert held and not held & old
        agrees()
        be.clear()
        assert be.residency() == {}
        agrees()
        rmesh = be.replica_mesh_for(4)
        src = torch.arange(1000, dtype=torch.int32)
        used = br.used
        copies = be.replicated(rmesh, src)
        assert len(copies) == 4 and all(torch.equal(c, src) for c in copies)
        assert br.used == used + 4 * src.nbytes
        assert be.stats()["replica_corpus_bytes"] == 4 * src.nbytes
        assert be.replicated(rmesh, src)[0] is copies[0]
        del src, copies
        gc.collect()
        assert br.used == used
        assert be.stats()["replica_corpus_bytes"] == 0
    finally:
        node.close()


# -------------------------------------------------------------- fallback


def test_fallback_one_device(nodes, monkeypatch):
    """One visible device: the mesh declines (one H100's case) and the
    loop answers."""
    seed(nodes, "one8", n_shards=4, n_docs=50, seed_=3)
    body = {"query": {"match": {"title": "amber"}}, "size": 20}
    for n in nodes:
        monkeypatch.setattr(type(mesh(n)), "available_devices",
                            staticmethod(lambda: 1))
        fb = counter(n, "fallback.not_enough_devices")
        r, engaged = searched(n, "one8", body)
        assert engaged == 0
        assert counter(n, "fallback.not_enough_devices") == fb + 1
        assert r["hits"]["total"]["value"] > 0
    assert_parity(search(nodes[1], "one8", body), nodes[0], "one8", body)


def test_fallback_disabled_env(nodes, monkeypatch):
    seed(nodes, "off8", n_shards=4, n_docs=40, seed_=3)
    monkeypatch.setenv("ESTPU_MESH_SERVING", "0")
    body = {"query": {"match": {"title": "amber"}}, "size": 20}
    for n in nodes:
        fb = counter(n, "fallback.disabled")
        r = search(n, "off8", body)
        assert counter(n, "fallback.disabled") == fb + 1
        assert r["hits"]["total"]["value"] > 0


def test_fallback_knn_over_packed_ceiling(nodes, monkeypatch):
    rng = seed(nodes, "kovf", n_shards=4, n_docs=60, seed_=3, vec=True)
    for mod in (jax_plan, port_plan):
        monkeypatch.setattr(mod, "PACKED_ID_LIMIT", 1)
        monkeypatch.setattr(mod, "check_packed_id_limit",
                            lambda nd, where: None)
    monkeypatch.setattr(port_device, "check_packed_id_limit",
                        lambda nd, where: None)
    body = {"knn": {"field": "vec",
                    "query_vector": rng.standard_normal(DIMS).tolist(),
                    "k": 10, "num_candidates": 32}, "size": 10}
    for n in nodes:
        fb = counter(n, "fallback.packed_id_ceiling")
        r, engaged = searched(n, "kovf", body)
        assert engaged == 0
        assert counter(n, "fallback.packed_id_ceiling") == fb + 1
        assert r["hits"]["hits"]


def test_fallback_knn_with_filter(nodes):
    """A filtered kNN is not mesh-resident: the loop answers it, with
    the filter applied."""
    jax_node, node = nodes
    rng = seed(nodes, "kf", n_shards=4, n_docs=60, seed_=3, vec=True)
    body = {"knn": {"field": "vec",
                    "query_vector": rng.standard_normal(DIMS).tolist(),
                    "k": 10, "num_candidates": 32,
                    "filter": {"term": {"tag": "x"}}},
            "_source": False, "size": 10}
    for n in nodes:
        fb = counter(n, "fallback.knn_filter")
        r, engaged = searched(n, "kf", body)
        assert engaged == 0
        assert counter(n, "fallback.knn_filter") == fb + 1
        assert r["hits"]["hits"]
    assert_parity(search(node, "kf", body), jax_node, "kf", body)


def _matrix_case(nodes, reason, monkeypatch):
    """Set up ``reason``'s case on both nodes: (index, body, params)."""
    rng = np.random.default_rng(23)
    qv = rng.standard_normal(DIMS).tolist()
    knn = {"knn": {"field": "vec", "query_vector": qv, "k": 5,
                   "num_candidates": 16}, "size": 5}
    match = {"query": {"match": {"title": "amber"}}, "size": 10}
    if reason == "disabled":
        seed(nodes, "fm_off", 2, n_docs=30)
        monkeypatch.setenv("ESTPU_MESH_SERVING", "0")
        return "fm_off", match, None
    if reason == "size_zero":
        seed(nodes, "fm_zero", 2, n_docs=30)
        return "fm_zero", {**match, "size": 0}, None
    if reason == "empty_shard":
        # 3 docs over 8 shards: a shard without a segment
        seed(nodes, "fm_empty", 8, n_docs=3)
        return "fm_empty", match, None
    if reason == "dfs_stats":
        seed(nodes, "fm_dfs", 2, n_docs=30)
        return "fm_dfs", match, {"search_type": "dfs_query_then_fetch"}
    if reason == "multi_segment":
        seed(nodes, "fm_seg", 2, n_docs=30, forcemerge=False)
        bulk(nodes, "fm_seg", [{"title": "amber cedar"}], ["x1"])
        return "fm_seg", match, None
    if reason == "plan_incompatible":
        seed(nodes, "fm_plan", 2, n_docs=30)
        return "fm_plan", {"query": {"range": {"views": {"gte": 10}}},
                           "size": 10}, None
    if reason == "knn_multi_segment":
        seed(nodes, "fm_kseg", 2, n_docs=30, vec=True, forcemerge=False)
        bulk(nodes, "fm_kseg", [{"title": "amber", "vec": qv}], ["x1"])
        return "fm_kseg", knn, None
    if reason == "knn_nonuniform_padding":
        seed(nodes, "fm_kpad", 2, n_docs=30, vec=True)
        # over 1024 more docs routed to one shard: its padded size grows
        vecs = rng.standard_normal((1100, DIMS)).round(4).tolist()
        for n in nodes:
            lines = "".join(
                '{"index": {"_id": "r%d", "routing": "a"}}\n' % i
                + '{"title": "amber", "vec": %s}\n' % v
                for i, v in enumerate(vecs))
            r = do(n, "POST", "/fm_kpad/_bulk", {"refresh": "true"}, lines)
            assert not r["errors"]
            do(n, "POST", "/fm_kpad/_forcemerge")
        return "fm_kpad", knn, None
    if reason == "knn_missing_field":
        seed(nodes, "fm_kmiss", 2, n_docs=30, vec=True)
        return "fm_kmiss", {**knn, "knn": {**knn["knn"], "field": "nope"}}, \
            None
    raise AssertionError(reason)


MATRIX = ["disabled", "size_zero", "empty_shard", "dfs_stats",
          "multi_segment", "plan_incompatible", "knn_multi_segment",
          "knn_nonuniform_padding", "knn_missing_field"]


@pytest.mark.parametrize("reason", MATRIX)
def test_fallback_matrix_ticks_in_both(nodes, reason, monkeypatch):
    """Each fallback reason the service can reach ticks once in both
    packages for the same body, no mesh search runs, and the loop
    answers as the reference's."""
    jax_node, node = nodes
    index, body, params = _matrix_case(nodes, reason, monkeypatch)
    for n in nodes:
        fb = counter(n, f"fallback.{reason}")
        st, r = n.rest_controller.dispatch(
            "POST", f"/{index}/_search", dict(params or {}),
            {**body, **({"request_cache": False}
                        if isinstance(n, JaxNode) and body.get("size") == 0
                        else {})})
        assert counter(n, f"fallback.{reason}") == fb + 1, (reason, r)
    got = search(node, index, body, params)
    if reason == "knn_missing_field":
        assert got["hits"]["hits"] == []
    elif reason != "dfs_stats":
        # the reference's plan memo ignores the search type (Queue 3)
        assert_parity(got, jax_node, index, body, params)


def test_backend_gates_single_shard_and_ceilings(nodes):
    """The gates the service never reaches (it sends only bodies of
    several shards): ``single_shard``, ``not_enough_devices`` at the
    backend and ``knn_dims`` (the loop answers the dimension 400)."""
    jax_node, node = nodes
    seed(nodes, "bg", n_shards=2, n_docs=30, vec=True)
    be = mesh(node)
    searchers = node.search_service._shard_searchers(node.indices["bg"])
    q = parse_query({"match": {"title": "amber"}})
    fb = counter(node, "fallback.single_shard")
    assert be.execute(searchers[:1], q, 10) is None
    assert counter(node, "fallback.single_shard") == fb + 1
    bad = {"knn": {"field": "vec", "query_vector": [1.0, 2.0], "k": 3},
           "_source": False, "size": 3}
    fb = counter(node, "fallback.knn_dims")
    st, r = node.rest_controller.dispatch("POST", "/bg/_search", {}, bad)
    assert counter(node, "fallback.knn_dims") == fb + 1
    assert st == 400, r
    assert counter(node, "fallback.error") == 0
    small = mesh_executor.MeshSearchBackend(["cpu"])
    assert small.execute(searchers, q, 10) is None
    assert small.counters == {"fallback.not_enough_devices": 1}


def test_a_mesh_that_raises_counts_error_and_the_loop_answers(
        nodes, monkeypatch, caplog):
    """A fault in the mesh counts ``fallback.error`` and logs a
    warning; the loop answers the body (the reference's contract;
    chip_smoke.py fails a run that counts one)."""
    jax_node, node = nodes
    seed(nodes, "err8", n_shards=4, n_docs=60)
    body = {"query": {"match": {"title": "amber dune"}}, "size": 30}
    want = search(node, "err8", body)

    def broken(*a, **kw):
        raise RuntimeError("injected device fault")
    monkeypatch.setattr(port_plan, "plan_topk_mesh", broken)
    fb = counter(node, "fallback.error")
    with caplog.at_level(logging.WARNING,
                         logger="elasticsearch_tpu_torch.search"):
        got, engaged = searched(node, "err8", body)
    assert engaged == 0
    assert counter(node, "fallback.error") == fb + 1
    assert any("mesh serving failed" in rec.getMessage()
               and rec.levelno == logging.WARNING
               for rec in caplog.records)
    assert_bit_equal(got, want)


# ------------------------------------------------- replica-axis cohorts


def test_replica_cohort_byte_identical(nodes):
    """A PlanBatcher cohort split over the replica devices (corpus
    replicated, Q rows split) gives the unsplit launch's packed rows
    byte for byte, counts its dispatches, and answers the reference's
    replica cohort."""
    jax_node, node = nodes
    seed(nodes, "rb", n_shards=1, n_docs=200, seed_=3)
    searcher = node.search_service._shard_searchers(node.indices["rb"])[0]
    ctx = searcher._contexts()[0]
    q = parse_query({"match": {"title": "amber dune"}}).rewrite(searcher)
    bp = bind_plan(compile_plan(q, searcher), ctx)
    k, k1, b = 10, searcher.k1, searcher.b

    solo = PlanBatcher()
    e1 = [_Entry(bp) for _ in range(16)]
    solo._run(e1, ctx, k, k1, b)
    assert solo.mesh_cohorts == 0

    meshed = PlanBatcher()
    meshed.mesh = mesh(node)
    before = counter(node, "dispatch.replica")
    calls = TRACKER.calls("plan_topk_batch")
    e2 = [_Entry(bp) for _ in range(16)]
    meshed._run(e2, ctx, k, k1, b)
    assert meshed.mesh_cohorts == 1
    assert counter(node, "dispatch.replica") == before + 16
    # 16 rows over 8 replica devices: 8 launches of 2 rows
    assert TRACKER.calls("plan_topk_batch") == calls + 8
    assert meshed.stats()["mesh_cohorts"] == 1
    for a, b_ in zip(e1, e2):
        va, ia, ta = a.result
        vb, ib, tb = b_.result
        assert va.tobytes() == vb.tobytes() and np.array_equal(ia, ib)
        assert ta == tb

    jsearcher = jax_node.indices_service.get("rb").shard_searchers()[0]
    jctx = jsearcher._contexts()[0]
    jq = jax_parse({"match": {"title": "amber dune"}}).rewrite(jsearcher)
    jbp = jax_bind(jax_compile(jq, jsearcher), jctx)
    jb = JaxBatcher()
    jb.mesh = jax_node.search_service.mesh_executor
    e3 = [JaxEntry(jbp) for _ in range(16)]
    jb._run(e3, jctx, k, k1, b)
    assert jb.mesh_cohorts == 1
    vr, ir, tr = e3[0].result
    vb, ib, tb = e2[0].result
    assert tb == tr
    np.testing.assert_allclose(vb, vr, rtol=1e-4)
    order = [i for i in np.lexsort((ir, -vr))]
    assert set(ib.tolist()) == set(np.asarray(ir)[order].tolist()) or \
        np.any(np.isclose(vr[1:], vr[:-1], rtol=1e-4))


def test_replica_mesh_sizing(nodes):
    """replica_mesh_for: the largest power of two <= min(cohort,
    devices); None below two devices or for a cohort of one; as the
    reference sizes it."""
    jax_node, node = nodes
    be, jbe = mesh(node), mesh(jax_node)
    assert be.replica_mesh_for(1) is None is jbe.replica_mesh_for(1)
    for rows in (2, 12, 32):
        assert be.replica_mesh_for(rows).devices.size == \
            jbe.replica_mesh_for(rows).devices.size
    assert be.replica_mesh_for(2).devices.size == 2
    assert be.replica_mesh_for(32).devices.size == 8
    assert be.replica_mesh_for(12).devices.size == 8
    assert be.replica_mesh_for(32).shape == {"replica": 8}
    assert mesh_executor.MeshSearchBackend(["cpu"]).replica_mesh_for(
        32) is None


def test_fastpath_mesh_cohorts(monkeypatch):
    """A node of two devices: the fast path's v1 cohorts split their
    rows over them; each answer is the unsplit v1 launch's, byte for
    byte, the replica dispatches count, and the contribution kernel's
    wrapper runs once a replica device."""
    monkeypatch.setattr(srv, "NB_BUCKETS", (8, 16, 32))
    node = Node(device="cpu", devices=["cpu"] * 2)
    try:
        rng = np.random.default_rng(42)
        do(node, "PUT", "/books", body={
            "mappings": {"properties": {"title": {"type": "text"}}}})
        bulk([node], "books", [
            {"title": " ".join(rng.choice(VOCAB, rng.integers(3, 10)))}
            for _ in range(200)])
        fp = node.serving_lane()
        assert fp.mesh_backend is node.search_service.mesh_executor
        real = fp.route_rows

        def v1_only(reg, tids):
            lane, bucket = real(reg, tids)
            v2m = lane == srv.LANE_V2M
            lane[v2m] = srv.LANE_V1
            bucket[v2m] = srv.NB_BUCKETS[-1]
            return lane, bucket
        monkeypatch.setattr(fp, "route_rows", v1_only)
        body = {"query": {"match": {"title": "amber dune"}}, "size": 20,
                "_source": False}
        before = counter(node, "dispatch.replica")
        v1, split = fp.stats["cohorts_v1"], fp.stats["mesh_cohorts"]
        calls = TRACKER.calls("gather_bm25_contrib")
        fast = do(node, "POST", "/books/_search", None, dict(body))
        assert fp.stats["cohorts_v1"] == v1 + 1
        assert fp.stats["mesh_cohorts"] == split + 1
        assert counter(node, "dispatch.replica") == before + 1
        assert TRACKER.calls("gather_bm25_contrib") == calls + 2
        reg = fp._regs["books"]
        assert reg["rmesh"] is not None and reg["rmesh"].devices.size == 2
        unsplit = port_loop(node, "books", body)
        assert fp.stats["mesh_cohorts"] == split + 1
        assert fp.stats["cohorts_v1"] == v1 + 2
        assert_bit_equal(fast, unsplit)
        slow = node.search_service.search("books", dict(body))
        assert fast["hits"]["total"] == slow["hits"]["total"]
        for (fi, fs), (si, ss) in zip(hits_of(fast), hits_of(slow)):
            assert fs == pytest.approx(ss, rel=2e-3), (fi, si)
        assert gather_bm25_contrib.launches == 0   # the CPU twin ran
    finally:
        node.close()


# ------------------------------------------------------------ telemetry


def test_kernels_mesh_surface(nodes):
    """GET /_kernels has the ``mesh`` section: dispatch and fallback
    counters and the mesh's own copies a device (none: every device of
    the grid is the node's, whose copies the shards read), and GET
    /_nodes/stats carries the same stats (the reference's
    metrics-registry mirror waits for the port's
    telemetry/metrics.py)."""
    jax_node, node = nodes
    rng = seed(nodes, "tele8", n_shards=8, n_docs=80, seed_=3, vec=True)
    mix = pinned_mix(rng)
    for body in mix[:1] + mix[-1:]:
        for n in nodes:
            search(n, "tele8", body)
    for n in nodes:
        m = do(n, "GET", "/_kernels")["mesh"]
        assert m["devices"] == 8
        assert m["counters"].get("dispatch.shard", 0) >= 1
        assert m["counters"].get("dispatch.knn", 0) >= 1
    m = do(node, "GET", "/_kernels")["mesh"]
    assert m["residency"] == {} and m["replica_corpus_bytes"] == 0
    stats = do(node, "GET", "/_nodes/stats")
    assert next(iter(stats["nodes"].values()))["mesh"]["counters"] == \
        mesh(node).stats()["counters"]
    # the mesh programs are tracked kernels
    for name in ("plan_topk_mesh", "mesh_knn_step", "mesh_merge"):
        assert do(node, "GET", "/_kernels")["kernels"][name]["calls"] >= 1
    mesh(node).clear()
    assert mesh(node).residency() == {}


def test_mesh_profile_attribution(nodes):
    """``profile: true`` rides the mesh: one ``[index][_mesh]`` entry
    whose device record names the launch, the mesh shape and its eight
    devices, as the reference's."""
    jax_node, node = nodes
    seed(nodes, "prof8", n_shards=8, n_docs=80, seed_=3)
    body = {"query": {"match": {"title": "amber dune"}}, "size": 10,
            "profile": True}
    for n in nodes:
        r, engaged = searched(n, "prof8", body)
        assert engaged == 1
        shards = r["profile"]["shards"]
        entries = [s for s in shards if s["id"].endswith("[_mesh]")]
        assert len(entries) == 1, [s["id"] for s in shards]
        assert entries[0]["id"] == "[prof8][_mesh]"
        launches = entries[0]["device"]["launches"]
        assert launches[0]["kernel"] == "plan_topk_mesh"
        assert launches[0]["mesh_shape"] == {"shard": 8}
        assert len(launches[0]["device"]) == 8
        assert launches[0]["readback_bytes"] > 0
        q0 = entries[0]["searches"][0]["query"][0]
        bd = q0["breakdown"]
        assert bd["device_time_in_nanos"] + bd["host_time_in_nanos"] \
            == q0["time_in_nanos"]
    got = search(node, "prof8", body)
    plain = {k: v for k, v in body.items() if k != "profile"}
    assert_bit_equal(got, search(node, "prof8", plain))


def test_scripted_plan_takes_the_loop(nodes, monkeypatch):
    """An expression script_score body on several shards takes the
    per-shard loop (``plan_incompatible``): the mesh's plan program runs
    no script. The reference's mesh takes such a body and drops its
    script (ROADMAP Queue 3), so the port's answer is held to the
    reference's loop."""
    jax_node, node = nodes
    seed(nodes, "sc8", n_shards=4, n_docs=60)
    body = {"query": {"script_score": {
        "query": {"match": {"title": "amber"}},
        "script": {"source": "_score * 2 + doc['views'].value"}}},
        "size": 5}
    fb = counter(node, "fallback.plan_incompatible")
    got, engaged = searched(node, "sc8", body)
    assert engaged == 0
    assert counter(node, "fallback.plan_incompatible") == fb + 1
    assert_bit_equal(got, port_loop(node, "sc8", body))
    monkeypatch.setenv("ESTPU_MESH_SERVING", "0")
    assert_parity(got, jax_node, "sc8", body)
