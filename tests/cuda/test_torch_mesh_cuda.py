"""The mesh on the card (parallel/): its programs over a grid of one card
repeated, at a small size, against the per-shard loop and the CPU.

- A ``Node(device="cuda", devices=["cuda:0"] * 5)`` serves a 5-shard
  index on the mesh: each body's answer equals the same node's
  per-shard loop bit for bit (ids, order, raw float32 scores, totals,
  max_score) and a CPU node's answer (scores rtol 1e-6), reading the
  node's own resident segments (no second copy); with the
  node's default device list (every visible card) a body falls back
  (``not_enough_devices`` below five cards) and answers the same.
- ``_mesh_knn_nominate`` / ``_mesh_knn_step`` over five row ranges of
  one bfloat16 slab (views) equal the per-shard nomination, exact
  re-rank, cut and merge computed shard by shard.
- The replica fan-out on a grid of 2 x cuda:0: a PlanBatcher cohort of
  32 and a fast-path v1 cohort equal their unsplit launches byte for
  byte; the split v1 cohort launches the contribution kernel twice (one
  a replica device), and ``/_kernels``' calls agree.
- The sharded programs on a 5 x cuda:0 grid equal the CPU grid's.
"""

import json
import os

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import vector as vec_ops
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.ops.topk import stable_topk
from elasticsearch_tpu_torch.parallel import mesh_executor as mx
from elasticsearch_tpu_torch.parallel import sharded
from elasticsearch_tpu_torch.search import fastpath as srv
from elasticsearch_tpu_torch.search.batching import PlanBatcher, _Entry
from elasticsearch_tpu_torch.search.plan import bind_plan, compile_plan
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.telemetry.engine import TRACKER

pytestmark = pytest.mark.cuda

SHARDS = 5
VOCAB = [f"w{i}" for i in range(40)]
MAPPINGS = {"properties": {
    "t": {"type": "text"}, "k": {"type": "keyword"},
    "v": {"type": "dense_vector", "dims": 8, "similarity": "cosine"}}}
BODIES = [
    {"query": {"match": {"t": "w1 w3"}}, "size": 50},
    {"query": {"match": {"t": {"query": "w2 w5 w9", "operator": "and"}}},
     "size": 50},
    {"query": {"bool": {"must": [{"match": {"t": "w2"}}],
                        "filter": [{"term": {"k": "a"}}]}}, "size": 50},
    {"query": {"bool": {"should": [{"match": {"t": "w4"}},
                                   {"match": {"t": "w6 w7"}},
                                   {"match": {"t": "w0"}}],
                        "minimum_should_match": 1}}, "size": 50},
    {"knn": {"field": "v", "query_vector": [0.3, -0.2, 0.9, 0.1, 0.0, 0.5,
                                            -0.4, 0.2],
             "k": 10, "num_candidates": 40}, "size": 10},
]


def make_docs(n=600, seed=0):
    rng = np.random.default_rng(seed)
    return [{"t": " ".join(rng.choice(VOCAB, int(rng.integers(2, 14)))),
             "k": str(rng.choice(["a", "b"])),
             "v": rng.standard_normal(8).round(4).tolist()}
            for _ in range(n)]


def fill(node, name="m", shards=SHARDS, docs=None):
    c = node.rest_controller
    st, r = c.dispatch("PUT", f"/{name}", {}, {
        "settings": {"index": {"number_of_shards": shards}},
        "mappings": MAPPINGS})
    assert st == 200, r
    lines = "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                    + json.dumps(d) + "\n"
                    for i, d in enumerate(docs or make_docs()))
    st, r = c.dispatch("POST", f"/{name}/_bulk", {"refresh": "true"}, lines)
    assert st == 200 and not r["errors"], r
    st, _ = c.dispatch("POST", f"/{name}/_forcemerge", {}, None)
    assert st == 200


def ask(node, body, index="m"):
    st, r = node.rest_controller.dispatch("POST", f"/{index}/_search", {},
                                          dict(body))
    assert st == 200, r
    assert r["_shards"]["failed"] == 0
    return r


def hits_of(r):
    return [(h["_id"], h["_score"]) for h in r["hits"]["hits"]]


def loop(node, body):
    os.environ["ESTPU_MESH_SERVING"] = "0"
    try:
        return ask(node, body)
    finally:
        del os.environ["ESTPU_MESH_SERVING"]


@pytest.fixture(scope="module")
def mesh_nodes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    node = Node(device="cuda", devices=["cuda:0"] * SHARDS)
    cpu = Node(device="cpu")
    for n in (node, cpu):
        fill(n)
    yield node, cpu
    node.close()
    cpu.close()


@pytest.mark.parametrize("bi", range(len(BODIES)))
def test_mesh_on_one_card_repeated_equals_the_loop(mesh_nodes, bi):
    node, cpu = mesh_nodes
    be = node.search_service.mesh_executor
    body = BODIES[bi]
    before = be.mesh_searches
    got = ask(node, body)
    assert be.mesh_searches == before + 1
    want = loop(node, body)
    assert hits_of(got) == hits_of(want)
    assert got["hits"]["total"] == want["hits"]["total"]
    assert got["hits"]["max_score"] == want["hits"]["max_score"]
    ref = loop(cpu, body)
    assert [i for i, _ in hits_of(got)] == [i for i, _ in hits_of(ref)]
    assert got["hits"]["total"] == ref["hits"]["total"]
    np.testing.assert_allclose([s for _, s in hits_of(got)],
                               [s for _, s in hits_of(ref)], rtol=1e-6)
    assert be.counters.get("fallback.error", 0) == 0
    # every grid device is the node's: the shards read its own copies
    assert be.stats()["residency"] == {}


def test_one_card_falls_back_to_the_loop(cuda_device):
    node = Node(device="cuda")
    try:
        fill(node)
        be = node.search_service.mesh_executor
        assert be.available_devices() == torch.cuda.device_count()
        if be.available_devices() >= SHARDS:
            pytest.skip("this machine has a card per shard")
        r = ask(node, BODIES[0])
        assert be.counters == {"fallback.not_enough_devices": 1}
        assert be.mesh_searches == 0
        assert hits_of(r) == hits_of(loop(node, BODIES[0]))
    finally:
        node.close()


def knn_per_shard(views, live, host, q, nd, k, nc, cut):
    """The per-shard dense loop (KnnQuery's steps) and the coordinator
    merge, shard by shard: [(score, shard, docid)], total."""
    rows, total = [], 0
    for s, (v, sqn, hv) in enumerate(views):
        dev = v.device
        qt = torch.from_numpy(q).to(dev)[None]
        scores = vec_ops.similarity_scores(qt, v, sqn, "cosine")[0]
        scores = torch.where(hv, scores, 0.0)
        ids = torch.arange(nd, dtype=torch.int32, device=dev)
        _, top = stable_topk(scores[None], ids[None], nc)
        cand = top[0].cpu().numpy()
        cand = cand[cand < host[s].shape[0]]
        exact = vec_ops.exact_rerank_scores(host[s][cand], q, "cosine")
        scores = scores.index_put(
            (torch.from_numpy(cand.astype(np.int64)).to(dev),),
            torch.from_numpy(exact).to(dev))
        kth = torch.kthvalue(torch.where(hv, scores, float("-inf")),
                             nd - cut + 1).values
        mask = hv & (scores >= kth) & live[s]
        total += int(mask.sum())
        vals, i2 = stable_topk(torch.where(mask, scores, float("-inf"))[None],
                               ids[None], k)
        for x, d in zip(vals[0].tolist(), i2[0].tolist()):
            if x > float("-inf"):
                rows.append((x, s, d))
    rows.sort(key=lambda r: (-r[0], r[1], r[2]))
    return rows[:k], total


def test_mesh_knn_programs_over_views(cuda_device):
    rng = np.random.default_rng(4)
    rows, dims, k, nc = 3000, 32, 50, 200
    host = rng.standard_normal((SHARDS * rows, dims)).astype(np.float32)
    slab, norms = vec_ops.prepare_vectors(host, "cosine", torch.bfloat16,
                                          cuda_device, SHARDS * rows)
    sqn = torch.from_numpy(norms * norms).to(cuda_device)
    hv = torch.ones(SHARDS * rows, dtype=torch.bool, device=cuda_device)
    live = [hv[s * rows:(s + 1) * rows].clone() for s in range(SHARDS)]
    live[2][::7] = False        # deletes in one shard
    views = [(slab[s * rows:(s + 1) * rows], sqn[s * rows:(s + 1) * rows],
              hv[s * rows:(s + 1) * rows]) for s in range(SHARDS)]
    hosts = [host[s * rows:(s + 1) * rows] for s in range(SHARDS)]
    for qi in range(3):
        q = rng.standard_normal(dims).astype(np.float32)
        ids = mx._mesh_knn_nominate(
            [v for v, _, _ in views], [s for _, s, _ in views],
            [h for _, _, h in views], q, cuda_device, "cosine", nc)
        ids = ids.cpu().numpy()
        patches = []
        for s in range(SHARDS):
            cand = ids[s][ids[s] < rows]
            exact = vec_ops.exact_rerank_scores(hosts[s][cand], q, "cosine")
            patches.append((torch.from_numpy(cand.astype(np.int64)).to(
                cuda_device), torch.from_numpy(exact).to(cuda_device)))
        packed = mx._mesh_knn_step(
            [v for v, _, _ in views], [s for _, s, _ in views],
            [h for _, _, h in views], live, q, patches, cuda_device, rows,
            "cosine", 1.0, k, k).cpu().numpy()
        vals, gids = packed[:k], packed[k:2 * k].astype(np.int64)
        want, total = knn_per_shard(views, live, hosts, q, rows, k, nc, k)
        assert int(packed[2 * k]) == total
        assert [(int(g) // rows, int(g) % rows) for g in gids] == \
            [(s, d) for _, s, d in want]
        np.testing.assert_allclose(vals, [x for x, _, _ in want],
                                   rtol=1e-6)


def test_replica_plan_cohort_byte_equal(cuda_device):
    node = Node(device="cuda")
    try:
        fill(node, "one", shards=1)
        searcher = node.search_service._shard_searchers(
            node.indices["one"])[0]
        ctx = searcher._contexts()[0]
        bps = []
        for i in range(32):
            text = f"w{i % 40} w{(3 * i + 1) % 40}"
            q = parse_query({"match": {"t": text}}).rewrite(searcher)
            bps.append(bind_plan(compile_plan(q, searcher), ctx))
        solo = PlanBatcher()
        e1 = [_Entry(bp) for bp in bps]
        solo._run(e1, ctx, 100, searcher.k1, searcher.b)
        meshed = PlanBatcher()
        meshed.mesh = mx.MeshSearchBackend([cuda_device] * 2)
        e2 = [_Entry(bp) for bp in bps]
        meshed._run(e2, ctx, 100, searcher.k1, searcher.b)
        assert meshed.mesh_cohorts == 1
        assert meshed.mesh.counters == {"dispatch.replica": 32}
        for a, b in zip(e1, e2):
            assert a.result[0].tobytes() == b.result[0].tobytes()
            assert a.result[1].tobytes() == b.result[1].tobytes()
            assert a.result[2] == b.result[2]
        # replicas on the source's own card copy nothing
        assert meshed.mesh.stats()["replica_corpus_bytes"] == 0
    finally:
        node.close()


def test_replica_v1_cohort_byte_equal_and_launches(cuda_device):
    node = Node(device="cuda")
    try:
        fill(node, "one", shards=1)
        seg = node.indices["one"].engine.segments[0]
        be = mx.MeshSearchBackend([cuda_device] * 2)
        fp = srv.FastPathServer(cuda_device, node.device_cache,
                                mesh_backend=be)
        reg = fp.register("one", seg, "t", 1.2, 0.75)
        assert reg["rmesh"].devices.size == 2
        pf = reg["dp"].host
        queries = [[pf.term_id(f"w{(i + j) % 40}") for j in range(3)]
                   for i in range(srv.Q_BATCH)]
        bucket = srv.NB_BUCKETS[-1]

        def cohort(split):
            reg["rmesh"] = be.replica_mesh_for(srv.Q_BATCH) if split \
                else None
            items = [srv._Pending(reg, q, (), 100, "v1", bucket)
                     for q in queries]
            n0 = gather_bm25_contrib.launches
            c0 = TRACKER.calls("gather_bm25_contrib")
            fp._launch_cohort("v1", reg, bucket, items, {})
            torch.cuda.synchronize()
            return ([p.result for p in items],
                    gather_bm25_contrib.launches - n0,
                    TRACKER.calls("gather_bm25_contrib") - c0)

        whole, n_whole, c_whole = cohort(False)
        split, n_split, c_split = cohort(True)
        assert (n_whole, n_split) == (1, 2)
        assert (c_whole, c_split) == (1, 2)
        assert fp.stats["mesh_cohorts"] == 1
        assert be.counters == {"dispatch.replica": srv.Q_BATCH}
        for a, b in zip(whole, split):
            assert a[0].tobytes() == b[0].tobytes()
            assert a[1].tobytes() == b[1].tobytes()
            assert a[2] == b[2]
    finally:
        node.close()


def test_sharded_programs_on_the_card(cuda_device):
    rng = np.random.default_rng(9)
    mapper = DocumentMapper({"properties": {"body": {"type": "text"}}})
    segs = []
    for s in range(SHARDS):
        w = SegmentWriter()
        for i in range(200):
            w.add(mapper.parse(f"{s}-{i}", {"body": " ".join(
                rng.choice(VOCAB[:12], int(rng.integers(1, 15))))}))
        segs.append(w.build(f"s{s}"))
    card, pfs = sharded.build_sharded_index(
        sharded.make_mesh(n_shards=SHARDS, devices=[cuda_device] * SHARDS),
        segs, "body")
    cpu, _ = sharded.build_sharded_index(
        sharded.make_mesh(n_shards=SHARDS, devices=["cpu"] * SHARDS),
        segs, "body")
    sel = np.full((SHARDS, 1, 16), card.zero_blocks[0], np.int32)
    ws = np.zeros((SHARDS, 1, 16), np.float32)
    for s, pf in enumerate(pfs):
        n = 0
        for t in ("w1", "w4"):
            tid = pf.term_id(t)
            for blk in range(int(pf.term_block_start[tid]),
                             int(pf.term_block_start[tid]
                                 + pf.term_block_count[tid])):
                sel[s, 0, n] = blk
                ws[s, 0, n] = 1.3
                n += 1
    got = sharded.sharded_bm25_topk(card, sel, ws, 20)
    want = sharded.sharded_bm25_topk(cpu, sel, ws, 20)
    assert got[1].cpu().tolist() == want[1].tolist()
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=1e-6)
    assert sharded.sharded_dfs_stats(card, sel[:, 0]).cpu().tolist() == \
        sharded.sharded_dfs_stats(cpu, sel[:, 0]).tolist()
