"""The dense_vector kNN path on the card against the same calls on the
CPU.

- the slab: bfloat16 bits (float32 values), norms, sq_norms and
  has_value of a DeviceSegment built on the card equal the CPU's (the
  division on the card is IEEE, the cast rounds to nearest even);
- the bfloat16 -> float32 product: the route the card takes
  (``matmul_route``), float32 output, and both routes (``mm`` with
  ``out_dtype`` where this PyTorch has it, and the float32 upcast)
  within float32 rounding of the CPU's product;
- ``knn_nominate_batch`` for each similarity on both slab dtypes, with
  deletes and ties at the cut (bfloat16 atol 1e-4, float32 rtol 1e-5;
  ids equal except among scores that tie within that tolerance);
- ``_search`` bodies on a card node and a CPU node: pure kNN (the
  KnnBatcher), a filtered knn, knn merged into a match, ``rank.rrf``,
  ``exists``: ids, order and totals equal, scores rtol 1e-6;
- the KnnBatcher: 16 concurrent callers share one cohort launch on the
  card, and each row equals its query launched alone.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.corpus import knn_query_vectors, unit_vectors
from elasticsearch_tpu_torch.index.segment import segment_from_numpy
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import vector as vec_ops
from elasticsearch_tpu_torch.ops.device import DeviceSegment
from elasticsearch_tpu_torch.search.batching import KnnBatcher
from elasticsearch_tpu_torch.search.context import (DeviceSegmentCache,
                                                    SegmentContext,
                                                    ShardStats)

pytestmark = pytest.mark.cuda

SIMS = ("cosine", "dot_product", "l2_norm")
DIMS = 64
N = 20000


def vector_segment(sim, seed, pool=0, n=N):
    """A seeded vectors-only segment: about 5 % of docs without a
    vector; ``pool`` > 0 repeats that many distinct vectors."""
    rng = np.random.default_rng(seed)
    vecs = unit_vectors(n, DIMS, seed)
    if pool:
        vecs = vecs[rng.integers(0, pool, n)]
    if sim != "cosine":
        vecs = vecs * 0.5
    has = rng.random(n) > 0.05
    vecs = np.where(has[:, None], vecs, 0.0).astype(np.float32)
    return segment_from_numpy({"vectors": {"v": {
        "vectors": vecs, "has_value": has, "similarity": sim}}},
        name=f"v_{sim}_{seed}_{pool}")


def _bits(t):
    t = t.cpu()
    return (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy())


@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_slab_on_the_card_equals_the_cpu(cuda_device, sim, dtype):
    seg = vector_segment(sim, 1)
    card = DeviceSegment(seg, cuda_device, vector_dtype=dtype).vectors["v"]
    cpu = DeviceSegment(seg, "cpu", vector_dtype=dtype).vectors["v"]
    assert card.vectors.device.type == "cuda" and card.vectors.dtype == dtype
    np.testing.assert_array_equal(_bits(card.vectors), _bits(cpu.vectors))
    for name in ("norms", "sq_norms", "has_value"):
        np.testing.assert_array_equal(getattr(card, name).cpu().numpy(),
                                      getattr(cpu, name).numpy())


def test_bfloat16_product_routes(cuda_device, monkeypatch):
    """The card's route for a bfloat16 slab gives float32 scores; the
    upcast route gives the same within float32 summation order; both
    within float32 rounding of the CPU's product."""
    rng = np.random.default_rng(3)
    slab = torch.from_numpy(rng.standard_normal((50000, 768)).astype(
        np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((8, 768)).astype(np.float32))
    route = vec_ops.matmul_route(slab.to(cuda_device))
    assert route in ("mm_out_dtype", "upcast")
    print(f"bfloat16 product route on {torch.cuda.get_device_name(0)}: "
          f"{route}")
    cpu = vec_ops.dot_scores(q, slab).numpy()
    outs = {route: vec_ops.dot_scores(q.to(cuda_device),
                                      slab.to(cuda_device))}
    monkeypatch.setattr(vec_ops, "matmul_route", lambda s: "upcast")
    outs["upcast"] = vec_ops.dot_scores(q.to(cuda_device),
                                        slab.to(cuda_device))
    for name, out in outs.items():
        assert out.dtype == torch.float32, name
        np.testing.assert_allclose(out.cpu().numpy(), cpu, rtol=0,
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pool", [0, 7])
def test_knn_nominate_batch_on_the_card(cuda_device, sim, dtype, pool):
    seg = vector_segment(sim, 5, pool)
    rng = np.random.default_rng(6)
    live = rng.random(seg.n_docs) > 0.1
    seg.live = live
    qs = torch.from_numpy(rng.standard_normal((32, DIMS)).astype(
        np.float32))
    out = []
    for dev in (cuda_device, "cpu"):
        ds = DeviceSegment(seg, dev, vector_dtype=dtype)
        dv = ds.vectors["v"]
        s, i = vec_ops.knn_nominate_batch(
            qs.to(ds.device), dv.vectors, dv.sq_norms, dv.has_value,
            ds.live, sim, 1024)
        out.append((s.cpu().numpy(), i.cpu().numpy()))
    (cs, ci), (ps, pi) = out
    fin = np.isfinite(ps)
    assert (np.isfinite(cs) == fin).all()
    tol = (dict(atol=1e-4, rtol=0) if dtype == torch.bfloat16
           else dict(atol=0, rtol=1e-5))
    np.testing.assert_allclose(cs[fin], ps[fin], **tol)
    for r in range(len(qs)):
        for j in np.nonzero(ci[r] != pi[r])[0]:
            tied = np.abs(ps[r] - ps[r][j]) <= 2e-4
            assert tied.sum() > 1 and ci[r][j] in set(pi[r][tied])
        assert live[ci[r][np.isfinite(cs[r])]].all()


@pytest.fixture(scope="module")
def knn_nodes():
    """A card node and a CPU node with the same index of one segment: a
    text field and a 64-d vector field over 4000 docs, some deleted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    words = [f"w{i}" for i in range(40)]
    vecs = unit_vectors(4000, DIMS, 12)
    nodes = (Node(device="cuda"), Node(device="cpu"))
    for node in nodes:
        c = node.rest_controller
        c.dispatch("PUT", "/h", {}, {"mappings": {"properties": {
            "t": {"type": "text"}, "n": {"type": "long"},
            "v": {"type": "dense_vector", "dims": DIMS}}}})
    lines = []
    for i in range(4000):
        d = {"t": " ".join(rng.choice(words, 6)), "n": int(i % 97)}
        if i % 19:
            d["v"] = [float(x) for x in vecs[i]]
        lines.append(json.dumps({"index": {"_id": str(i)}}))
        lines.append(json.dumps(d))
    dels = "".join(json.dumps({"delete": {"_id": str(i)}}) + "\n"
                   for i in range(0, 4000, 13))
    for node in nodes:
        c = node.rest_controller
        st, r = c.dispatch("POST", "/h/_bulk", {"refresh": "true"},
                           "\n".join(lines) + "\n")
        assert st == 200 and not r["errors"]
        st, r = c.dispatch("POST", "/h/_bulk", {"refresh": "true"}, dels)
        assert st == 200 and not r["errors"]
    yield nodes
    for node in nodes:
        node.close()


def _qv(seed):
    return [float(x) for x in np.random.default_rng(seed).standard_normal(
        DIMS)]


BODIES = [
    {"knn": {"field": "v", "query_vector": _qv(1), "k": 100,
             "num_candidates": 300}, "size": 100, "_source": False},
    {"knn": {"field": "v", "query_vector": _qv(2), "k": 20,
             "filter": {"range": {"n": {"lt": 30}}}}, "size": 20},
    {"query": {"match": {"t": "w3 w7"}},
     "knn": {"field": "v", "query_vector": _qv(3), "k": 50}, "size": 50,
     "_source": False},
    {"query": {"match": {"t": "w5"}},
     "knn": {"field": "v", "query_vector": _qv(4), "k": 100,
             "num_candidates": 150},
     "rank": {"rrf": {}}, "size": 100, "_source": False},
    {"query": {"exists": {"field": "v"}}, "size": 10},
]


@pytest.mark.parametrize("bi", range(len(BODIES)))
def test_search_on_the_card_equals_the_cpu(knn_nodes, bi):
    card, cpu = knn_nodes
    body = BODIES[bi]
    got = card.rest_controller.dispatch("POST", "/h/_search", {},
                                        json.loads(json.dumps(body)))
    ref = cpu.rest_controller.dispatch("POST", "/h/_search", {},
                                       json.loads(json.dumps(body)))
    assert got[0] == ref[0] == 200, (got, ref)
    got, ref = got[1], ref[1]
    assert got["hits"]["total"] == ref["hits"]["total"]
    assert [h["_id"] for h in got["hits"]["hits"]] == \
        [h["_id"] for h in ref["hits"]["hits"]]
    np.testing.assert_allclose([h["_score"] for h in got["hits"]["hits"]],
                               [h["_score"] for h in ref["hits"]["hits"]],
                               rtol=1e-6, atol=0)
    assert len(got["hits"]["hits"]) > 0


def one_cohort(batcher, ctx, field, qs, cut):
    """Each caller's (scores, ids) for ``qs`` asked at once from one
    thread each, while the batcher's launch slots are held until every
    caller has queued: the leader then pops them all as one cohort."""
    out = [None] * len(qs)

    def call(i):
        out[i] = batcher.topk(ctx, field, qs[i], cut)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(qs))]
    held = 0
    while batcher._launch_slots.acquire(blocking=False):
        held += 1
    try:
        for t in threads:
            t.start()
        while True:
            with batcher._lock:
                if sum(map(len, batcher._pending.values())) == len(qs):
                    break
            time.sleep(0.001)
    finally:
        for _ in range(held):
            batcher._launch_slots.release()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


def test_knn_batcher_cohort_on_the_card(cuda_device):
    seg = vector_segment("cosine", 21, n=200000)
    ctx = SegmentContext(seg, DeviceSegmentCache(cuda_device).get(seg),
                         None, ShardStats([seg]))
    qs = knn_query_vectors(seg.vectors["v"].vectors, 16,
                           np.random.default_rng(22))
    solo = [KnnBatcher().topk(ctx, "v", q, 1000) for q in qs]
    batcher = KnnBatcher()
    out = one_cohort(batcher, ctx, "v", qs, 1000)
    assert batcher.launches == 1 and batcher.batched_queries == len(qs)
    for (s, i), (s0, i0) in zip(out, solo):
        np.testing.assert_array_equal(i, i0)
        np.testing.assert_array_equal(s, s0)
