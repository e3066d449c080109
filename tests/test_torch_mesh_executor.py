"""The mesh through REST `_search` (tests/test_mesh_executor.py's cases,
run against both packages): a multi-shard index on the reference's
eight virtual jax devices and on the port's grid of ``["cpu"] * 8``
(``Node(device="cpu", devices=["cpu"] * 8)``: one process, one
controller). The same seeded documents go to both nodes through
``_bulk``, then ``_forcemerge`` (one segment a shard, the mesh's
residency).

- The port's mesh answer equals the port's per-shard loop bit for bit:
  ids, order, raw float32 scores, totals and ``max_score``.
- Against the reference: ids, order and totals exact, scores rtol 1e-6;
  where the reference's float32 plan path splits a true tie (ROADMAP
  Queue 3), test_torch_shards' tie-aware compare at rtol 1e-4.
- A body the mesh serves counts one mesh search in both packages; a
  body it refuses counts the same ``fallback.<reason>`` in both.

The helpers here serve tests/test_torch_mesh_serving.py too."""

import json
import os

import numpy as np
import pytest

from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.ops import plan as jax_plan
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import device as port_device
from elasticsearch_tpu_torch.ops import plan as port_plan
from test_torch_shards import assert_same_hits

CPU8 = ["cpu"] * 8
VOCAB = ["amber", "basalt", "cedar", "dune", "ember", "fjord", "granite",
         "harbor", "islet", "juniper", "krill", "lagoon", "mesa", "nectar"]
DIMS = 8
MAPPINGS = {"properties": {"title": {"type": "text"},
                           "tag": {"type": "keyword"},
                           "views": {"type": "long"}}}
VEC_MAPPINGS = {"properties": {
    "title": {"type": "text"}, "tag": {"type": "keyword"},
    "vec": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"}}}

QUERIES = [
    {"match": {"title": "amber dune"}},
    {"match": {"title": {"query": "cedar fjord mesa", "operator": "and"}}},
    {"bool": {"must": [{"match": {"title": "granite"}}],
              "filter": [{"term": {"tag": "x"}}]}},
    {"bool": {"should": [{"match": {"title": "krill"}},
                         {"match": {"title": "lagoon harbor"}}],
              "minimum_should_match": 1}},
    {"multi_match": {"query": "ember islet", "fields": ["title"]}},
]


def do(node, method, path, params=None, body=None, expect=200):
    status, resp = node.rest_controller.dispatch(method, path, params,
                                                 body)
    assert status == expect, f"{method} {path} -> {status}: {resp}"
    return resp


def make_docs(rng, n_docs, vec=False):
    """The reference tests' documents (their draws, in their order)."""
    docs = []
    for i in range(n_docs):
        d = {"title": " ".join(rng.choice(VOCAB, rng.integers(2, 10))),
             "tag": str(rng.choice(["x", "y"]))}
        if vec:
            d["vec"] = rng.standard_normal(DIMS).astype(np.float32).tolist()
        else:
            d["views"] = int(rng.integers(0, 50))
        docs.append(d)
    return docs


def bulk(nodes, index, docs, ids=None, refresh=True):
    ids = ids or [str(i) for i in range(len(docs))]
    lines = "".join(json.dumps({"index": {"_id": i}}) + "\n"
                    + json.dumps(d) + "\n" for i, d in zip(ids, docs))
    for node in nodes:
        r = do(node, "POST", f"/{index}/_bulk",
               {"refresh": "true"} if refresh else {}, lines)
        assert not r["errors"], r


def seed(nodes, index, n_shards, n_docs=120, seed_=5, vec=False,
         forcemerge=True):
    """Create ``index`` on every node with the same documents; returns
    the rng after the documents' draws (the reference tests draw their
    query vectors from it)."""
    rng = np.random.default_rng(seed_)
    for node in nodes:
        do(node, "PUT", f"/{index}", body={
            "settings": {"index": {"number_of_shards": n_shards}},
            "mappings": VEC_MAPPINGS if vec else MAPPINGS})
    bulk(nodes, index, make_docs(rng, n_docs, vec))
    if forcemerge:
        for node in nodes:
            do(node, "POST", f"/{index}/_forcemerge")
    return rng


def mesh(node):
    return node.search_service.mesh_executor


def counter(node, key):
    return mesh(node).counters.get(key, 0)


def hits_of(r):
    return [(h["_id"], h["_score"]) for h in r["hits"]["hits"]]


def search(node, index, body, params=None):
    body = dict(body)
    if isinstance(node, JaxNode) and body.get("size") == 0:
        body["request_cache"] = False
    return do(node, "POST", f"/{index}/_search", params, body)


def searched(node, index, body, params=None):
    """(response, mesh searches it made)."""
    before = mesh(node).mesh_searches
    r = search(node, index, body, params)
    return r, mesh(node).mesh_searches - before


def port_loop(node, index, body, params=None):
    """The port's per-shard loop's answer to ``body``."""
    old = os.environ.get("ESTPU_MESH_SERVING")
    os.environ["ESTPU_MESH_SERVING"] = "0"
    try:
        return search(node, index, body, params)
    finally:
        if old is None:
            del os.environ["ESTPU_MESH_SERVING"]
        else:
            os.environ["ESTPU_MESH_SERVING"] = old


def assert_bit_equal(got, want):
    """Raw float32 scores, ids, order, totals and max_score equal."""
    assert hits_of(got) == hits_of(want)
    assert got["hits"]["total"] == want["hits"]["total"]
    assert got["hits"]["max_score"] == want["hits"]["max_score"]


def assert_parity(got, jax_node, index, body, params=None):
    """``got`` (the port's answer) against the reference's: exact ids,
    order and totals with scores rtol 1e-6, or, where the reference
    splits a true tie, the tie-aware compare at rtol 1e-4."""
    size = int(body.get("size", 10))
    ref = search(jax_node, index, {**body, "size": size + 1}, params)
    rh = hits_of(ref)[:size]
    gh = hits_of(got)
    assert got["hits"]["total"] == ref["hits"]["total"]
    gs = np.array([s for _, s in gh])
    rs = np.array([s for _, s in rh])
    if [i for i, _ in gh] == [i for i, _ in rh] and \
            np.allclose(gs, rs, rtol=1e-6, atol=0):
        return
    tied = any(abs(a - b) <= 1e-4 * abs(a) for a, b in zip(rs, rs[1:]))
    assert tied, (gh, rh)
    assert_same_hits(got, ref, size)


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    jax_node = JaxNode(Settings.EMPTY,
                       data_path=str(tmp_path_factory.mktemp("mesh")))
    node = Node(device="cpu", devices=CPU8)
    yield jax_node, node
    node.close()
    jax_node.close()


def test_mesh_equals_per_shard_loop(nodes):
    """One launch a shard and the device merge answer what the loop
    answers, bit for bit, and what the reference's SPMD program
    answers."""
    jax_node, node = nodes
    seed(nodes, "m8", n_shards=8)
    for q in QUERIES:
        body = {"query": q, "size": 200}
        r_mesh, engaged = searched(node, "m8", body)
        assert engaged == 1, q
        _, ref_engaged = searched(jax_node, "m8", body)
        assert ref_engaged == 1, q
        assert_bit_equal(r_mesh, port_loop(node, "m8", body))
        assert_parity(r_mesh, jax_node, "m8", body)


def test_one_shard_vs_eight_shards(nodes):
    """Same corpus in 1 and 8 shards: the same doc sets and totals
    (per-shard idf differs between the layouts, so the order may)."""
    jax_node, node = nodes
    seed(nodes, "one", n_shards=1)
    seed(nodes, "eight", n_shards=8)
    for q in QUERIES:
        body = {"query": q, "size": 200}
        r1, r8 = search(node, "one", body), search(node, "eight", body)
        assert {h["_id"] for h in r1["hits"]["hits"]} == \
            {h["_id"] for h in r8["hits"]["hits"]}, q
        assert r1["hits"]["total"] == r8["hits"]["total"], q
        assert_parity(r8, jax_node, "eight", body)


def test_mesh_skips_incompatible(nodes):
    """Aggs and sorts take the per-shard loop in both packages, and
    answer alike."""
    jax_node, node = nodes
    seed(nodes, "mx", n_shards=4, n_docs=40)
    bodies = [{"query": {"match": {"title": "amber"}},
               "aggs": {"tags": {"terms": {"field": "tag"}}}},
              {"query": {"match": {"title": "amber"}},
               "sort": [{"views": "desc"}]}]
    for body in bodies:
        got, engaged = searched(node, "mx", body)
        ref, ref_engaged = searched(jax_node, "mx", body)
        assert engaged == ref_engaged == 0
        assert [h["_id"] for h in got["hits"]["hits"]] == \
            [h["_id"] for h in ref["hits"]["hits"]]
        assert got["hits"]["total"] == ref["hits"]["total"]
        if "aggs" in body:
            assert got["aggregations"] == ref["aggregations"]


def test_mesh_missing_terms(nodes):
    jax_node, node = nodes
    seed(nodes, "mz", n_shards=4, n_docs=30)
    body = {"query": {"match": {"title": "zzznope"}}, "size": 200}
    for n in nodes:
        before = counter(n, "dispatch.shard")
        r, engaged = searched(n, "mz", body)
        assert r["hits"]["hits"] == []
        assert r["hits"]["total"]["value"] == 0
        assert engaged == 1
        assert counter(n, "dispatch.shard") == before + 1


def test_mesh_multi_segment_shards(nodes):
    """Shards of several segments take the loop (``multi_segment``) in
    both packages, which answers. The reference's opt-in composite mode
    (ESTPU_MESH_COMPOSITE=1, to float32 tolerance of the loop) has no
    counterpart: the port's mesh answers bit for bit or not at all. Once
    force-merged, the shards serve on the mesh again, equal to the
    loop."""
    jax_node, node = nodes
    rng = np.random.default_rng(9)
    for n in nodes:
        do(n, "PUT", "/ms", body={
            "settings": {"index": {"number_of_shards": 4}},
            "mappings": {"properties": {"title": {"type": "text"},
                                        "views": {"type": "long"}}}})
    did = 0
    for _gen in range(3):
        docs, ids = [], []
        for _ in range(40):
            docs.append({"title": " ".join(rng.choice(
                VOCAB, rng.integers(2, 10))), "views": did})
            ids.append(str(did))
            did += 1
        bulk(nodes, "ms", docs, ids)
    svc = node.indices["ms"]
    assert any(len(shard.segments) > 1 for shard in svc.shards)
    body = {"query": QUERIES[0], "size": 200}
    for n in nodes:
        fb = counter(n, "fallback.multi_segment")
        r, engaged = searched(n, "ms", body)
        assert engaged == 0
        assert counter(n, "fallback.multi_segment") == fb + 1
        assert r["hits"]["hits"]
    assert_parity(search(node, "ms", body), jax_node, "ms", body)
    for n in nodes:
        do(n, "POST", "/ms/_forcemerge")
    for q in QUERIES[:2] + [QUERIES[3]]:
        body = {"query": q, "size": 200}
        r_mesh, engaged = searched(node, "ms", body)
        assert engaged == 1, q
        assert_bit_equal(r_mesh, port_loop(node, "ms", body))
        assert_parity(r_mesh, jax_node, "ms", body)
        for h in r_mesh["hits"]["hits"]:
            assert h["_source"]["views"] == int(h["_id"])


def test_mesh_float_pack_overflow_falls_back(nodes, monkeypatch):
    """Global ids at or past the packed readback's float32 ceiling
    (n_shards * nd_padded >= 2^24) take the per-shard loop in both
    packages, which answers."""
    jax_node, node = nodes
    seed(nodes, "ovf", n_shards=4, n_docs=40)
    for mod in (jax_plan, port_plan):
        monkeypatch.setattr(mod, "PACKED_ID_LIMIT", 1)
        monkeypatch.setattr(mod, "check_packed_id_limit",
                            lambda nd, where: None)
    monkeypatch.setattr(port_device, "check_packed_id_limit",
                        lambda nd, where: None)
    body = {"query": {"match": {"title": "amber"}}, "size": 200}
    for n in nodes:
        fb = counter(n, "fallback.packed_id_ceiling")
        r, engaged = searched(n, "ovf", body)
        assert engaged == 0
        assert counter(n, "fallback.packed_id_ceiling") == fb + 1
        assert r["hits"]["total"]["value"] > 0
        for h in r["hits"]["hits"]:
            assert "amber" in h["_source"]["title"]
    assert_parity(search(node, "ovf", body), jax_node, "ovf", body)
