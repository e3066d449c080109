"""``profile: true`` on the port against the reference, on the same
documents through both nodes' ``rest_controller.dispatch`` (the single-
node cases of tests/test_profile_api.py): the ES-shaped shard tree and
its invariant (device + host nanos == the query's nanos, every stage
within it), the batcher's attribution record, the aggregation scope and
the coordinator phases, the profile-off guard, the attribution table's
stages, and the same hits with and without ``profile`` on the plan, dense,
kNN and aggregation paths. The tree's keys are the reference's; its
kernel lists name the port's tracked entry points (search/profile.py
``KERNEL_ATTRIBUTION``). The profile names its ``trace.id`` and each
shard entry its ``search.class`` (and ``tenant`` when tagged), as the
reference's; the answers compared with and without ``profile`` drop
``took`` and their ``_headers`` (each request's own trace id). The
cluster cases wait for the port's transport.
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.search import profile as jax_profile
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search import profile

from test_torch_node import assert_same_hits

MAPPINGS = {"properties": {
    "title": {"type": "text"}, "rank": {"type": "long"},
    "tag": {"type": "keyword"},
    "v": {"type": "dense_vector", "dims": 4, "similarity": "cosine"}}}


def _docs(n=30, seed=0):
    rng = np.random.default_rng(seed)
    return [{"title": f"fox doc {i} " + ("red" if i % 2 else "blue"),
             "rank": i, "tag": ["a", "b", "c"][i % 3],
             "v": rng.standard_normal(4).round(3).tolist()}
            for i in range(n)]


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("profile")))
    node = Node(device="cpu")
    lines = "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                    + json.dumps(d) + "\n" for i, d in enumerate(_docs()))
    for c in (jax_node.rest_controller, node.rest_controller):
        st, _ = c.dispatch("PUT", "/idx", {}, {
            "mappings": MAPPINGS,
            "settings": {"index": {"number_of_shards": 1}}})
        assert st == 200
        st, r = c.dispatch("POST", "/idx/_bulk", {"refresh": "true"}, lines)
        assert st == 200 and not r["errors"]
    yield jax_node, node
    node.close()
    jax_node.close()


def _search(node, body):
    status, r = node.rest_controller.dispatch("POST", "/idx/_search", {},
                                              body)
    assert status == 200, r
    return r


def _ref_search(jax_node, body):
    # the reference caches size-0 responses; the port refuses the key
    return _search(jax_node, {**body, "request_cache": False}
                   if body.get("size") == 0 else body)


def _assert_invariant(shard):
    q = shard["searches"][0]["query"][0]
    bd = q["breakdown"]
    total = q["time_in_nanos"]
    assert total > 0
    assert bd["device_time_in_nanos"] + bd["host_time_in_nanos"] == total
    stages = {k: v for k, v in bd.items()
              if not k.endswith("_time_in_nanos")}
    assert stages and all(0 <= v <= total for v in stages.values())
    assert sum(stages.values()) <= total


def test_single_node_profile_shape_and_sum_invariant(nodes):
    body = {"query": {"match": {"title": "fox"}}, "profile": True,
            "size": 5}
    jax_node, node = nodes
    ref = _search(jax_node, body)["profile"]
    prof = _search(node, body)["profile"]
    assert set(prof) >= {"shards", "coordinator"}
    assert set(ref) == set(prof)
    assert prof["trace.id"]
    assert prof["coordinator"]["phases"]["query_ns"] >= 0
    shard = prof["shards"][0]
    assert set(ref["shards"][0]) == set(shard)
    assert shard["search.class"] == ref["shards"][0]["search.class"]
    _assert_invariant(shard)
    assert set(shard["searches"][0]) == set(ref["shards"][0]["searches"][0])
    coll = shard["searches"][0]["collector"][0]
    assert coll["name"].endswith("TopDocsCollector")
    assert coll["name"] == ref["shards"][0]["searches"][0]["collector"][0][
        "name"]
    assert shard["fetch"]["time_in_nanos"] > 0
    assert set(shard["fetch"]) == set(ref["shards"][0]["fetch"])


def test_device_attribution_on_the_plan_path(nodes):
    body = {"query": {"match": {"title": "fox"}}, "profile": True,
            "size": 5, "_source": False}
    jax_node, node = nodes
    _search(node, body)               # warm the shapes
    r = _search(node, body)
    ref = _search(jax_node, body)["profile"]["shards"][0]["device"]
    dev = r["profile"]["shards"][0]["device"]
    launch = dev["launches"][0]
    assert set(launch) == set(ref["launches"][0])
    assert launch["kernel"] == "plan_topk_batch"
    assert launch["cohort"] >= 1
    assert launch["q_bucket"] >= launch["cohort"]
    assert launch["nb_bucket"] >= 1
    assert launch["batch_wait_ms"] >= 0.0
    assert 0.0 <= launch["padding_waste_pct"] <= 100.0
    assert launch["readback_bytes"] > 0
    assert launch["launch_ms"] >= 0.0
    kinds = {k["kernel"]: k["kind"] for k in dev["kernels"]}
    assert kinds["plan_topk_batch"] == "cached"    # warmed
    assert dev["readback_bytes"] > 0
    assert dev["readback_ms"] >= 0
    assert set(ref) <= set(dev) | {"hbm_admissions", "hbm_evictions"}


def test_aggregation_child_scope_and_reduce_phase(nodes):
    body = {"query": {"match": {"title": "fox"}}, "profile": True,
            "size": 0, "aggs": {"m": {"avg": {"field": "rank"}}}}
    jax_node, node = nodes
    ref = _ref_search(jax_node, body)["profile"]
    prof = _search(node, body)["profile"]
    for p in (ref, prof):
        assert p["coordinator"]["reduce_batches"] == 1
        assert p["coordinator"]["phases"]["aggs_ns"] >= 0
    aggs = prof["shards"][0]["aggregations"]
    assert [a["type"] for a in aggs] == ["aggregations"]
    assert aggs[0]["description"] == "m"
    assert set(aggs[0]["breakdown"]) == {"collect"}
    _assert_invariant(prof["shards"][0])


def test_profile_off_hot_path_allocates_no_profile_objects(nodes,
                                                           monkeypatch):
    """With ``profile`` absent no recorder is entered and no attribution
    record is allocated on the serving path."""
    def boom(*a, **k):
        raise AssertionError("profiling() entered on a profile-off path")

    calls = []
    monkeypatch.setattr(profile, "profiling", boom)
    monkeypatch.setattr(profile, "record_device",
                        lambda attrs: calls.append(attrs))
    monkeypatch.setattr(profile, "note_kernel", lambda *a: calls.append(a))
    monkeypatch.setattr(profile, "shard_profile_tree", boom)
    _, node = nodes
    for body in ({"query": {"match": {"title": "fox"}}, "size": 5},
                 {"query": {"match": {"title": "fox"}}, "size": 5,
                  "sort": [{"rank": "desc"}]},
                 {"knn": {"field": "v", "query_vector": [1, 0, 0, 0],
                          "k": 3, "num_candidates": 10},
                  "_source": False}):
        r = _search(node, body)
        assert "profile" not in r
    assert calls == []
    assert not profile.recording()


def test_kernel_attribution_stage_names_valid():
    for name, stage in profile.KERNEL_ATTRIBUTION.items():
        root = stage.split(".", 1)[0]
        assert root in profile.DEVICE_STAGES + profile.HOST_STAGES \
            + ("aggs",), f"{name} attributes to unknown stage {stage}"
    # the rows under the reference's names keep the reference's stage
    for name, stage in profile.KERNEL_ATTRIBUTION.items():
        if name in jax_profile.KERNEL_ATTRIBUTION:
            assert jax_profile.KERNEL_ATTRIBUTION[name] == stage, name


BODIES = {
    "plan": {"query": {"bool": {"must": [{"match": {"title": "fox red"}}],
                                "should": [{"term": {"tag": "a"}}]}},
             "size": 7},
    "plan_dense_factor": {"query": {"bool": {
        "must": [{"match": {"title": "fox"}}],
        "filter": [{"range": {"rank": {"gte": 10}}}]}}, "size": 5},
    "dense": {"query": {"match": {"title": "fox blue"}}, "size": 6,
              "sort": [{"rank": "desc"}]},
    "knn": {"knn": {"field": "v", "query_vector": [0.1, 0.2, 0.3, 0.4],
                    "k": 5, "num_candidates": 10}, "size": 5,
            "_source": False},
    "aggs": {"query": {"match": {"title": "fox"}}, "size": 3,
             "aggs": {"t": {"terms": {"field": "tag"}},
                      "m": {"avg": {"field": "rank"}}}},
}
# what each path launches, under the port's names: the reference's
# tracked kernels for the same body, plus the entries the port tracks
# inside them (stable_topk, the contribution kernel); a pure kNN body
# rides the KnnBatcher with or without profile
KERNELS = {
    "plan": {"plan_topk_batch", "stable_topk"},
    "plan_dense_factor": {"plan_topk", "plan_topk_batch", "stable_topk"},
    "dense": {"bm25_dense_scores_sorted", "gather_bm25_contrib",
              "masked_topk", "stable_topk"},
    "knn": {"knn_nominate_batch", "similarity_scores", "cosine_scores",
            "dot_scores", "stable_topk"},
    "aggs": {"bm25_dense_scores_sorted", "gather_bm25_contrib",
             "masked_topk", "stable_topk"},
}


# the reference's name of a port entry point, where they differ
NAMES = {"plan_topk_packed": "plan_topk"}


@pytest.mark.parametrize("kind", sorted(BODIES))
def test_profile_answers_the_same_hits(nodes, kind):
    jax_node, node = nodes
    body = BODIES[kind]
    plain = _search(node, body)
    prof = _search(node, {**body, "profile": True})
    shard = prof.pop("profile")["shards"][0]
    for r in (plain, prof):
        r.pop("took")
        r.pop("_headers")
    assert prof == plain
    _assert_invariant(shard)
    kernels = {k["kernel"] for k in shard["device"]["kernels"]}
    assert kernels == KERNELS[kind]
    assert kernels <= set(profile.KERNEL_ATTRIBUTION)
    if kind != "knn":
        size = body["size"]
        ref = _ref_search(jax_node, {**body, "profile": True,
                                     "size": size + 1})
        ref_kernels = {NAMES.get(k["kernel"], k["kernel"]) for k in
                       ref["profile"]["shards"][0]["device"]["kernels"]}
        assert ref_kernels <= kernels
        # the reference's float32 plan path may split a true tie
        assert_same_hits(prof, ref, size)
