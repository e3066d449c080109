"""Node telemetry on the card.

A ``Node(device="cuda")`` with a one-segment index ("one": its bare
``match`` bodies take the fast path's v2m lane) and a three-segment
index ("three": the dense executor and the plan path). A tenant-tagged,
traced dense body (``min_score`` and a terms aggregation) answers what
the untagged body answers (ids, order, float32 scores, totals); its
waterfall holds exactly the contribution-kernel launches the body made
(``gather_bm25_contrib.launches`` grows by as many) and its readbacks,
all under its ``rest.search`` root, charged to its tenant; the
``request`` breaker is back to 0 after it. A v2m cohort (a traced
``_source: true`` match on "one") holds the contribution and the merge
launches of its cohort in its waterfall, and answers what it answers
untagged.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.ops.merge import merge_sorted_slots

pytestmark = pytest.mark.cuda

DENSE = {"query": {"match": {"t": "w1 w2 w3"}}, "min_score": 0.01,
         "size": 50, "aggs": {"c": {"terms": {"field": "c"}}}}
FAST = {"query": {"match": {"t": "w4 w7"}}, "size": 20}


@pytest.fixture(scope="module")
def node(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of csrc/ run only on "
                    "the card")
    n = Node(device="cuda", data_path=str(tmp_path_factory.mktemp("t")))
    rng = np.random.default_rng(23)
    words = [f"w{i}" for i in range(60)]
    mappings = {"properties": {"t": {"type": "text"},
                               "c": {"type": "keyword"}}}
    for index, parts in (("one", 1), ("three", 3)):
        st, _ = n.rest_controller.dispatch("PUT", f"/{index}", {},
                                           {"mappings": mappings})
        assert st == 200
        for part in range(parts):
            lines = []
            for i in range(part * 4000, (part + 1) * 4000):
                lines += [{"index": {"_index": index, "_id": str(i)}},
                          {"t": " ".join(rng.choice(words, size=12)),
                           "c": f"c{i % 5}"}]
            st, r = n.rest_controller.dispatch("POST", "/_bulk",
                                               {"refresh": "true"}, lines)
            assert st == 200 and not r["errors"]
    assert len(n.indices["three"].engine.segments) == 3
    yield n
    n.close()


def _search(node, index, body, headers=None):
    st, r = node.rest_controller.dispatch("POST", f"/{index}/_search", {},
                                          dict(body), headers=headers)
    assert st == 200, r
    return r


def _hits(r):
    return ([h["_id"] for h in r["hits"]["hits"]],
            np.asarray([h["_score"] for h in r["hits"]["hits"]],
                       np.float32), r["hits"]["total"])


def test_traced_dense_body_on_the_card(node):
    plain = _search(node, "three", DENSE)
    torch.cuda.synchronize()
    l0 = gather_bm25_contrib.launches
    r = _search(node, "three", DENSE, headers={
        "X-Tenant-Id": "card-t", "X-Workload-Class": "aggs",
        "X-Opaque-Id": "op"})
    torch.cuda.synchronize()
    launched = gather_bm25_contrib.launches - l0
    assert launched == 3            # one a segment
    ids, scores, total = _hits(r)
    pids, pscores, ptotal = _hits(plain)
    assert ids == pids and total == ptotal
    np.testing.assert_array_equal(scores, pscores)
    assert r["aggregations"] == plain["aggregations"]
    tid = r["_headers"]["trace.id"]
    st, w = node.rest_controller.dispatch(
        "GET", f"/_flight_recorder/waterfall/{tid}")
    assert st == 200
    root = w["waterfall"][0]
    assert root["name"] == "rest.search"
    events = root["events"]
    contrib = [e for e in events if e.get("kernel") == "gather_bm25_contrib"]
    assert len(contrib) == launched
    assert [e["site"] for e in events if e["kind"] == "readback"].count(
        "search.searcher.agg_mask") == 3
    assert all(e["tenant"] == "card-t" and e["workload_class"] == "aggs"
               for e in events)
    assert [c["name"] for c in root["children"]] == ["shard[three][0]",
                                                     "fetch"]
    breakers = node.breaker_service.stats()
    assert breakers["request"]["estimated_size_in_bytes"] == 0
    tenants = node.telemetry.tenants.stats()["tenants"]
    assert tenants["card-t"]["search"]["count"] == 1
    assert tenants["card-t"]["device"]["readback_bytes"] > 0


def test_v2m_cohort_waterfall_holds_both_kernels(node):
    plain = _search(node, "one", FAST)
    torch.cuda.synchronize()
    c0, m0 = gather_bm25_contrib.launches, merge_sorted_slots.launches
    r = _search(node, "one", FAST, headers={"X-Tenant-Id": "fast-t"})
    torch.cuda.synchronize()
    assert gather_bm25_contrib.launches > c0
    assert merge_sorted_slots.launches > m0
    assert any(k.startswith("v2m") for k in
               node.fastpath.serving_stats()["dispatch"])
    ids, scores, total = _hits(r)
    pids, pscores, ptotal = _hits(plain)
    assert ids == pids and total == ptotal
    np.testing.assert_array_equal(scores, pscores)
    tid = r["_headers"]["trace.id"]
    st, w = node.rest_controller.dispatch(
        "GET", f"/_flight_recorder/waterfall/{tid}")
    assert st == 200
    kernels = [e.get("kernel") for e in w["waterfall"][0]["events"]]
    assert kernels.count("gather_bm25_contrib") == \
        gather_bm25_contrib.launches - c0
    assert kernels.count("merge_sorted_slots") == \
        merge_sorted_slots.launches - m0
    assert "search.fastpath.v2m_cohort" in [
        e.get("site") for e in w["waterfall"][0]["events"]]
