"""Searchable snapshots against the reference, on the CPU.

The four cases of the reference's tests/test_searchable_snapshots.py
(a mount copies no data file and its first search materializes the
segments through the node's blob cache; a mounted index reopens lazily
after a restart; a flush before the first search keeps the deferred
segments in the commit; a second mount of the same snapshot is served
from the cache) run on both packages' nodes, answers compared. Then a
snapshot that the reference's node wrote restores and mounts in the
port's node, whose answers equal the reference's own: ids, order and
totals, scores within rtol 1e-5 (float32 sums in another order; atol
4 float32 ulps of the page's top score), the
order of tied scores each package's own (``assert_same_answer``). No
converter sits between the formats: both write the same files.
"""

import glob
import os

import numpy as np
import pytest

from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.node import Node

PKGS = ("jax", "port")


def make_node(pkg, path):
    return (JaxNode(Settings.EMPTY, data_path=path) if pkg == "jax"
            else Node(device="cpu", data_path=path))


@pytest.fixture(params=PKGS)
def node(request, tmp_path):
    n = make_node(request.param, str(tmp_path / "data"))
    n.pkg = request.param
    yield n
    n.close()


def call(node, method, path, body=None, expect=200, **params):
    status, r = node.rest_controller.dispatch(method, path, params, body)
    assert status == expect, r
    return r


def _snapshot_index(node, tmp_path, n_docs=30):
    call(node, "PUT", "/_snapshot/repo", {
        "type": "fs", "settings": {"location": str(tmp_path / "repo")}})
    call(node, "PUT", "/src", {"mappings": {"properties": {
        "t": {"type": "text"}, "n": {"type": "long"}}}})
    for i in range(n_docs):
        words = " ".join(f"w{(i * k) % 11}" for k in range(1, 1 + i % 5))
        call(node, "PUT", f"/src/_doc/{i}", {"t": f"alpha doc {i} {words}",
                                             "n": i}, expect=201)
    call(node, "POST", "/src/_refresh")
    call(node, "PUT", "/_snapshot/repo/s1", {"indices": "src"},
         wait_for_completion="true")


def data_files(shard_dir):
    return glob.glob(os.path.join(shard_dir, "*", "arrays.npz"))


def test_mount_is_lazy_then_searchable(node, tmp_path):
    _snapshot_index(node, tmp_path)
    call(node, "POST", "/_snapshot/repo/s1/_mount",
         {"index": "src", "renamed_index": "mounted"})
    shard_dir = os.path.join(node.data_path, "mounted", "0")
    assert os.path.exists(os.path.join(shard_dir, "snapshot_store.json"))
    assert data_files(shard_dir) == []
    # before its first search a mount's documents are still in the
    # repository: a realtime GET finds none, in both packages
    assert call(node, "GET", "/mounted/_doc/3", expect=404)["found"] \
        is False
    stats = call(node, "GET", "/_searchable_snapshots/stats")
    assert stats["indices"]["mounted"]["repository"] == "repo"
    misses0 = stats["shared_cache"]["misses"]
    r = call(node, "POST", "/mounted/_search",
             {"query": {"match": {"t": "alpha"}}, "size": 50})
    assert r["hits"]["total"]["value"] == 30
    assert data_files(shard_dir) != []
    stats = call(node, "GET", "/_searchable_snapshots/stats")
    assert stats["shared_cache"]["misses"] > misses0
    assert stats["shared_cache"]["bytes_fetched"] > 0
    st, err = node.rest_controller.dispatch(
        "PUT", "/mounted/_doc/99", None, {"t": "nope"})
    assert st == 403
    if node.pkg == "port":
        # mounted segments have names of their own, and reach the card
        # only at the first search
        src = set(node.indices["src"].segment_names())
        mounted = set(node.indices["mounted"].segment_names())
        assert mounted and not (src & mounted)
        assert all(node.device_cache.resident(n) is not None
                   for n in mounted)


def test_mounted_index_survives_restart_lazily(node, tmp_path):
    _snapshot_index(node, tmp_path)
    call(node, "POST", "/_snapshot/repo/s1/_mount",
         {"index": "src", "renamed_index": "m2"})
    data_path = node.data_path
    node.close()
    n2 = make_node(node.pkg, data_path)
    try:
        shard_dir = os.path.join(data_path, "m2", "0")
        assert data_files(shard_dir) == []
        r = call(n2, "POST", "/m2/_search",
                 {"query": {"match": {"t": "alpha"}}, "size": 50})
        assert r["hits"]["total"]["value"] == 30
        assert data_files(shard_dir) != []
    finally:
        n2.close()


def test_flush_before_search_keeps_deferred_segments(node, tmp_path):
    _snapshot_index(node, tmp_path)
    call(node, "POST", "/_snapshot/repo/s1/_mount",
         {"index": "src", "renamed_index": "mf"})
    call(node, "POST", "/mf/_flush")
    data_path = node.data_path
    node.close()
    n2 = make_node(node.pkg, data_path)
    try:
        r = call(n2, "POST", "/mf/_search",
                 {"query": {"match": {"t": "alpha"}}, "size": 50})
        assert r["hits"]["total"]["value"] == 30
    finally:
        n2.close()


def test_second_mount_hits_cache(node, tmp_path):
    _snapshot_index(node, tmp_path)
    call(node, "POST", "/_snapshot/repo/s1/_mount",
         {"index": "src", "renamed_index": "ma"})
    call(node, "POST", "/ma/_search", {"query": {"match_all": {}}})
    stats1 = call(node, "GET", "/_searchable_snapshots/stats")
    call(node, "POST", "/_snapshot/repo/s1/_mount",
         {"index": "src", "renamed_index": "mb"})
    call(node, "POST", "/mb/_search", {"query": {"match_all": {}}})
    stats2 = call(node, "GET", "/_searchable_snapshots/stats")
    assert stats2["shared_cache"]["hits"] > stats1["shared_cache"]["hits"]
    assert (stats2["shared_cache"]["misses"]
            == stats1["shared_cache"]["misses"])


def test_mount_answers_equal_on_both_nodes(tmp_path):
    answers = []
    for pkg in PKGS:
        n = make_node(pkg, str(tmp_path / pkg / "data"))
        try:
            _snapshot_index(n, tmp_path / pkg)
            r = call(n, "POST", "/_snapshot/repo/s1/_mount",
                     {"index": "src", "renamed_index": "mounted"})
            answers.append((r, [call(n, "POST", "/mounted/_search", b)
                                for b in BODIES]))
        finally:
            n.close()
    assert answers[0][0] == answers[1][0]
    for i, (j, p) in enumerate(zip(answers[0][1], answers[1][1])):
        assert_same_answer(j, p, f"body {i}")


# ----------------------------- a snapshot the reference's node wrote

BODIES = [{"query": {"match": {"t": "alpha w3"}}, "size": 20},
          {"query": {"match": {"t": "w1 w7 w9"}}, "size": 10},
          {"query": {"bool": {"must": {"match": {"t": "w2"}},
                              "filter": {"range": {"n": {"gte": 10}}}}}},
          {"query": {"range": {"n": {"lt": 7}}}, "sort": [{"n": "desc"}]},
          {"query": {"term": {"n": 12}}}]


def assert_same_answer(j, p, what, rtol=1e-5):
    """``p`` (the port's) against ``j`` (the reference's): totals equal;
    sorted pages ids and order equal; scored pages scores rtol 1e-5 in
    order (atol 4 float32 ulps of the page's top score: a doc matching
    only a term of near-zero idf scores a few ulps of the sum's
    magnitude, summed in another order), and each run of tied scores
    (within that tolerance) the same ids, but the run at the page's end, which
    either package may cut apart."""
    assert p["hits"]["total"] == j["hits"]["total"], what
    jh, ph = j["hits"]["hits"], p["hits"]["hits"]
    assert len(ph) == len(jh), what
    if jh and jh[0]["_score"] is None:
        assert [h["_id"] for h in ph] == [h["_id"] for h in jh], what
        return
    js = np.asarray([h["_score"] for h in jh], np.float64)
    ps = np.asarray([h["_score"] for h in ph], np.float64)
    atol = 4 * float(np.finfo(np.float32).eps) * float(js.max(initial=0))
    np.testing.assert_allclose(ps, js, rtol=rtol, atol=atol, err_msg=what)
    start = 0
    for i in range(1, len(jh) + 1):
        if i < len(jh) and \
                abs(js[i] - js[start]) <= rtol * abs(js[start]) + atol:
            continue
        if i < len(jh):        # a run above the page's last one
            assert {h["_id"] for h in ph[start:i]} == \
                {h["_id"] for h in jh[start:i]}, (what, start, i)
        start = i


def test_reference_snapshot_restores_and_mounts_in_the_port(tmp_path):
    ref = JaxNode(Settings.EMPTY, data_path=str(tmp_path / "ref"))
    try:
        _snapshot_index(ref, tmp_path, n_docs=40)
        want = [call(ref, "POST", "/src/_search", b) for b in BODIES]
    finally:
        ref.close()
    port = Node(device="cpu", data_path=str(tmp_path / "port"))
    try:
        call(port, "PUT", "/_snapshot/repo", {
            "type": "fs", "settings": {"location": str(tmp_path / "repo")}})
        snaps = call(port, "GET", "/_snapshot/repo/_all")["snapshots"]
        assert [s["snapshot"] for s in snaps] == ["s1"]
        assert port.repositories_service.get_repository(
            "repo").verify_integrity() == []
        call(port, "POST", "/_snapshot/repo/s1/_restore",
             {"rename_pattern": "src", "rename_replacement": "restored"})
        call(port, "POST", "/_snapshot/repo/s1/_mount",
             {"index": "src", "renamed_index": "mounted"})
        for index in ("restored", "mounted"):
            for i, body in enumerate(BODIES):
                got = call(port, "POST", f"/{index}/_search", body)
                assert_same_answer(want[i], got, f"{index} body {i}")
        doc = call(port, "GET", "/restored/_doc/12")
        assert doc["_source"]["n"] == 12
        # the restored index takes writes; the mounted one refuses them
        call(port, "PUT", "/restored/_doc/99", {"t": "alpha new"},
             expect=201)
        st, _ = port.rest_controller.dispatch("PUT", "/mounted/_doc/99",
                                              {}, {"t": "nope"})
        assert st == 403
    finally:
        port.close()

