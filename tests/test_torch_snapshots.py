"""Snapshot repositories, snapshot and restore, and SLM against the
reference, on the CPU.

The cases of the reference's tests/test_snapshots.py (snapshot, delete,
restore, search; incremental blobs; GC on delete; rename on restore; the
generation CAS; the repositories' persistence; several shards; SLM's
execution, retention and unique names; the REST flow; a restore's fresh
translog; the blob primitives, a snapshot's status and the integrity
check) run on both packages, each answer compared with the reference's,
with the fields that differ by construction masked (``MASKED``: uuids
and times; ``BYTES``: a status's byte counts, since each package
writes its own segment files). The ingest script-safety case belongs to the
ingest slice. The no-aliasing case runs through the port's device
cache: a restored index beside its live source holds device copies of
its own, under fresh segment names.

Departures, each held by a case here: a restore under a name outside
the port's index-name rule answers 400 ``invalid_index_name_exception``
where the reference answers 400 ``illegal_argument_exception``; the
cloud repository types answer a typed 400 naming the later slice.
"""

import os

import pytest

from elasticsearch_tpu.common import errors as jax_errors
from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.index.service import IndicesService as JaxIndices
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.repositories import blobstore as jax_blobstore
from elasticsearch_tpu.search.service import SearchService as JaxSearch
from elasticsearch_tpu.snapshots.slm import \
    SnapshotLifecycleService as JaxSlm
from elasticsearch_tpu_torch.common import errors as port_errors
from elasticsearch_tpu_torch.index.service import IndicesService
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.repositories import blobstore as port_blobstore
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.service import SearchService
from elasticsearch_tpu_torch.snapshots.slm import SnapshotLifecycleService

# the fields of a snapshot's answers that differ by construction
MASKED = ("uuid", "start_time_in_millis", "end_time_in_millis")
# a status's byte counts: each package writes its own segment files
BYTES = ("total_bytes", "uploaded_bytes", "skipped_bytes")


class Side:
    """One package's indices, repository and search."""

    def __init__(self, pkg, tmp_path):
        self.pkg = pkg
        root = tmp_path / pkg
        self.errors = jax_errors if pkg == "jax" else port_errors
        self.blobstore = jax_blobstore if pkg == "jax" else port_blobstore
        if pkg == "jax":
            self.indices = JaxIndices(str(root / "data"))
            self._search = JaxSearch(self.indices)
        else:
            self.indices = IndicesService(str(root / "data"))
            self._search = SearchService(DeviceSegmentCache("cpu"),
                                         self.indices)
        self.repo = self.blobstore.BlobStoreRepository("r",
                                                       str(root / "repo"))
        self.root = root

    def create(self, name, settings=None):
        return self.indices.create_index(name, settings)

    def has(self, name):
        return (self.indices.has(name) if self.pkg == "jax"
                else name in self.indices)

    def index(self, name):
        return self.indices.get(name)

    def search(self, name, body):
        return self._search.search(name, body)

    def repositories(self, name="node"):
        return self.blobstore.RepositoriesService(str(self.root / name))

    def slm(self, repos, name="node"):
        cls = JaxSlm if self.pkg == "jax" else SnapshotLifecycleService
        return cls(repos, self.indices, str(self.root / name))


@pytest.fixture(params=["jax", "port"])
def env(request, tmp_path):
    return Side(request.param, tmp_path)


@pytest.fixture
def both(tmp_path):
    return Side("jax", tmp_path), Side("port", tmp_path)


def _make_index(side, name="books", n=10):
    idx = side.create(name)
    for i in range(n):
        idx.index_doc(str(i), {"title": f"doc {i} quick fox", "n": i})
    idx.refresh()
    return idx


def masked(info, also=()):
    if isinstance(info, dict):
        return {k: masked(v, also) for k, v in info.items()
                if k not in MASKED and k not in also}
    if isinstance(info, list):
        return [masked(v, also) for v in info]
    return info


def hits(r):
    """Totals and the hits by (score desc, id): the order of ties is
    each package's own (the reference's top-k breaks them in its own
    order), the order by score is the answer's."""
    return (sorted((-round(h["_score"] or 0.0, 5), h["_id"])
                   for h in r["hits"]["hits"]), r["hits"]["total"])


# --------------------------------------- tests/test_snapshots.py:39-370


def test_snapshot_restore_roundtrip(both):
    answers = []
    for side in both:
        idx = _make_index(side)
        info = side.repo.snapshot("snap1", [idx])
        assert info["state"] == "SUCCESS"
        assert info["indices"] == ["books"]
        side.indices.delete_index("books")
        assert not side.has("books")
        result = side.repo.restore("snap1", side.indices)
        assert result["snapshot"]["indices"] == ["books"]
        r = side.search("books", {"query": {"match": {"title": "quick"}}})
        assert r["hits"]["total"]["value"] == 10
        t = side.search("books", {"query": {"term": {"n": 3}}})
        assert t["hits"]["hits"][0]["_source"]["title"] == "doc 3 quick fox"
        answers.append((masked(info), result, hits(r), hits(t)))
    assert answers[0] == answers[1]


def test_restore_existing_index_rejected(env):
    idx = _make_index(env)
    env.repo.snapshot("s", [idx])
    with pytest.raises(env.errors.ResourceAlreadyExistsException):
        env.repo.restore("s", env.indices)


def test_restore_with_rename(both):
    answers = []
    for side in both:
        idx = _make_index(side)
        side.repo.snapshot("s", [idx])
        side.repo.restore("s", side.indices, rename_pattern="books",
                          rename_replacement="books_restored")
        assert side.has("books_restored")
        r = side.search("books_restored", {"query": {"match_all": {}}})
        assert r["hits"]["total"]["value"] == 10
        answers.append(hits(r))
    assert answers[0] == answers[1]


def test_incremental_snapshots_share_blobs(both):
    listings = []
    for side in both:
        idx = _make_index(side)
        side.repo.snapshot("s1", [idx])
        container = os.path.join(side.repo.location, "indices", "books", "0")
        blobs_after_s1 = set(os.listdir(container))
        info = side.repo.snapshot("s2", [idx])
        assert set(os.listdir(container)) == blobs_after_s1
        status = side.repo.snapshot_status("s2")["stats"]
        assert status["uploaded_bytes"] == 0
        assert status["skipped_bytes"] == status["total_bytes"] > 0
        idx.index_doc("100", {"title": "new doc"})
        idx.refresh()
        side.repo.snapshot("s3", [idx])
        assert blobs_after_s1.issubset(set(os.listdir(container)))
        listings.append((len(blobs_after_s1), masked(info)))
    assert listings[0] == listings[1]


def test_delete_snapshot_gcs_unreferenced_blobs(both):
    answers = []
    for side in both:
        idx = _make_index(side)
        side.repo.snapshot("s1", [idx])
        idx.index_doc("100", {"title": "extra"})
        idx.refresh()
        idx.force_merge()
        side.repo.snapshot("s2", [idx])
        container = os.path.join(side.repo.location, "indices", "books", "0")
        all_blobs = set(os.listdir(container))
        side.repo.delete_snapshot("s1")
        remaining = set(os.listdir(container))
        assert remaining < all_blobs
        side.indices.delete_index("books")
        side.repo.restore("s2", side.indices)
        r = side.search("books", {"query": {"match_all": {}}})
        assert r["hits"]["total"]["value"] == 11
        answers.append((len(all_blobs), len(remaining), hits(r)))
    assert answers[0] == answers[1]


def test_snapshot_duplicate_name_rejected(env):
    idx = _make_index(env)
    env.repo.snapshot("s", [idx])
    with pytest.raises(env.errors.ResourceAlreadyExistsException):
        env.repo.snapshot("s", [idx])


def test_missing_snapshot_raises(env):
    with pytest.raises(env.blobstore.SnapshotMissingException):
        env.repo.get_snapshot("nope")
    with pytest.raises(env.blobstore.SnapshotMissingException):
        env.repo.delete_snapshot("nope")


def test_repository_generation_advances(env):
    idx = _make_index(env)
    assert env.repo.load_repository_data()["gen"] == -1
    env.repo.snapshot("a", [idx])
    assert env.repo.load_repository_data()["gen"] == 0
    env.repo.snapshot("b", [idx])
    assert env.repo.load_repository_data()["gen"] == 1
    assert sorted(env.repo.load_repository_data()["snapshots"]) == ["a", "b"]


def test_repositories_service_persistence(env):
    svc = env.repositories()
    svc.put_repository("backup", {"type": "fs", "settings": {
        "location": str(env.root / "repo2")}})
    svc2 = env.repositories()
    assert svc2.get_repository("backup") is not None
    assert "backup" in svc2.get_configs()
    svc2.delete_repository("backup")
    with pytest.raises(env.errors.ResourceNotFoundException):
        svc2.get_repository("backup")


def test_multi_shard_snapshot(both):
    answers = []
    for side in both:
        idx = side.create("sharded", {"index.number_of_shards": 3})
        for i in range(30):
            idx.index_doc(str(i), {"v": i})
        idx.refresh()
        info = side.repo.snapshot("s", [idx])
        side.indices.delete_index("sharded")
        side.repo.restore("s", side.indices)
        r = side.search("sharded", {"query": {"match_all": {}}, "size": 0})
        assert r["hits"]["total"]["value"] == 30
        per_shard = sorted(side.search("sharded", {
            "query": {"range": {"v": {"gte": 10}}}, "size": 30,
            "sort": ["v"]})["hits"]["hits"][i]["_id"] for i in range(20))
        answers.append((info["shards"], per_shard))
    assert answers[0] == answers[1]


def test_slm_policy_execute_and_retention(env):
    logs = env.create("logs")
    logs.index_doc("1", {"m": "x"})
    logs.refresh()
    repos = env.repositories()
    repos.put_repository("backup", {"type": "fs", "settings": {
        "location": str(env.root / "slmrepo")}})
    slm = env.slm(repos)
    slm.put_policy("daily", {
        "name": "<daily-{now/d}>", "repository": "backup",
        "config": {"indices": "logs"},
        "retention": {"max_count": 2}})
    r1 = slm.execute_policy("daily")
    assert r1["snapshot_name"].startswith("daily-")
    slm.put_policy("each", {"name": "<run-{now/d}>", "repository": "backup",
                            "config": {"indices": "logs"}})
    repo = repos.get_repository("backup")
    assert any(s["snapshot"].startswith("daily-")
               for s in repo.list_snapshots())
    slm2 = env.slm(repos)
    assert "daily" in slm2.get_policies()
    assert slm2.get_policies()["daily"]["policy"]["retention"] == {
        "max_count": 2}


def test_slm_retention_max_count(env):
    idx = env.create("logs")
    idx.index_doc("1", {"m": "x"})
    idx.refresh()
    repos = env.repositories()
    repos.put_repository("backup", {"type": "fs", "settings": {
        "location": str(env.root / "slmrepo")}})
    slm = env.slm(repos)
    repo = repos.get_repository("backup")
    for i in range(3):
        repo.snapshot(f"p-{i}", [idx], metadata={"policy": "p"})
    slm.put_policy("p", {"name": "<p-{now/d}>", "repository": "backup",
                         "config": {"indices": "logs"},
                         "retention": {"max_count": 2}})
    slm._apply_retention("p", slm._policies["p"], repo)
    names = [s["snapshot"] for s in repo.list_snapshots()]
    assert len(names) == 2
    assert "p-0" not in names


def test_slm_policy_missing_repository_rejected(env):
    slm = env.slm(env.repositories())
    with pytest.raises(env.errors.IllegalArgumentException):
        slm.put_policy("p", {})
    with pytest.raises(env.errors.ResourceNotFoundException):
        slm.put_policy("p", {"repository": "nope"})


def test_slm_same_day_reexecution_unique_names(env):
    idx = env.create("logs")
    idx.index_doc("1", {"m": "x"})
    idx.refresh()
    repos = env.repositories()
    repos.put_repository("b", {"type": "fs", "settings": {
        "location": str(env.root / "r")}})
    slm = env.slm(repos)
    slm.put_policy("p", {"name": "<p-{now/d}>", "repository": "b",
                         "config": {"indices": "logs"}})
    n1 = slm.execute_policy("p")["snapshot_name"]
    n2 = slm.execute_policy("p")["snapshot_name"]
    assert n1 != n2


def test_restore_rename_to_invalid_name_rejected(env):
    """Both refuse it with a 400; the port's type is its index-name
    rule's (the one ``PUT /{index}`` answers)."""
    idx = _make_index(env)
    env.repo.snapshot("s", [idx])
    want = (env.errors.IllegalArgumentException if env.pkg == "jax"
            else env.errors.InvalidIndexNameException)
    with pytest.raises(want) as e:
        env.repo.restore("s", env.indices, rename_pattern="books",
                         rename_replacement="_restored")
    assert e.value.status == 400
    assert not env.has("_restored")


def test_upload_shard_blob_dedups_by_content(env):
    first = env.repo.upload_shard_blob("ix", 0, b"segment bytes")
    assert first["uploaded"] is True
    again = env.repo.upload_shard_blob("ix", 0, b"segment bytes")
    assert again == {"blob": first["blob"], "uploaded": False,
                     "size": len(b"segment bytes")}


def test_delete_shard_blobs_abort_cleanup(env):
    keep = env.repo.upload_shard_blob("ix", 0, b"keep me")
    drop = env.repo.upload_shard_blob("ix", 0, b"drop me")
    dropped = env.repo.delete_shard_blobs(
        "ix", 0, [drop["blob"], drop["blob"], "__never-uploaded"])
    assert dropped == 1
    container = env.repo.shard_container("ix", 0)
    assert container.blob_exists(keep["blob"])
    assert not container.blob_exists(drop["blob"])


def test_finalize_snapshot_status_and_integrity(env):
    up = env.repo.upload_shard_blob("ix", 0, b"abc")
    snap_indices = {"ix": {"shards": [{
        "segments": {"_0": {"f0": up["blob"]}},
        "total_bytes": 3, "uploaded_bytes": 3, "skipped_bytes": 0,
        "translog": {"ops": 2, "blob": None},
    }]}}
    info = env.repo.finalize_snapshot("s", "uuid-1", snap_indices,
                                      start_ms=10, end_ms=20)
    assert info["state"] == "SUCCESS"
    assert info["start_time_in_millis"] == 10
    assert info["shards"] == {"total": 1, "failed": 0, "successful": 1}
    status = env.repo.snapshot_status("s")
    assert status["stats"] == {"total_bytes": 3, "uploaded_bytes": 3,
                               "skipped_bytes": 0, "file_count": 1}
    row = status["indices"]["ix"]["shards"]["0"]
    assert row["stage"] == "DONE"
    assert row["translog_ops"] == 2
    assert env.repo.verify_integrity() == []
    env.repo.shard_container("ix", 0).delete_blob(up["blob"])
    assert [(p["kind"], p["resource"]) for p in
            env.repo.verify_integrity()] == [
        ("missing_blob", f"s/ix/0/{up['blob']}")]
    env.repo.root.write_blob("index.latest", b"7")
    assert [p["kind"] for p in env.repo.verify_integrity()] == \
        ["generation_mismatch"]


def test_truncated_snapshot_metadata_is_named(both):
    """A truncated ``snap-{name}.json`` is a corrupted blob, named."""
    problems = []
    for side in both:
        idx = _make_index(side)
        side.repo.snapshot("s", [idx])
        path = os.path.join(side.repo.location, "snap-s.json")
        with open(path, "r+b") as fh:
            fh.truncate(os.path.getsize(path) // 2)
        found = side.repo.verify_integrity()
        assert [(p["kind"], p["resource"]) for p in found] == [
            ("corrupted_blob", "snap-s.json")]
        problems.append([(p["kind"], p["resource"]) for p in found])
    assert problems[0] == problems[1]


# ------------------------------------------------ the nodes' REST flows


class Pair:
    def __init__(self, tmp_path):
        self.tmp = tmp_path
        self.jax = JaxNode(Settings.EMPTY, data_path=str(tmp_path / "ref"))
        self.port = Node(device="cpu", data_path=str(tmp_path / "port"))

    def nodes(self):
        return (("jax", self.jax), ("port", self.port))

    def close(self):
        self.port.close()
        self.jax.close()

    def each(self, method, path, params=None, body=None, expect=200):
        out = []
        for _, node in self.nodes():
            st, r = node.rest_controller.dispatch(method, path,
                                                  dict(params or {}), body)
            assert st == expect, f"{method} {path} -> {st}: {r}"
            out.append(r)
        return out

    def repo(self, name="backup"):
        for pkg, node in self.nodes():
            st, r = node.rest_controller.dispatch(
                "PUT", f"/_snapshot/{name}", {}, {"type": "fs", "settings": {
                    "location": str(self.tmp / f"{name}-{pkg}")}})
            assert st == 200, r


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def test_rest_snapshot_flow(pair):
    pair.each("PUT", "/idx/_doc/1", {"refresh": "true"}, {"a": 1},
              expect=201)
    pair.repo()
    j, p = pair.each("GET", "/_snapshot/backup")
    assert j["backup"]["type"] == p["backup"]["type"] == "fs"
    j, p = pair.each("PUT", "/_snapshot/backup/snap1")
    assert p["snapshot"]["state"] == "SUCCESS"
    assert masked(j) == masked(p)
    j, p = pair.each("GET", "/_snapshot/backup/_all")
    assert [s["snapshot"] for s in p["snapshots"]] == ["snap1"]
    assert masked(j) == masked(p)
    j, p = pair.each("GET", "/_snapshot/backup/snap1/_status")
    assert masked(j, BYTES) == masked(p, BYTES)
    assert p["snapshots"][0]["stats"]["uploaded_bytes"] == \
        p["snapshots"][0]["stats"]["total_bytes"] > 0
    for _, node in pair.nodes():
        st, cat = node.rest_controller.dispatch(
            "GET", "/_cat/snapshots/backup", {}, None)
        assert cat["_cat"].split()[:2] == ["snap1", "SUCCESS"]
        assert cat["_cat"].split()[-4:] == ["1", "1", "0", "1"]
        st, cat = node.rest_controller.dispatch(
            "GET", "/_cat/repositories", {}, None)
        assert cat["_cat"] == "backup fs"
    pair.each("DELETE", "/idx")
    j, p = pair.each("POST", "/_snapshot/backup/snap1/_restore")
    assert j == p
    j, p = pair.each("GET", "/idx/_doc/1")
    assert j["found"] is p["found"] is True
    assert j["_source"] == p["_source"]
    pair.each("DELETE", "/_snapshot/backup/snap1")
    j, p = pair.each("GET", "/_snapshot/backup/snap1", expect=404)
    pair.each("DELETE", "/_snapshot/backup")
    j, p = pair.each("GET", "/_snapshot/backup", expect=404)
    assert j["error"]["type"] == p["error"]["type"]


def test_rest_snapshot_in_the_background(pair):
    """``wait_for_completion=false``: accepted with a task id; the task's
    stored result is the snapshot answer."""
    pair.each("PUT", "/idx/_doc/1", {"refresh": "true"}, {"a": 1},
              expect=201)
    pair.repo()
    j, p = pair.each("PUT", "/_snapshot/backup/bg",
                     {"wait_for_completion": "false"})
    assert j["accepted"] is p["accepted"] is True
    task = p["task"]
    th = [t for t in pair.port._threads]
    for t in th:
        t.join(30)
    st, r = pair.port.rest_controller.dispatch("GET", f"/_tasks/{task}", {},
                                               None)
    assert st == 200 and r["completed"] is True
    assert r["response"]["snapshot"]["state"] == "SUCCESS"
    assert r["response"]["snapshot"]["indices"] == ["idx"]


def test_restore_resets_translog_generation(tmp_path):
    """Post-restore writes survive a restart on both nodes."""
    for pkg in ("jax", "port"):
        path = str(tmp_path / pkg / "node")
        node = (JaxNode(Settings.EMPTY, data_path=path) if pkg == "jax"
                else Node(device="cpu", data_path=path))
        c = node.rest_controller
        c.dispatch("PUT", "/src/_doc/1", {"refresh": "true"}, {"a": 1})
        c.dispatch("POST", "/src/_flush", {}, None)
        c.dispatch("PUT", "/src/_doc/2", {"refresh": "true"}, {"a": 2})
        c.dispatch("POST", "/src/_flush", {}, None)
        c.dispatch("PUT", "/_snapshot/b", {}, {
            "type": "fs", "settings": {"location": str(tmp_path / pkg
                                                       / "repo")}})
        c.dispatch("PUT", "/_snapshot/b/s", {}, {"indices": "src"})
        st, _ = c.dispatch("POST", "/_snapshot/b/s/_restore", {}, {
            "rename_pattern": "src", "rename_replacement": "dst"})
        assert st == 200
        status, _ = c.dispatch("PUT", "/dst/_doc/3", {}, {"a": 3})
        assert status == 201
        node.close()
        node2 = (JaxNode(Settings.EMPTY, data_path=path) if pkg == "jax"
                 else Node(device="cpu", data_path=path))
        _, doc = node2.rest_controller.dispatch("GET", "/dst/_doc/3", {},
                                                None)
        assert doc["found"] is True, pkg
        node2.close()


def test_restore_beside_live_source_no_device_aliasing(tmp_path):
    """On the port's node: the restored copy's segments have fresh names
    and device copies of their own; a delete in the source changes only
    the source's answers; the hbm breaker holds both copies' bytes."""
    node = Node(device="cpu", data_path=str(tmp_path / "n"))
    try:
        c = node.rest_controller
        for i in range(10):
            c.dispatch("PUT", f"/books/_doc/{i}", {}, {
                "title": f"doc {i} quick fox", "n": i})
        c.dispatch("POST", "/books/_refresh", {}, None)
        c.dispatch("POST", "/books/_search", {}, {"query": {"match": {
            "title": "quick"}}})
        c.dispatch("PUT", "/_snapshot/r", {}, {"type": "fs", "settings": {
            "location": str(tmp_path / "repo")}})
        c.dispatch("PUT", "/_snapshot/r/s", {}, {"indices": "books"})
        st, _ = c.dispatch("POST", "/_snapshot/r/s/_restore", {}, {
            "rename_pattern": "books", "rename_replacement": "copy"})
        assert st == 200
        src = set(node.indices["books"].segment_names())
        dst = set(node.indices["copy"].segment_names())
        assert src and dst and not (src & dst)
        st, r = c.dispatch("POST", "/copy/_search", {}, {"query": {"match": {
            "title": "quick"}}, "size": 10})
        assert r["hits"]["total"]["value"] == 10
        devs = {n: node.device_cache.resident(n) for n in src | dst}
        assert all(d is not None for d in devs.values())
        assert len({id(d) for d in devs.values()}) == len(devs)
        assert node.breaker_service.get_breaker("hbm").used == \
            node.device_cache.hbm_stats()["total_bytes"]
        c.dispatch("DELETE", "/books/_doc/0", {}, None)
        c.dispatch("POST", "/books/_refresh", {}, None)
        st, r = c.dispatch("POST", "/copy/_search", {}, {"size": 0})
        assert r["hits"]["total"]["value"] == 10
        st, r = c.dispatch("POST", "/books/_search", {}, {"size": 0})
        assert r["hits"]["total"]["value"] == 9
    finally:
        node.close()


def test_cloud_repository_types_are_a_typed_400(tmp_path):
    node = Node(device="cpu", data_path=str(tmp_path / "n"))
    try:
        for rtype in ("s3", "gcs", "azure", "hdfs"):
            st, r = node.rest_controller.dispatch(
                "PUT", "/_snapshot/cloud", {}, {"type": rtype,
                                                "settings": {}})
            assert st == 400
            assert r["error"]["type"] == "unsupported_in_slice_exception"
            assert rtype in r["error"]["reason"]
        st, r = node.rest_controller.dispatch(
            "PUT", "/_snapshot/bad", {}, {"type": "nope", "settings": {}})
        assert st == 500 and r["error"]["type"] == "repository_exception"
    finally:
        node.close()


def test_repository_integrity_red_on_a_missing_blob(pair):
    pair.each("PUT", "/idx/_doc/1", {"refresh": "true"}, {"a": 1},
              expect=201)
    pair.repo()
    pair.each("PUT", "/_snapshot/backup/s1")
    reports = []
    for pkg, node in pair.nodes():
        st, r = node.rest_controller.dispatch(
            "GET", "/_health_report/repository_integrity", {}, None)
        assert r["indicators"]["repository_integrity"]["status"] == "green"
        container = os.path.join(str(pair.tmp / f"backup-{pkg}"), "indices",
                                 "idx", "0")
        blob = sorted(os.listdir(container))[0]
        os.remove(os.path.join(container, blob))
        st, r = node.rest_controller.dispatch(
            "GET", "/_health_report/repository_integrity", {}, None)
        ind = r["indicators"]["repository_integrity"]
        assert ind["status"] == "red"
        assert ind["diagnosis"][0]["affected_resources"] == [
            f"backup:s1/idx/0/{blob}"]
        reports.append((ind["symptom"], ind["impacts"]))
    assert reports[0] == reports[1]
