"""`_reindex`, `_update_by_query` and `_delete_by_query` against the
reference, on the CPU.

The reference's tests/test_reindex.py cases run on both nodes, each
against the same seeded documents: the ``BulkByScrollResponse`` counts
(total, created, updated, deleted, batches, noops, version conflicts,
failures' ids and statuses) and the resulting documents equal. A
background job (``wait_for_completion=false``) answers its counts
through ``GET /_tasks/{id}`` on both; ``_rethrottle`` of another node's
task is the reference's 404. The case that needs the client
(``test_reindex_from_remote``) asserts the port's typed 400 instead, as
does a destination ``pipeline``. Beyond them: a reindex that changes a field's analyzer
(corpus.py's analyzed index into one whose ``body`` is ``english`` with
a stop list), searched after on both nodes; the by-query family over one
term's documents of an analyzed index of 1 and 3 shards; slices,
``requests_per_second`` and an alias as the destination.

Tolerance: counts, ids and documents exact; scores rtol 1e-4 on the plan
path (tests/test_torch_node.py ``assert_same_hits``).
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import ScriptException as JaxScriptError
from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.reindex.worker import UpdateScript as JaxUpdateScript
from elasticsearch_tpu.reindex.worker import _Ctx as JaxCtx
from elasticsearch_tpu_torch.common.errors import ScriptException
from elasticsearch_tpu_torch.corpus import (ANALYSIS_MAPPINGS,
                                            ANALYSIS_SETTINGS, english_docs)
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.reindex.worker import UpdateScript, _Ctx
from test_torch_node import assert_same_hits

# the response keys that are the same on both nodes (``took`` and the
# throttle's sleep are the clock's)
COUNTS = ("total", "created", "updated", "deleted", "batches", "noops",
          "version_conflicts", "requests_per_second", "timed_out",
          "retries")


class Pair:
    """Both nodes, each request sent to both."""

    def __init__(self, tmp_path):
        self.jax = JaxNode(Settings.EMPTY, data_path=str(tmp_path / "data"))
        self.port = Node(device="cpu")

    def close(self):
        self.port.close()
        self.jax.close()

    def both(self, method, path, params=None, body=None):
        return (self.jax.rest_controller.dispatch(method, path,
                                                  dict(params or {}), body),
                self.port.rest_controller.dispatch(method, path,
                                                   dict(params or {}), body))

    def do(self, method, path, params=None, body=None, expect=200):
        """Both answers' bodies, after asserting both statuses."""
        (jst, j), (st, p) = self.both(method, path, params, body)
        assert jst == expect, f"{method} {path} -> {jst}: {j}"
        assert st == expect, f"{method} {path} -> {st}: {p}"
        return j, p

    def same_counts(self, method, path, params=None, body=None):
        """The port's BulkByScrollResponse, after asserting its counts
        and failures equal the reference's."""
        j, p = self.do(method, path, params, body)
        assert {k: p[k] for k in COUNTS} == {k: j[k] for k in COUNTS}
        assert [(f["id"], f["status"]) for f in p["failures"]] == \
            [(f["id"], f["status"]) for f in j["failures"]]
        return p

    def same_docs(self, index, ids):
        """Each id's GET equal on both nodes (found, version, source)."""
        for i in ids:
            (jst, j), (st, p) = self.both("GET", f"/{index}/_doc/{i}")
            assert st == jst, (i, j, p)
            keys = ("found", "_version", "_source")
            assert {k: p.get(k) for k in keys} == \
                {k: j.get(k) for k in keys}, i

    def same_search(self, index, body):
        size = int(body.get("size", 10))
        jst, want = self.jax.rest_controller.dispatch(
            "POST", f"/{index}/_search", {}, dict(body, size=size + 1))
        st, got = self.port.rest_controller.dispatch(
            "POST", f"/{index}/_search", {}, dict(body))
        assert st == jst == 200, (got, want)
        assert_same_hits(got, want, size, rtol=1e-4)
        return got


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def seed(pair, index="src", n=25, seed_=0):
    rng = np.random.default_rng(seed_)
    for i in range(n):
        (jst, _), (st, _) = pair.both("PUT", f"/{index}/_doc/{i}", None, {
            "title": f"doc {i}", "n": i, "w": int(rng.integers(1000)),
            "tag": "even" if i % 2 == 0 else "odd"})
        assert jst in (200, 201) and st == jst
    pair.do("POST", f"/{index}/_refresh")


# ------------------------------------------------ tests/test_reindex.py


def test_reindex_basic(pair):
    seed(pair)
    r = pair.same_counts("POST", "/_reindex", body={
        "source": {"index": "src"}, "dest": {"index": "dst"}})
    assert r["total"] == 25 and r["created"] == 25
    assert r["failures"] == []
    pair.do("POST", "/dst/_refresh")
    j, p = pair.do("GET", "/dst/_count")
    assert p["count"] == j["count"] == 25
    pair.same_docs("dst", range(25))


def test_reindex_with_query_and_max_docs(pair):
    seed(pair)
    r = pair.same_counts("POST", "/_reindex", body={
        "source": {"index": "src", "query": {"term": {"tag": "even"}}},
        "dest": {"index": "dst2"}, "max_docs": 5})
    assert r["total"] == 5
    pair.do("POST", "/dst2/_refresh")
    pair.same_docs("dst2", range(25))


def test_reindex_script_and_noop_delete(pair):
    seed(pair, n=10)
    r = pair.same_counts("POST", "/_reindex", body={
        "source": {"index": "src"},
        "dest": {"index": "dst3"},
        "script": {"source":
                   "if ctx._source.n > 7:\n    ctx.op = 'noop'\n"
                   "ctx._source.boosted = ctx._source.n * 2"},
    })
    assert r["noops"] == 2 and r["created"] == 8
    pair.do("POST", "/dst3/_refresh")
    j, p = pair.do("GET", "/dst3/_doc/3")
    assert p["_source"]["boosted"] == 6
    pair.same_docs("dst3", range(10))


def test_reindex_op_type_create_conflicts(pair):
    seed(pair, n=6)
    pair.same_counts("POST", "/_reindex", body={
        "source": {"index": "src"}, "dest": {"index": "dst4"}})
    r = pair.same_counts("POST", "/_reindex", body={
        "conflicts": "proceed",
        "source": {"index": "src"},
        "dest": {"index": "dst4", "op_type": "create"}})
    assert r["version_conflicts"] == 6 and r["created"] == 0
    r2 = pair.same_counts("POST", "/_reindex", body={
        "source": {"index": "src"},
        "dest": {"index": "dst4", "op_type": "create"}})
    assert r2["version_conflicts"] >= 1 and r2["failures"]


def test_update_by_query_script(pair):
    seed(pair, n=8)
    r = pair.same_counts("POST", "/src/_update_by_query",
                         params={"refresh": "true"},
                         body={"query": {"term": {"tag": "odd"}},
                               "script": {"source":
                                          "ctx._source.flagged = True"}})
    assert r["updated"] == 4
    j, p = pair.do("GET", "/src/_doc/1")
    assert p["_source"]["flagged"] is True
    j, p = pair.do("GET", "/src/_doc/2")
    assert "flagged" not in p["_source"]
    pair.same_docs("src", range(8))


def test_update_by_query_params_and_increment(pair):
    seed(pair, n=4)
    pair.same_counts("POST", "/src/_update_by_query",
                     params={"refresh": "true"},
                     body={"script": {"source": "ctx._source.n += params.step",
                                      "params": {"step": 100}}})
    j, p = pair.do("GET", "/src/_doc/2")
    assert p["_source"]["n"] == 102
    pair.same_docs("src", range(4))


def test_delete_by_query(pair):
    seed(pair, n=20)
    r = pair.same_counts("POST", "/src/_delete_by_query",
                         params={"refresh": "true"},
                         body={"query": {"range": {"n": {"gte": 10}}}})
    assert r["deleted"] == 10
    j, p = pair.do("GET", "/src/_count")
    assert p["count"] == j["count"] == 10
    pair.same_docs("src", range(20))


def test_script_string_literals_preserved():
    for script, ctx in ((UpdateScript, _Ctx), (JaxUpdateScript, JaxCtx)):
        s = script("ctx._source.tag = 'a && b; !c'")
        c = ctx({}, "i", "1", 1)
        s.run(c)
        assert c._source._data["tag"] == "a && b; !c"


def test_reindex_external_versioning(pair):
    seed(pair, n=3)
    pair.same_counts("POST", "/_reindex", body={
        "source": {"index": "src"},
        "dest": {"index": "dstv", "version_type": "external"}})
    pair.jax.indices_service.get("dstv").index_doc("1", {"n": 999})
    pair.port.indices["dstv"].index_doc("1", {"n": 999})
    r = pair.same_counts("POST", "/_reindex", body={
        "conflicts": "proceed",
        "source": {"index": "src"},
        "dest": {"index": "dstv", "version_type": "external"}})
    assert r["version_conflicts"] >= 1
    pair.same_docs("dstv", range(3))


def test_search_version_flag(pair):
    seed(pair, n=2)
    j, p = pair.do("POST", "/src/_search",
                   body={"version": True, "seq_no_primary_term": True})
    hit = p["hits"]["hits"][0]
    assert hit["_version"] == 1
    assert "_seq_no" in hit and "_primary_term" in hit
    want = {h["_id"]: h for h in j["hits"]["hits"]}
    for h in p["hits"]["hits"]:
        for k in ("_version", "_seq_no", "_primary_term"):
            assert h[k] == want[h["_id"]][k]


def test_reindex_background_task(pair):
    """``wait_for_completion=false`` runs the job as a background task:
    both nodes answer its id at once, and ``GET /_tasks/{id}`` (waiting
    for it) answers the completed job's counts, equal on both; the
    by-query routes do the same."""
    seed(pair, n=12)
    for path, body in (
            ("/_reindex", {"source": {"index": "src"},
                           "dest": {"index": "dstbg"}}),
            ("/src/_update_by_query", {"query": {"term": {"tag": "odd"}},
                                       "script": {"source":
                                                  "ctx._source.n += 100"}}),
            ("/src/_delete_by_query", {"query": {"term": {"tag": "even"}}})):
        j, p = pair.do("POST", path, {"wait_for_completion": "false"},
                       body)
        assert set(p) == set(j) == {"task"}
        done = pair.port.rest_controller.dispatch(
            "GET", f"/_tasks/{p['task']}", {"wait_for_completion": "true"},
            None)
        want = pair.jax.rest_controller.dispatch(
            "GET", f"/_tasks/{j['task']}", {"wait_for_completion": "true"},
            None)
        assert done[0] == want[0] == 200
        assert done[1]["completed"] is want[1]["completed"] is True
        got, ref = done[1]["response"], want[1]["response"]
        assert {k: got[k] for k in COUNTS} == {k: ref[k] for k in COUNTS}
    pair.do("POST", "/dstbg/_refresh")
    pair.do("POST", "/src/_refresh")
    pair.same_docs("dstbg", range(12))
    pair.same_docs("src", range(12))


@pytest.mark.parametrize("path", ["/_reindex/n1:7/_rethrottle",
                                  "/_update_by_query/n1:7/_rethrottle",
                                  "/_delete_by_query/n1:7/_rethrottle"])
def test_rethrottle_needs_the_task_manager(pair, path):
    """``_rethrottle`` reaches a running job through the task manager: a
    task id of another node is the reference's 404 on both nodes."""
    (jst, j), (st, r) = pair.both("POST", path,
                                  {"requests_per_second": "10"}, None)
    assert st == jst == 404
    assert r["error"]["type"] == j["error"]["type"] \
        == "resource_not_found_exception"


def test_update_script_sandbox():
    for script, ctx, err in ((UpdateScript, _Ctx, ScriptException),
                             (JaxUpdateScript, JaxCtx, JaxScriptError)):
        s = script("ctx._source.x = 1")
        c = ctx({"x": 0}, "i", "1", 1)
        s.run(c)
        assert c._source._data["x"] == 1
        for bad in ("__import__('os')", "open('/etc/passwd')",
                    "ctx.__class__"):
            with pytest.raises(err):
                script(bad)


def test_reindex_remove_field_script(pair):
    seed(pair, n=3)
    pair.same_counts("POST", "/_reindex", body={
        "source": {"index": "src"}, "dest": {"index": "dst5"},
        "script": {"source": "ctx._source.remove('tag')"}})
    pair.do("POST", "/dst5/_refresh")
    j, p = pair.do("GET", "/dst5/_doc/0")
    assert "tag" not in p["_source"]
    pair.same_docs("dst5", range(3))


def test_reindex_from_remote(pair):
    """A remote source needs the client of a later slice: a typed 400,
    with and without credentials."""
    seed(pair, n=3)
    for remote in ({"host": "http://127.0.0.1:9"},
                   {"host": "http://127.0.0.1:9", "username": "elastic",
                    "password": "x"}):
        st, r = pair.port.rest_controller.dispatch("POST", "/_reindex", None, {
            "source": {"remote": remote, "index": "src"},
            "dest": {"index": "copied"}})
        assert st == 400
        assert r["error"]["type"] == "unsupported_in_slice_exception"
        assert "copied" not in pair.port.indices


def test_dest_pipeline_is_a_typed_400(pair):
    seed(pair, n=2)
    st, r = pair.port.rest_controller.dispatch("POST", "/_reindex", None, {
        "source": {"index": "src"},
        "dest": {"index": "d", "pipeline": "p"}})
    assert st == 400
    assert r["error"]["type"] == "unsupported_in_slice_exception"


# -------------------------------------------------- analyzed indices


def _bulk(index, docs):
    return "".join(json.dumps({"index": {"_index": index, "_id": str(i)}})
                   + "\n" + json.dumps(d) + "\n" for i, d in enumerate(docs))


EN_STOP_MAPPINGS = {"properties": {
    "title": {"type": "text"},
    "body": {"type": "text", "analyzer": "en_stop"},
    "tags": {"type": "text", "analyzer": "whitespace"}}}
EN_STOP_SETTINGS = {"analysis": {
    "filter": {"more_stop": {"type": "stop",
                             "stopwords": ["run", "walk", "jump"]}},
    "analyzer": {"en_stop": {"type": "custom", "tokenizer": "standard",
                             "filter": ["lowercase", "stop", "more_stop",
                                        "porter_stem"]}}}}


def analyzed(pair, shards, n=300):
    docs = english_docs(n, np.random.default_rng(11))
    pair.do("PUT", "/an", body={
        "settings": {"index": dict(ANALYSIS_SETTINGS["index"],
                                   number_of_shards=shards)},
        "mappings": ANALYSIS_MAPPINGS})
    pair.do("POST", "/_bulk", {"refresh": "true"}, _bulk("an", docs))
    return docs


BODIES = [{"query": {"match": {"body": "running walks"}}, "size": 30},
          {"query": {"match": {"body.exact": "PowerShot real-time"}},
           "size": 30},
          {"query": {"match": {"tags": "jumpation"}}, "size": 30},
          {"query": {"match_phrase": {"body": "run the jump"}}}]


@pytest.mark.parametrize("shards", [1, 3])
def test_reindex_changes_the_analyzer(pair, shards):
    """`_reindex` into an index whose ``body`` analyzes with english and
    a stop list: the same documents and totals, and the destination's
    searches as the reference's."""
    docs = analyzed(pair, shards)
    pair.do("PUT", "/an_en", body={"settings": EN_STOP_SETTINGS,
                                   "mappings": EN_STOP_MAPPINGS})
    r = pair.same_counts("POST", "/_reindex", {"refresh": "true"}, {
        "source": {"index": "an", "size": 64}, "dest": {"index": "an_en"}})
    assert r["total"] == r["created"] == len(docs)
    assert r["batches"] == -(-len(docs) // 64)
    j, p = pair.do("GET", "/an_en/_count")
    assert p["count"] == j["count"] == len(docs)
    pair.same_docs("an_en", range(0, len(docs), 37))
    for body in BODIES:
        pair.same_search("an_en", body)
    # the stop list took "run" out of the english body
    got = pair.same_search("an_en", {"query": {"match": {"body": "run"}}})
    assert got["hits"]["total"]["value"] == 0


@pytest.mark.parametrize("shards", [1, 3])
def test_by_query_on_an_analyzed_index(pair, shards):
    """`_update_by_query` with a script over one term's documents, then
    `_delete_by_query` over another's: counts, documents and the
    searches after each `_refresh` as the reference's."""
    analyzed(pair, shards)
    q1 = {"match": {"body": "walking"}}
    r = pair.same_counts("POST", "/an/_update_by_query", {"refresh": "true"},
                         {"query": q1, "script": {
                             "source": "ctx._source.tags += ' touched'"}})
    assert r["updated"] > 0
    got = pair.same_search("an", {"query": {"match": {"tags": "touched"}},
                                  "size": 500})
    assert got["hits"]["total"]["value"] == r["updated"]
    ids = [h["_id"] for h in got["hits"]["hits"]]
    pair.same_docs("an", ids)
    q2 = {"match": {"body.exact": "powershot"}}
    r = pair.same_counts("POST", "/an/_delete_by_query", {"refresh": "true"},
                         {"query": q2})
    assert r["deleted"] > 0
    got = pair.same_search("an", {"query": q2})
    assert got["hits"]["total"]["value"] == 0
    for body in BODIES:
        pair.same_search("an", body)


def test_sliced_reindex_into_an_alias(pair):
    """``slices``/``slice_id`` keep the hits whose id hashes to the
    slice; the destination an alias resolves to its write index;
    ``requests_per_second`` paces without changing the counts."""
    seed(pair, n=40)
    pair.do("PUT", "/target")
    pair.do("PUT", "/target/_alias/al")
    total = 0
    for sid in range(3):
        r = pair.same_counts("POST", "/_reindex", {
            "slices": "3", "slice_id": str(sid),
            "requests_per_second": "100000"}, {
            "source": {"index": "src", "size": 7}, "dest": {"index": "al"}})
        total += r["created"]
    assert total == 40
    pair.do("POST", "/target/_refresh")
    pair.same_docs("target", range(40))


def test_delete_by_query_needs_a_query(pair):
    seed(pair, n=2)
    (jst, j), (st, p) = pair.both("POST", "/src/_delete_by_query", None, {})
    assert st == jst == 400
    assert p["error"]["type"] == j["error"]["type"]
    assert p["error"]["reason"] == j["error"]["reason"]


def test_reindex_needs_both_indices(pair):
    for body in ({"source": {"index": "src"}}, {"dest": {"index": "d"}}):
        (jst, j), (st, p) = pair.both("POST", "/_reindex", None, body)
        assert st == jst == 400
        assert p["error"]["reason"] == j["error"]["reason"]
