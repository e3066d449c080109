"""The document routes against the reference: every response of
``PUT|POST|GET|DELETE /{index}/_doc``, ``_create``, ``_update``,
``_source``, ``_mget``, ``_bulk`` (index, create, update and delete
items, items naming other indices, the pressure 429), the index admin
routes (``GET /{index}``, ``_mapping``, ``_settings``, ``DELETE``) and
the ``version``/``seq_no_primary_term`` search keys, asked of the
reference's Node and the port's ``Node(device="cpu")`` alike: statuses,
``_version``, ``_seq_no``, ``result``, error types and reasons equal,
``took`` aside. The near-real-time probe: an update or delete of a
refreshed document leaves the old copy searchable, and the new one
unseen, until ``_refresh``."""

import json
import os

import numpy as np
import pytest

from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.node import Node

MAPPINGS = {"properties": {"t": {"type": "text"}, "k": {"type": "keyword"},
                           "n": {"type": "long"}}}


def strip(resp):
    """The answer without ``took`` and the reference's trace header."""
    if isinstance(resp, dict):
        return {k: strip(v) for k, v in resp.items()
                if k not in ("took", "_headers")}
    if isinstance(resp, list):
        return [strip(v) for v in resp]
    return resp


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    jax_node = JaxNode(Settings.EMPTY,
                       data_path=str(tmp_path_factory.mktemp("docs")))
    node = Node(device="cpu")
    yield jax_node, node
    node.close()
    jax_node.close()


def both(nodes, method, path, params=None, body=None):
    """(reference, port) answers, each (status, body without took)."""
    out = []
    for n in nodes:
        st, r = n.rest_controller.dispatch(method, path, dict(params or {}),
                                           body)
        out.append((st, strip(r)))
    return out


def same(nodes, method, path, params=None, body=None):
    (jst, ref), (st, got) = both(nodes, method, path, params, body)
    assert (st, got) == (jst, ref), (method, path, params, body)
    return st, got


def ndjson(*objs):
    return "".join(json.dumps(o) + "\n" for o in objs)


def make_index(nodes, name, shards=1):
    same(nodes, "PUT", f"/{name}", body={
        "settings": {"index": {"number_of_shards": shards}},
        "mappings": MAPPINGS})


def docs(n, seed=0):
    rng = np.random.default_rng(seed)
    words = ["red", "fox", "blue", "whale", "green", "tree", "sky"]
    return [{"t": " ".join(rng.choice(words, 4)),
             "k": str(rng.choice(["a", "b", "c"])), "n": int(i)}
            for i in range(n)]


def bulk_lines(items):
    return ndjson(*[x for i, d in items
                    for x in ({"index": {"_id": i}}, d)])


# ------------------------------------------------------------ the NRT probe

@pytest.mark.parametrize("shards", [1, 3])
def test_nrt_old_copy_searchable_until_refresh(nodes, shards):
    """10 docs refreshed; a bulk without refresh deletes 3 and re-indexes
    4; a match search still answers 10 hits in both packages (the old
    copies), and after ``_refresh`` 9 with the new text."""
    name = f"nrt{shards}"
    make_index(nodes, name, shards)
    items = [(str(i), {"t": f"red fox {i}"}) for i in range(10)]
    for lines, params in ((bulk_lines(items), {"refresh": "true"}),
                          (ndjson({"delete": {"_id": "3"}},
                                  {"index": {"_id": "4"}},
                                  {"t": "red wolf"}), {})):
        for st, r in both(nodes, "POST", f"/{name}/_bulk", params, lines):
            assert st == 200 and not r["errors"], r
    body = {"query": {"match": {"t": "red"}}, "size": 20}
    (_, ref), (_, got) = both(nodes, "POST", f"/{name}/_search", {}, body)
    assert got["hits"]["total"]["value"] == \
        ref["hits"]["total"]["value"] == 10
    assert sorted(h["_id"] for h in got["hits"]["hits"]) == \
        sorted(h["_id"] for h in ref["hits"]["hits"])
    wolf = {"query": {"match": {"t": "wolf"}}}
    for _, r in both(nodes, "POST", f"/{name}/_search", {}, wolf):
        assert r["hits"]["total"]["value"] == 0
    for n in nodes:
        assert n.rest_controller.dispatch(
            "POST", f"/{name}/_refresh", {}, None)[0] == 200
    (_, ref), (_, got) = both(nodes, "POST", f"/{name}/_search", {}, body)
    assert got["hits"]["total"]["value"] == \
        ref["hits"]["total"]["value"] == 9
    for _, r in both(nodes, "POST", f"/{name}/_search", {}, wolf):
        assert [h["_id"] for h in r["hits"]["hits"]] == ["4"]
    # the bulk answers and a realtime GET as the reference's
    same(nodes, "POST", f"/{name}/_bulk", {}, ndjson(
        {"delete": {"_id": "5"}}, {"index": {"_id": "6"}}, {"t": "red"}))
    same(nodes, "GET", f"/{name}/_doc/5")
    same(nodes, "GET", f"/{name}/_doc/6")


def test_nrt_single_doc_routes(nodes):
    """The same rule through PUT, _update and DELETE of single docs."""
    make_index(nodes, "nrts")
    for i in range(4):
        same(nodes, "PUT", f"/nrts/_doc/{i}", {}, {"t": f"cat {i}"})
    for n in nodes:
        n.rest_controller.dispatch("POST", "/nrts/_refresh", {}, None)
    same(nodes, "PUT", "/nrts/_doc/0", {}, {"t": "dog"})
    same(nodes, "POST", "/nrts/_update/1", {}, {"doc": {"t": "dog"}})
    same(nodes, "DELETE", "/nrts/_doc/2")
    for q, want in (("cat", 4), ("dog", 0)):
        for _, r in both(nodes, "POST", "/nrts/_search", {},
                         {"query": {"match": {"t": q}}}):
            assert r["hits"]["total"]["value"] == want, q
    same(nodes, "PUT", "/nrts/_doc/3", {"refresh": "true"}, {"t": "dog"})
    for q, want in (("cat", 0), ("dog", 3)):
        for _, r in both(nodes, "POST", "/nrts/_search", {},
                         {"query": {"match": {"t": q}}}):
            assert r["hits"]["total"]["value"] == want, q


# --------------------------------------------------------- single documents

SCENARIOS = {
    "index_get_delete": [
        ("PUT", "/{i}/_doc/1", {}, {"t": "red fox", "n": 1}),
        ("GET", "/{i}/_doc/1", {}, None),
        ("PUT", "/{i}/_doc/1", {}, {"t": "blue fox", "n": 2}),
        ("GET", "/{i}/_doc/1", {}, None),
        ("GET", "/{i}/_source/1", {}, None),
        ("DELETE", "/{i}/_doc/1", {}, None),
        ("GET", "/{i}/_doc/1", {}, None),
        ("GET", "/{i}/_source/1", {}, None),
        ("DELETE", "/{i}/_doc/1", {}, None),
        ("PUT", "/{i}/_doc/1", {}, {"t": "back"}),
        ("GET", "/{i}/_doc/1", {}, None),
    ],
    "create_and_op_type": [
        ("PUT", "/{i}/_create/a", {}, {"t": "one"}),
        ("PUT", "/{i}/_create/a", {}, {"t": "two"}),
        ("POST", "/{i}/_create/b", {}, {"t": "three"}),
        ("PUT", "/{i}/_doc/a", {"op_type": "create"}, {"t": "four"}),
        ("PUT", "/{i}/_doc/c", {"op_type": "create"}, {"t": "five"}),
        ("GET", "/{i}/_doc/a", {}, None),
    ],
    "cas": [
        ("PUT", "/{i}/_doc/x", {}, {"n": 1}),
        ("PUT", "/{i}/_doc/x", {"if_seq_no": "0", "if_primary_term": "1"},
         {"n": 2}),
        ("PUT", "/{i}/_doc/x", {"if_seq_no": "0", "if_primary_term": "1"},
         {"n": 3}),
        ("PUT", "/{i}/_doc/x", {"if_seq_no": "1", "if_primary_term": "2"},
         {"n": 3}),
        ("PUT", "/{i}/_doc/y", {"if_seq_no": "0", "if_primary_term": "1"},
         {"n": 3}),
        ("GET", "/{i}/_doc/x", {}, None),
    ],
    "update_doc": [
        ("PUT", "/{i}/_doc/u", {}, {"t": "a", "obj": {"x": 1, "y": 2}}),
        ("POST", "/{i}/_update/u", {}, {"doc": {"obj": {"y": 3}}}),
        ("POST", "/{i}/_update/u", {}, {"doc": {"obj": {"y": 3}}}),
        ("POST", "/{i}/_update/u", {}, {"doc": {"obj": {"y": 3}},
                                        "detect_noop": False}),
        ("GET", "/{i}/_doc/u", {}, None),
        ("POST", "/{i}/_update/missing", {}, {"doc": {"t": "z"}}),
        ("POST", "/{i}/_update/new", {}, {"doc": {"t": "z"},
                                          "upsert": {"t": "up"}}),
        ("GET", "/{i}/_doc/new", {}, None),
        ("POST", "/{i}/_update/u", {}, {}),
    ],
    "update_script": [
        ("PUT", "/{i}/_doc/s", {}, {"n": 1, "tags": ["a"]}),
        ("POST", "/{i}/_update/s", {}, {"script": {
            "source": "ctx._source.n += params.by", "params": {"by": 4}}}),
        ("POST", "/{i}/_update/s", {}, {"script":
                                        "ctx._source.tags.add('b')"}),
        ("GET", "/{i}/_doc/s", {}, None),
        ("POST", "/{i}/_update/s", {}, {"script": "ctx.op = 'none'"}),
        ("POST", "/{i}/_update/s", {}, {"script": {
            "source": "if (ctx._source.n > 3) { ctx.op = 'delete' }"}}),
        ("GET", "/{i}/_doc/s", {}, None),
        ("POST", "/{i}/_update/s", {}, {"script": "ctx._source.n = 1"}),
    ],
    "auto_create_and_routing": [
        ("PUT", "/{i}/_doc/r1", {"routing": "k1"}, {"t": "routed"}),
        ("GET", "/{i}/_doc/r1", {"routing": "k1"}, None),
        ("DELETE", "/{i}/_doc/r1", {"routing": "k1"}, None),
        ("GET", "/{i}/_doc/r1", {"routing": "k1"}, None),
    ],
    "errors": [
        ("GET", "/nosuchindex/_doc/1", {}, None),
        ("PUT", "/{i}/_doc/bad", {}, {"n": "not a number"}),
        ("PUT", "/{i}/_doc/ok", {}, {"n": 5}),
        ("GET", "/{i}/_doc/ok", {}, None),
        ("DELETE", "/nosuchindex/_doc/1", {}, None),
    ],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_document_routes_answer_as_the_reference(nodes, scenario):
    index = f"d_{scenario}"
    if scenario != "auto_create_and_routing":
        make_index(nodes, index)
    for method, path, params, body in SCENARIOS[scenario]:
        same(nodes, method, path.format(i=index), params, body)
    same(nodes, "POST", f"/{index}/_mget", {},
         {"ids": ["1", "a", "x", "u", "s", "r1", "ok", "zz"]})


def test_mget_both_routes(nodes):
    make_index(nodes, "mg1")
    make_index(nodes, "mg2")
    same(nodes, "PUT", "/mg1/_doc/1", {}, {"t": "one"})
    same(nodes, "PUT", "/mg2/_doc/2", {}, {"t": "two"})
    same(nodes, "POST", "/_mget", {}, {"docs": [
        {"_index": "mg1", "_id": "1"}, {"_index": "mg2", "_id": "2"},
        {"_index": "mg2", "_id": "1"}]})
    same(nodes, "GET", "/mg1/_mget", {}, {
        "docs": [{"_id": "1"}, {"_index": "mg2", "_id": "2"}],
        "ids": ["1", "9"]})
    same(nodes, "POST", "/_mget", {}, {"docs": [
        {"_index": "nosuch", "_id": "1"}]})


# --------------------------------------------------------------------- bulk

def test_bulk_mixed_items(nodes):
    """index, create (and its 409), update by doc, script and upsert,
    delete (and not_found), an item naming another index (created on
    first write), a mapper failure, each with the reference's
    ``_version``, ``_seq_no``, ``result``, status and error."""
    make_index(nodes, "bk")
    same(nodes, "POST", "/bk/_bulk", {}, ndjson(
        {"index": {"_id": "1"}}, {"t": "a", "n": 1},
        {"create": {"_id": "1"}}, {"t": "b"},
        {"create": {"_id": "2"}}, {"t": "c", "n": 2},
        {"update": {"_id": "1"}}, {"doc": {"k": "x"}},
        {"update": {"_id": "2"}}, {"script": {"source":
                                              "ctx._source.n += 10"}},
        {"update": {"_id": "3"}}, {"doc": {"t": "d"},
                                   "upsert": {"t": "up"}},
        {"update": {"_id": "4"}}, {"doc": {"t": "e"}},
        {"delete": {"_id": "2"}},
        {"delete": {"_id": "nope"}},
        {"index": {"_index": "bk_other", "_id": "o1"}}, {"t": "elsewhere"},
        {"index": {"_id": "5"}}, {"n": "NaN-ish"},
        {"index": {"_id": "6"}}, {"t": "after the failure", "n": 6}))
    same(nodes, "POST", "/_bulk", {"refresh": "true"}, ndjson(
        {"index": {"_index": "bk", "_id": "7"}}, {"t": "seven"},
        {"delete": {"_index": "bk_other", "_id": "o1"}},
        {"index": {"_id": "8"}}, {"t": "no index"}))
    for index in ("bk", "bk_other"):
        same(nodes, "POST", f"/{index}/_search", {},
             {"query": {"match_all": {}}, "size": 20,
              "sort": [{"n": "asc"}], "version": True,
              "seq_no_primary_term": True})
    same(nodes, "GET", "/bk/_doc/1")
    same(nodes, "GET", "/bk/_doc/3")


def test_bulk_on_several_shards_keeps_per_shard_seq_nos(nodes):
    make_index(nodes, "bk3", shards=3)
    items = [(str(i), d) for i, d in enumerate(docs(30, seed=3))]
    same(nodes, "POST", "/bk3/_bulk", {}, bulk_lines(items))
    same(nodes, "POST", "/bk3/_bulk", {"refresh": "true"}, ndjson(
        *[x for i in range(0, 30, 4)
          for x in ({"update": {"_id": str(i)}}, {"doc": {"n": 100 + i}})]))
    same(nodes, "POST", "/bk3/_search", {},
         {"query": {"match_all": {}}, "sort": [{"n": "asc"}], "size": 30,
          "version": True, "seq_no_primary_term": True})


def test_bulk_pressure_rejects_with_429(tmp_path):
    """Past ``indexing_pressure.memory.limit`` a bulk answers the
    reference's retryable 429 before any write, and its bytes are
    released: a small bulk after it succeeds."""
    limit = {"indexing_pressure.memory.limit": "200b"}
    jax_node = JaxNode(Settings(limit), data_path=str(tmp_path / "j"))
    node = Node(device="cpu", settings=limit)
    pair = (jax_node, node)
    try:
        big = bulk_lines([(str(i), {"t": "x" * 20}) for i in range(10)])
        (jst, ref), (st, got) = both(pair, "POST", "/pr/_bulk", {}, big)
        assert st == jst == 429
        assert got == ref
        assert got["error"]["type"] == "es_rejected_execution_exception"
        for n in pair:
            st, _ = n.rest_controller.dispatch("GET", "/pr/_doc/1", {},
                                               None)
            assert st == 404
        small = ndjson({"index": {"_id": "1"}}, {"t": "y"})
        same(pair, "POST", "/pr/_bulk", {}, small)
        assert node.indexing_pressure.current_bytes() == 0
        assert node.indexing_pressure.rejections("coordinating") == 1
    finally:
        node.close()
        jax_node.close()


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, dirs, files in os.walk(root) for f in dirs + files)


@pytest.mark.parametrize("name", ["..", "../x", "../../somewhere", ".",
                                  "a/b", "a\\b", ".hidden"])
def test_index_names_stay_under_the_data_path(tmp_path, name):
    """A client's index name never reaches a path outside the data path:
    a write to it (the URL or a bulk item's ``_index``) is a 400
    ``invalid_index_name_exception`` and ``DELETE`` of it removes
    nothing, so every file beside the data path stays."""
    data = tmp_path / "data"
    (tmp_path / "keep").write_text("x")
    node = Node(device="cpu", data_path=str(data))
    try:
        before = _tree(tmp_path)
        rest = node.rest_controller
        if "/" not in name:
            st, r = rest.dispatch("PUT", f"/{name}/_doc/1", {}, {"t": "x"})
            assert st == 400
            assert r["error"]["type"] == "invalid_index_name_exception"
        st, r = rest.dispatch("POST", "/_bulk", {}, ndjson(
            {"index": {"_index": name, "_id": "1"}}, {"t": "x"}))
        assert st == 200 and r["errors"] is True
        item = r["items"][0]["index"]
        assert item["status"] == 400
        assert item["error"]["type"] == "invalid_index_name_exception"
        if "/" not in name:
            st, _ = rest.dispatch("DELETE", f"/{name}", {}, None)
            assert st == 404
        with pytest.raises(Exception) as info:
            node.create_index(name)
        assert getattr(info.value, "status", None) == 400
        assert name not in node.indices
        assert _tree(tmp_path) == before
        assert (tmp_path / "keep").read_text() == "x"
    finally:
        node.close()
    assert (tmp_path / "keep").exists()


def test_an_index_directory_that_links_elsewhere_is_refused(tmp_path):
    """A name that is a symbolic link under the data path resolves
    outside it: refused like a bad name, and the link's target kept."""
    data = tmp_path / "data"
    outside = tmp_path / "outside"
    outside.mkdir()
    (outside / "keep").write_text("x")
    node = Node(device="cpu", data_path=str(data))
    try:
        os.symlink(outside, data / "linked")
        st, r = node.rest_controller.dispatch("PUT", "/linked/_doc/1", {},
                                              {"t": "x"})
        assert st == 400
        assert r["error"]["type"] == "invalid_index_name_exception"
        assert sorted(os.listdir(outside)) == ["keep"]
    finally:
        node.close()


def test_bulk_pipeline_is_a_typed_400(nodes):
    st, r = nodes[1].rest_controller.dispatch(
        "POST", "/pp/_bulk", {"pipeline": "p"},
        ndjson({"index": {"_id": "1"}}, {"t": "x"}))
    assert st == 400
    assert r["error"]["type"] == "unsupported_in_slice_exception"
    st, r = nodes[1].rest_controller.dispatch(
        "PUT", "/pp/_doc/1", {"pipeline": "p"}, {"t": "x"})
    assert st == 400
    assert r["error"]["type"] == "unsupported_in_slice_exception"


# scripts the port's Painless interpreter does not parse, so both
# packages run them through the legacy expression translation
LEGACY_SCRIPTS = ["ctx._source.n = max(ctx._source.n, params.m)",
                  "ctx._source.s = str(ctx._source.n); "
                  "ctx._source.k = len(ctx._source.t)",
                  "ctx._source.n = round(ctx._source.n / 3)"]


@pytest.mark.parametrize("script", LEGACY_SCRIPTS)
def test_update_by_a_legacy_only_script(nodes, script):
    """An update script outside the Painless grammar the port parses
    takes the legacy translation in both packages, with the same
    answer and the same document after it."""
    from elasticsearch_tpu_torch.reindex.worker import UpdateScript
    assert not UpdateScript(script)._painless
    name = f"legacy{LEGACY_SCRIPTS.index(script)}"
    make_index(nodes, name)
    same(nodes, "PUT", f"/{name}/_doc/1", body={"t": "red fox", "n": 7})
    same(nodes, "POST", f"/{name}/_update/1", body={"script": {
        "source": script, "params": {"m": 11}}})
    st, got = same(nodes, "GET", f"/{name}/_doc/1")
    assert st == 200 and got["_version"] == 2


# ---------------------------------------------------------- index admin

def test_index_admin_routes(nodes):
    same(nodes, "PUT", "/adm", body={
        "settings": {"index": {"number_of_shards": 2}},
        "mappings": MAPPINGS})
    same(nodes, "PUT", "/adm/_doc/1", {"refresh": "true"},
         {"t": "x", "extra": 3, "when": "2024-01-02"})
    (_, ref), (_, got) = both(nodes, "GET", "/adm")
    for r in (ref, got):
        r["adm"]["settings"]["index"].pop("creation_date")
    assert got == ref
    same(nodes, "GET", "/adm/_mapping")
    same(nodes, "PUT", "/adm/_mapping", {},
         {"properties": {"added": {"type": "keyword"}}})
    same(nodes, "PUT", "/adm/_mapping", {},
         {"properties": {"t": {"type": "long"}}})
    same(nodes, "GET", "/adm/_mapping")
    same(nodes, "PUT", "/adm/_settings", {},
         {"index": {"number_of_shards": 3}})
    same(nodes, "PUT", "/adm/_settings", {},
         {"settings": {"index.refresh_interval": "5s"}})
    (_, ref), (_, got) = both(nodes, "GET", "/adm/_settings")
    for r in (ref, got):
        r["adm"]["settings"]["index"].pop("creation_date")
    assert got == ref
    (_, ref), (_, got) = both(nodes, "GET", "/adm/_stats")
    for key in ("docs", "segments", "shards"):
        assert got["indices"]["adm"][key] == ref["indices"]["adm"][key]
    same(nodes, "DELETE", "/adm")
    same(nodes, "GET", "/adm/_doc/1")
    same(nodes, "GET", "/adm")
    assert "adm" not in nodes[1].indices


def test_search_version_and_seq_no_keys(nodes):
    make_index(nodes, "vs")
    items = [(str(i), d) for i, d in enumerate(docs(12, seed=9))]
    same(nodes, "POST", "/vs/_bulk", {}, bulk_lines(items))
    same(nodes, "POST", "/vs/_bulk", {"refresh": "true"}, bulk_lines(
        items[:5]))
    for extra in ({"version": True}, {"seq_no_primary_term": True},
                  {"version": True, "seq_no_primary_term": True,
                   "_source": False}):
        (_, ref), (_, got) = both(nodes, "POST", "/vs/_search", {}, {
            "query": {"match_all": {}}, "size": 12,
            "sort": [{"n": "asc"}], **extra})
        assert got["hits"] == ref["hits"], extra


def test_a_refused_update_keeps_the_document(nodes):
    """A write the mapper refuses takes its seq_no in both packages (the
    next write's ``_seq_no`` agrees), but only the port keeps the
    document's current copy: the reference tombstones it before it
    parses (ROADMAP Queue 3, "A document the mapper refuses")."""
    make_index(nodes, "refused")
    same(nodes, "PUT", "/refused/_doc/1", {"refresh": "true"}, {"n": 1})
    same(nodes, "PUT", "/refused/_doc/1", {}, {"n": "not a number"})
    same(nodes, "PUT", "/refused/_doc/2", {}, {"n": 2})
    for n in nodes:
        assert n.rest_controller.dispatch(
            "POST", "/refused/_refresh", {}, None)[0] == 200
    (jst, ref), (st, got) = both(nodes, "GET", "/refused/_doc/1")
    assert (jst, ref["found"]) == (404, False)
    assert (st, got["found"], got["_source"], got["_version"],
            got["_seq_no"]) == (200, True, {"n": 1}, 1, 0)
    same(nodes, "GET", "/refused/_doc/2")
