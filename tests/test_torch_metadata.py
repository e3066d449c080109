"""Index metadata against the reference: every case of
tests/test_metadata.py (aliases, templates, rollover, shrink and split,
data streams, persistence), test_operational.py's close and open cases
and the alias and template cases of the YAML suite
50_aliases_templates.yml, each request sent to the reference's Node and
to the port's ``Node(device="cpu")`` on data paths of their own:
statuses, bodies and error types equal (``took`` and the reference's
``_headers`` aside). Also: a resized index's ids, ``_version`` and
``_seq_no`` against the reference's, an index auto-created by a write
taking its template, and the front leaving a closed index."""

import json

import pytest

from elasticsearch_tpu.common.errors import (
    IllegalArgumentException as JaxIllegalArgument,
    ResourceAlreadyExistsException as JaxAlreadyExists)
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException, ResourceAlreadyExistsException)
from elasticsearch_tpu_torch.node import Node


def strip(resp):
    """The answer without ``took``, the reference's trace header and
    the clock's ``creation_date``."""
    if isinstance(resp, dict):
        return {k: strip(v) for k, v in resp.items()
                if k not in ("took", "_headers", "creation_date")}
    if isinstance(resp, list):
        return [strip(v) for v in resp]
    return resp


_SHARD_COUNTS = ("/_refresh", "/_flush", "/_forcemerge")


def same_hits(got, ref, rtol=1e-5):
    """Equal answers but for the plan path's float32 noise: scores
    within ``rtol`` position by position, and the hits of a run of
    scores that agree within it equal as sets (their order may differ,
    as it does between shards of other statistics)."""
    gh, rh = got["hits"]["hits"], ref["hits"]["hits"]
    assert {k: v for k, v in got["hits"].items() if k not in (
        "hits", "max_score")} == {k: v for k, v in ref["hits"].items()
                                  if k not in ("hits", "max_score")}
    assert {k: v for k, v in got.items() if k != "hits"} == \
        {k: v for k, v in ref.items() if k != "hits"}
    assert len(gh) == len(rh)
    key = [h.get("_score") or 0.0 for h in rh]
    for g, r in zip(gh, rh):
        assert abs((g.get("_score") or 0.0) - (r.get("_score") or 0.0)) \
            <= rtol * abs(r.get("_score") or 1.0)
    i = 0
    while i < len(rh):
        j = i + 1
        while j < len(rh) and abs(key[j] - key[i]) <= rtol * abs(key[i]):
            j += 1
        strip_score = [lambda h: json.dumps(
            {k: v for k, v in h.items() if k != "_score"}, sort_keys=True)]
        assert sorted(map(strip_score[0], gh[i:j])) == \
            sorted(map(strip_score[0], rh[i:j])), (i, j)
        i = j


class Pair:
    """The reference's node and the port's, each on a data path of its
    own under ``root``; ``d`` sends one request to both and holds the
    answers equal."""

    def __init__(self, root):
        self.jax = JaxNode(data_path=str(root / "jax"))
        self.port = Node(device="cpu", data_path=str(root / "port"))

    def both(self, method, path, params=None, body=None):
        out = []
        for n in (self.jax, self.port):
            st, r = n.rest_controller.dispatch(method, path,
                                               dict(params or {}), body)
            out.append((st, strip(r)))
        return out

    def d(self, method, path, params=None, body=None):
        (jst, ref), (st, got) = self.both(method, path, params, body)
        if path.endswith(_SHARD_COUNTS) and st == 200:
            # the port counts every shard in ``_shards``; the
            # reference answers {"successful": 1, "failed": 0}
            assert jst == 200, (method, path, ref)
        elif isinstance(got, dict) and isinstance(got.get("hits"), dict):
            assert st == jst, (method, path, body, got, ref)
            same_hits(got, ref)
        else:
            assert (st, got) == (jst, ref), (method, path, body)
        return st, got

    def raises(self, fn_jax, fn_port, jexc, pexc):
        with pytest.raises(jexc) as ji:
            fn_jax(self.jax)
        with pytest.raises(pexc) as pi:
            fn_port(self.port)
        assert str(pi.value) == str(ji.value)

    def shards(self, name):
        n = self.jax.indices_service.get(name).num_shards
        assert self.port.indices[name].num_shards == n
        return n

    def close(self):
        self.port.close()
        self.jax.close()


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


# ---------------------------------------------------------------- aliases

def test_alias_add_search_and_remove(pair):
    d = pair.d
    d("PUT", "/logs-1/_doc/1", {"refresh": "true"}, {"v": 1})
    d("PUT", "/logs-2/_doc/2", {"refresh": "true"}, {"v": 2})
    status, _ = d("POST", "/_aliases", body={"actions": [
        {"add": {"index": "logs-1", "alias": "logs"}},
        {"add": {"index": "logs-2", "alias": "logs"}}]})
    assert status == 200
    _, r = d("POST", "/logs/_search", body={"size": 10})
    assert r["hits"]["total"]["value"] == 2
    _, r = d("GET", "/_alias/logs")
    assert set(r) == {"logs-1", "logs-2"}
    d("POST", "/_aliases", body={"actions": [
        {"remove": {"index": "logs-1", "alias": "logs"}}]})
    _, r = d("POST", "/logs/_search", body={})
    assert r["hits"]["total"]["value"] == 1
    d("GET", "/_alias")
    d("GET", "/_alias/nope")


def test_alias_write_index_routing(pair):
    d = pair.d
    d("PUT", "/a-1", body={})
    d("PUT", "/a-2", body={})
    d("POST", "/_aliases", body={"actions": [
        {"add": {"index": "a-1", "alias": "a"}},
        {"add": {"index": "a-2", "alias": "a", "is_write_index": True}}]})
    d("PUT", "/a/_doc/1", {"refresh": "true"}, {"v": 1})
    _, doc = d("GET", "/a-2/_doc/1")
    assert doc["found"] is True
    d("GET", "/a-1/_doc/1")


def test_filtered_alias(pair):
    d = pair.d
    for i, team in enumerate(["red", "blue", "red"]):
        d("PUT", f"/events/_doc/{i}", {"refresh": "true"},
          {"team": team, "n": i})
    d("POST", "/_aliases", body={"actions": [
        {"add": {"index": "events", "alias": "red_events",
                 "filter": {"term": {"team.keyword": "red"}}}}]})
    _, r = d("POST", "/red_events/_search", body={})
    assert r["hits"]["total"]["value"] == 2
    _, r = d("POST", "/red_events/_search",
             body={"query": {"range": {"n": {"gte": 1}}}})
    assert r["hits"]["total"]["value"] == 1
    _, r = d("POST", "/red_events/_explain/1", body={"query": {
        "match_all": {}}})
    assert r["matched"] is False


def test_alias_per_index_endpoint(pair):
    d = pair.d
    d("PUT", "/i1", body={})
    d("PUT", "/i1/_alias/al", body={})
    _, r = d("GET", "/i1/_alias")
    assert "al" in r["i1"]["aliases"]
    d("GET", "/i1/_alias/al")
    d("DELETE", "/i1/_alias/al")
    _, r = d("GET", "/i1/_alias")
    assert r["i1"]["aliases"] == {}
    d("PUT", "/i1/_aliases/al2", body={"is_write_index": True})
    d("DELETE", "/i1/_aliases/al2")
    d("GET", "/nope/_alias")


def test_alias_name_collision_rejected(pair):
    pair.d("PUT", "/real", body={})
    pair.d("PUT", "/other", body={})
    actions = [{"add": {"index": "other", "alias": "real"}}]
    pair.raises(lambda n: n.metadata_service.update_aliases(actions),
                lambda n: n.metadata_service.update_aliases(actions),
                JaxIllegalArgument, IllegalArgumentException)
    pair.d("POST", "/_aliases", body={"actions": actions})


def test_alias_batch_is_atomic(pair):
    """A batch whose second action fails leaves the aliases as they
    were."""
    d = pair.d
    d("PUT", "/b1", body={})
    d("POST", "/_aliases", body={"actions": [
        {"add": {"index": "b1", "alias": "ok"}},
        {"add": {"index": "missing", "alias": "bad"}}]})
    _, r = d("GET", "/_alias")
    assert r == {}
    d("POST", "/_aliases", body={"actions": [{"frob": {"index": "b1"}}]})
    d("POST", "/_aliases", body={"actions": [{"add": {"index": "b1"}}]})


# --------------------------------------------------------------- templates

def test_index_template_applied_on_create(pair):
    d = pair.d
    d("PUT", "/_component_template/base", body={"template": {
        "settings": {"index.number_of_shards": 2},
        "mappings": {"properties": {"ts": {"type": "date"}}}}})
    d("PUT", "/_index_template/logs", body={
        "index_patterns": ["logs-*"], "composed_of": ["base"],
        "priority": 10,
        "template": {"mappings": {
            "properties": {"level": {"type": "keyword"}}}}})
    # the first write auto-creates the index with the template
    d("PUT", "/logs-app/_doc/1", {"refresh": "true"},
      {"level": "info", "msg": "x"})
    assert pair.shards("logs-app") == 2
    _, mapping = d("GET", "/logs-app/_mapping")
    props = mapping["logs-app"]["mappings"]["properties"]
    assert props["ts"]["type"] == "date"
    assert props["level"]["type"] == "keyword"
    d("GET", "/_component_template/base")
    d("GET", "/_component_template")
    d("GET", "/_component_template/nope")
    d("PUT", "/_component_template/bad", body={"settings": {}})
    d("PUT", "/_index_template/bad", body={"index_patterns": ["q-*"],
                                           "composed_of": ["nope"]})


def test_template_priority(pair):
    d = pair.d
    d("PUT", "/_index_template/low", body={
        "index_patterns": ["x-*"], "priority": 1,
        "template": {"settings": {"index.number_of_shards": 1}}})
    d("PUT", "/_index_template/high", body={
        "index_patterns": ["x-special-*"], "priority": 100,
        "template": {"settings": {"index.number_of_shards": 3}}})
    d("PUT", "/x-special-1", body={})
    assert pair.shards("x-special-1") == 3
    d("PUT", "/x-plain", body={})
    assert pair.shards("x-plain") == 1


def test_request_body_overrides_template(pair):
    pair.d("PUT", "/_index_template/t", body={
        "index_patterns": ["y-*"],
        "template": {"settings": {"index.number_of_shards": 4}}})
    pair.d("PUT", "/y-1", body={"settings": {"index.number_of_shards": 1}})
    assert pair.shards("y-1") == 1


def test_template_crud(pair):
    d = pair.d
    d("PUT", "/_index_template/t", body={"index_patterns": ["z-*"]})
    _, r = d("GET", "/_index_template/t")
    assert r["index_templates"][0]["name"] == "t"
    d("DELETE", "/_index_template/t")
    status, _ = d("GET", "/_index_template")
    assert status == 200
    d("GET", "/_index_template/t")
    d("DELETE", "/_index_template/t")
    d("PUT", "/_index_template/none", body={})


def test_template_with_aliases(pair):
    pair.d("PUT", "/_index_template/t", body={
        "index_patterns": ["w-*"],
        "template": {"aliases": {"w_all": {}}}})
    pair.d("PUT", "/w-1", body={})
    _, r = pair.d("GET", "/_alias/w_all")
    assert "w-1" in r


# ---------------------------------------------------------------- rollover

def test_rollover_alias(pair):
    d = pair.d
    d("PUT", "/app-000001", body={})
    d("POST", "/_aliases", body={"actions": [
        {"add": {"index": "app-000001", "alias": "app",
                 "is_write_index": True}}]})
    for i in range(5):
        d("PUT", f"/app/_doc/{i}", {"refresh": "true"}, {"v": i})
    _, r = d("POST", "/app/_rollover", body={
        "conditions": {"max_docs": 100, "max_age": "7d",
                       "max_size": "5gb"}})
    assert r["rolled_over"] is False
    _, r = d("POST", "/app/_rollover", {"dry_run": "true"}, {
        "conditions": {"max_docs": 3}})
    assert r["rolled_over"] is False and r["dry_run"] is True
    _, r = d("POST", "/app/_rollover", body={
        "conditions": {"max_docs": 3}})
    assert r["rolled_over"] is True
    assert r["old_index"] == "app-000001"
    assert r["new_index"] == "app-000002"
    d("PUT", "/app/_doc/new", {"refresh": "true"}, {"v": 99})
    _, doc = d("GET", "/app-000002/_doc/new")
    assert doc["found"] is True
    _, r = d("POST", "/app/_search", body={"size": 0})
    assert r["hits"]["total"]["value"] == 6
    d("GET", "/_alias/app")
    d("POST", "/nope/_rollover", body={})


def test_rollover_requires_counted_name_or_new_index(pair):
    d = pair.d
    d("PUT", "/plain", body={})
    d("POST", "/_aliases", body={"actions": [
        {"add": {"index": "plain", "alias": "p", "is_write_index": True}}]})
    pair.raises(lambda n: n.metadata_service.rollover("p", {}),
                lambda n: n.metadata_service.rollover("p", {}),
                JaxIllegalArgument, IllegalArgumentException)
    _, r = d("POST", "/p/_rollover/plain-next", body={})
    assert r["new_index"] == "plain-next"


# ------------------------------------------------------------ shrink/split

def test_shrink_and_split(pair):
    d = pair.d
    d("PUT", "/big", body={"settings": {"index.number_of_shards": 4}})
    for i in range(40):
        d("PUT", f"/big/_doc/{i}", {}, {"n": i})
    d("POST", "/big/_refresh")
    _, r = d("PUT", "/big/_shrink/small", body={
        "settings": {"index.number_of_shards": 1}})
    assert r["acknowledged"] is True
    assert pair.shards("small") == 1
    _, r = d("POST", "/small/_search", body={"size": 0})
    assert r["hits"]["total"]["value"] == 40
    d("PUT", "/small/_split/wide", body={
        "settings": {"index.number_of_shards": 3}})
    assert pair.shards("wide") == 3
    _, r = d("POST", "/wide/_search", body={"size": 0})
    assert r["hits"]["total"]["value"] == 40
    d("PUT", "/wide/_clone/wide2", body={})
    assert pair.shards("wide2") == 3
    d("PUT", "/wide/_clone/bad", body={
        "settings": {"index.number_of_shards": 2}})
    d("PUT", "/big/_split/bad", body={
        "settings": {"index.number_of_shards": 2}})


def test_shrink_more_shards_rejected(pair):
    pair.d("PUT", "/src2", body={"settings": {"index.number_of_shards": 2}})
    status, _ = pair.d("PUT", "/src2/_shrink/dst2",
                       body={"settings": {"index.number_of_shards": 4}})
    assert status == 400


@pytest.mark.parametrize("mode,shards", [("clone", 2), ("split", 4),
                                         ("shrink", 1)])
def test_resize_keeps_ids_versions_and_seq_nos(pair, mode, shards):
    """Every doc of the target answers ``_mget`` with the reference's
    ``_version`` and ``_seq_no`` (the re-index order: segment by
    segment, docid order), a sort walk equal in ids and sort values,
    and a block asked for lands after the copy."""
    d = pair.d
    d("PUT", "/rs", body={"settings": {"index.number_of_shards": 2},
                          "mappings": {"properties": {
                              "t": {"type": "text"}, "n": {"type": "long"}}}})
    lines = "".join(json.dumps(x) + "\n" for i in range(60) for x in (
        {"index": {"_id": f"d{i}"}}, {"t": f"word{i % 7} x", "n": i}))
    d("POST", "/rs/_bulk", {"refresh": "true"}, lines)
    d("DELETE", "/rs/_doc/d5")
    d("PUT", "/rs/_doc/d6", {}, {"t": "changed", "n": 6})   # unrefreshed
    d("PUT", f"/rs/_{mode}/rt", body={"settings": {
        "index.number_of_shards": shards, "index.blocks.write": True}})
    assert pair.shards("rt") == shards
    d("POST", "/rt/_mget", body={"ids": [f"d{i}" for i in range(60)]})
    d("POST", "/rt/_search", body={"sort": [{"n": "asc"}], "size": 100,
                                   "version": True,
                                   "seq_no_primary_term": True})
    d("POST", "/rt/_search", body={"query": {"match": {"t": "word3"}}})
    d("PUT", "/rt/_doc/new", {}, {"n": 1})
    d("GET", "/rt/_settings")
    # an unblocked target goes on writing with the reference's numbers
    d("PUT", f"/rs/_{mode}/ru", body={"settings": {
        "index.number_of_shards": shards}})
    d("PUT", "/ru/_doc/new", {}, {"t": "fresh", "n": 100})
    d("POST", "/ru/_update/d7", {}, {"doc": {"n": 700}})
    d("DELETE", "/ru/_doc/d8")
    d("POST", "/ru/_mget", body={"ids": ["new", "d7", "d8", "d9"]})
    d("POST", "/ru/_refresh")
    d("POST", "/ru/_search", body={"sort": [{"n": "desc"}], "size": 5,
                                   "version": True,
                                   "seq_no_primary_term": True})


def test_resize_routes_join_children_by_parent(pair):
    """A join child lands on its parent's shard of the target, as the
    reference's re-index routes it: a split's children answer a GET
    routed by the parent and a has_child query as the reference."""
    d = pair.d
    d("PUT", "/qa", body={"settings": {"index.number_of_shards": 2},
                          "mappings": {"properties": {
                              "t": {"type": "text"},
                              "rel": {"type": "join",
                                      "relations": {"q": "a"}}}}})
    lines = []
    for i in range(12):
        lines += [{"index": {"_id": f"q{i}"}},
                  {"t": f"question {i}", "rel": "q"}]
        for j in range(2):
            lines += [{"index": {"_id": f"a{i}-{j}", "routing": f"q{i}"}},
                      {"t": f"answer {j}",
                       "rel": {"name": "a", "parent": f"q{i}"}}]
    d("POST", "/qa/_bulk", {"refresh": "true"},
      "".join(json.dumps(x) + "\n" for x in lines))
    d("PUT", "/qa/_split/qa4", body={"settings": {
        "index.number_of_shards": 4}})
    for i in (0, 5, 11):
        d("GET", f"/qa4/_doc/a{i}-1", {"routing": f"q{i}"})
    d("POST", "/qa4/_search", body={"query": {"has_child": {
        "type": "a", "query": {"match": {"t": "answer"}}}}, "size": 20})


def test_resize_includes_unrefreshed_docs(pair):
    d = pair.d
    d("PUT", "/fresh", body={})
    for i in range(5):
        d("PUT", f"/fresh/_doc/{i}", {}, {"n": i})
    d("PUT", "/fresh/_shrink/fresh2", body={})
    _, r = d("POST", "/fresh2/_search", body={"size": 0})
    assert r["hits"]["total"]["value"] == 5


# ------------------------------------------------------------ data streams

def test_data_stream_lifecycle(pair):
    d = pair.d
    d("PUT", "/_index_template/metrics", body={
        "index_patterns": ["metrics-*"], "data_stream": {},
        "template": {"mappings": {
            "properties": {"value": {"type": "double"}}}}})
    status, _ = d("PUT", "/_data_stream/metrics-cpu")
    assert status == 200
    _, r = d("GET", "/_data_stream/metrics-cpu")
    ds = r["data_streams"][0]
    assert ds["generation"] == 1
    backing = ds["indices"][0]["index_name"]
    assert backing.startswith(".ds-metrics-cpu-")
    d("PUT", "/metrics-cpu/_doc/1", {"refresh": "true"},
      {"@timestamp": "2026-01-01T00:00:00Z", "value": 0.5})
    _, r = d("POST", "/metrics-cpu/_search", body={})
    assert r["hits"]["total"]["value"] == 1
    _, r = d("POST", "/metrics-cpu/_rollover", body={})
    assert r["rolled_over"] is True
    _, r = d("GET", "/_data_stream/metrics-cpu")
    assert r["data_streams"][0]["generation"] == 2
    assert len(r["data_streams"][0]["indices"]) == 2
    d("POST", "/_bulk", {}, "".join(json.dumps(x) + "\n" for x in (
        {"create": {"_index": "metrics-cpu", "_id": "2"}},
        {"@timestamp": "2026-01-02T00:00:00Z", "value": 0.7})))
    d("POST", "/metrics-cpu/_refresh")
    _, r = d("POST", "/metrics-cpu/_search", body={"size": 0})
    assert r["hits"]["total"]["value"] == 2
    d("GET", "/_data_stream")
    d("DELETE", "/_data_stream/metrics-cpu")
    assert backing not in pair.port.indices
    assert not pair.jax.indices_service.has(backing)
    d("DELETE", "/_data_stream/metrics-cpu")


def test_data_stream_requires_template(pair):
    pair.raises(lambda n: n.metadata_service.create_data_stream("unmatched"),
                lambda n: n.metadata_service.create_data_stream("unmatched"),
                JaxIllegalArgument, IllegalArgumentException)
    pair.d("PUT", "/_data_stream/unmatched")


def test_data_stream_duplicate_rejected(pair):
    pair.d("PUT", "/_index_template/t", body={
        "index_patterns": ["s-*"], "data_stream": {}})
    pair.d("PUT", "/_data_stream/s-1")
    pair.raises(lambda n: n.metadata_service.create_data_stream("s-1"),
                lambda n: n.metadata_service.create_data_stream("s-1"),
                JaxAlreadyExists, ResourceAlreadyExistsException)
    pair.d("PUT", "/_data_stream/s-1")


# ------------------------------------------------------------- persistence

def test_metadata_persists_across_restart(tmp_path):
    p1 = Pair(tmp_path)
    p1.d("PUT", "/idx", body={})
    p1.d("POST", "/_aliases", body={"actions": [
        {"add": {"index": "idx", "alias": "al"}}]})
    p1.d("PUT", "/_index_template/t", body={"index_patterns": ["q-*"]})
    p1.d("PUT", "/_scripts/s", body={"script": {"source": "_score * 2"}})
    p1.close()
    for name in ("_metadata.json", "_scripts.json"):
        with open(tmp_path / "jax" / name, "rb") as fh:
            want = fh.read()
        with open(tmp_path / "port" / name, "rb") as fh:
            assert fh.read() == want, name
    p2 = Pair(tmp_path)
    try:
        assert "al" in p2.port.metadata_service.aliases
        assert "t" in p2.port.metadata_service.index_templates
        _, r = p2.d("POST", "/al/_search", body={})
        assert r["hits"]["total"]["value"] == 0
        p2.d("GET", "/_scripts/s")
    finally:
        p2.close()


# ----------------------------------------------- review regression tests

def test_delete_index_cleans_alias_and_stream_refs(pair):
    d = pair.d
    d("PUT", "/m-1", body={})
    d("PUT", "/m-2", body={})
    d("POST", "/_aliases", body={"actions": [
        {"add": {"index": "m-1", "alias": "m"}},
        {"add": {"index": "m-2", "alias": "m"}}]})
    d("DELETE", "/m-1")
    _, r = d("POST", "/m/_search", body={})
    assert r["hits"]["total"]["value"] == 0
    assert "m-1" not in pair.port.metadata_service.aliases["m"]


def test_count_and_msearch_apply_alias_filter(pair):
    d = pair.d
    for i, team in enumerate(["red", "blue", "red"]):
        d("PUT", f"/ev/_doc/{i}", {"refresh": "true"}, {"team": team})
    d("POST", "/_aliases", body={"actions": [
        {"add": {"index": "ev", "alias": "red_ev",
                 "filter": {"term": {"team.keyword": "red"}}}}]})
    _, r = d("GET", "/red_ev/_count")
    assert r["count"] == 2
    _, r = d("POST", "/_msearch", body=[{"index": "red_ev"}, {"size": 0}])
    assert r["responses"][0]["hits"]["total"]["value"] == 2


def test_doc_apis_resolve_alias(pair):
    d = pair.d
    d("PUT", "/w-1", body={})
    d("POST", "/_aliases", body={"actions": [
        {"add": {"index": "w-1", "alias": "w", "is_write_index": True}}]})
    d("PUT", "/w/_doc/1", {"refresh": "true"}, {"v": 1})
    _, doc = d("GET", "/w/_doc/1")
    assert doc["found"] is True
    d("GET", "/w/_source/1")
    status, _ = d("POST", "/w/_update/1", body={"doc": {"v": 2}})
    assert status == 200
    status, _ = d("DELETE", "/w/_doc/1")
    assert status == 200


def test_create_index_colliding_with_alias_rejected(pair):
    pair.d("PUT", "/backing", body={})
    pair.d("POST", "/_aliases", body={"actions": [
        {"add": {"index": "backing", "alias": "taken"}}]})
    status, _ = pair.d("PUT", "/taken", body={})
    assert status == 400


def test_alias_remove_must_exist(pair):
    pair.d("PUT", "/i9", body={})
    status, _ = pair.d("POST", "/_aliases", body={"actions": [
        {"remove": {"index": "i9", "alias": "missing",
                    "must_exist": True}}]})
    assert status == 404
    status, _ = pair.d("POST", "/_aliases", body={"actions": [
        {"remove": {"index": "i9", "alias": "missing"}}]})
    assert status == 200


def test_wildcard_matches_aliases_and_streams(pair):
    d = pair.d
    d("PUT", "/app-a", body={})
    d("POST", "/_aliases", body={"actions": [
        {"add": {"index": "app-a", "alias": "logsalias"}}]})
    d("PUT", "/app-a/_doc/1", {"refresh": "true"}, {"v": 1})
    _, r = d("POST", "/logsal*/_search", body={"size": 0})
    assert r["hits"]["total"]["value"] == 1
    d("PUT", "/_index_template/t", body={
        "index_patterns": ["str-*"], "data_stream": {}})
    d("PUT", "/_data_stream/str-one")
    d("PUT", "/str-one/_doc/1", {"refresh": "true"},
      {"@timestamp": "2026-01-01T00:00:00Z"})
    _, r = d("POST", "/str-*/_search", body={"size": 0})
    assert r["hits"]["total"]["value"] == 1


# ---------------------------------------- close, open, blocks (operational)

def _seed(pair, name="idx", n=3):
    pair.d("PUT", f"/{name}", body={"mappings": {"properties": {
        "v": {"type": "long"}}}})
    pair.d("POST", f"/{name}/_bulk", {"refresh": "true"}, "".join(
        json.dumps(x) + "\n" for i in range(n)
        for x in ({"index": {"_id": str(i)}}, {"v": i})))


def test_close_open_index(pair):
    d = pair.d
    _seed(pair)
    d("POST", "/idx/_close")
    status, r = d("POST", "/idx/_search", body={"size": 1})
    assert status == 400 and "closed" in str(r)
    status, r = d("PUT", "/idx/_doc/9", body={"v": 9})
    assert status == 403
    _, r = d("POST", "/_search", body={"size": 10})
    assert r["hits"]["total"]["value"] == 0
    d("POST", "/idx/_count", body={})
    d("POST", "/idx/_open")
    _, r = d("POST", "/idx/_search", body={"size": 10})
    assert r["hits"]["total"]["value"] == 3


def test_closed_index_admin_operations(pair):
    d = pair.d
    _seed(pair)
    d("POST", "/idx/_close")
    d("GET", "/idx/_mapping")
    d("GET", "/idx/_settings")
    d("GET", "/idx")
    d("POST", "/idx/_close")               # idempotent
    status, _ = d("GET", "/idx/_doc/0")
    assert status == 400
    d("POST", "/idx/_refresh")
    d("PUT", "/idx/_settings", body={"index.refresh_interval": "1s"})
    d("DELETE", "/idx")
    assert "idx" not in pair.port.indices


def test_open_all(pair):
    _seed(pair, "a1")
    _seed(pair, "a2")
    pair.d("POST", "/a1/_close")
    pair.d("POST", "/a2/_close")
    pair.d("POST", "/_all/_open")
    assert not pair.port.indices["a1"].is_closed
    assert not pair.port.indices["a2"].is_closed


@pytest.mark.parametrize("block,write_status", [
    ("write", 403), ("read_only", 403), ("read", 201), ("metadata", 201)])
def test_index_blocks(pair, block, write_status):
    """``index.blocks.write`` and ``read_only`` refuse writes; ``read``
    and ``metadata`` refuse nothing, as in the reference."""
    _seed(pair)
    pair.d("PUT", f"/idx/_block/{block}")
    status, _ = pair.d("PUT", "/idx/_doc/9", body={"v": 9})
    assert status == write_status
    pair.d("POST", "/idx/_search", body={"size": 5})
    pair.d("PUT", "/idx/_block/other")


def test_closed_index_leaves_the_device(pair):
    """A closed index keeps no device copy; a search after ``_open``
    uploads it again."""
    _seed(pair)
    node = pair.port
    pair.d("POST", "/idx/_search", body={"size": 3})
    names = node.indices["idx"].segment_names()
    assert any(node.device_cache.resident(n) for n in names)
    pair.d("POST", "/idx/_close")
    assert not any(node.device_cache.resident(n) for n in names)
    pair.d("POST", "/idx/_open")
    pair.d("POST", "/idx/_search", body={"size": 3})
    assert any(node.device_cache.resident(n) for n in names)


# ---------------------------------- the YAML suite 50_aliases_templates.yml

@pytest.mark.parametrize("case", ["index template applies on auto-create",
                                  "aliases route reads and writes"])
def test_yaml_aliases_templates_cases(tmp_path, case):
    """The cases of 50_aliases_templates.yml, each request answered by
    both nodes alike and each of its assertions held."""
    from test_torch_search_contexts import run_yaml_cases
    run_yaml_cases(tmp_path, "50_aliases_templates.yml", [case])


def test_auto_created_index_takes_its_template(pair):
    """A `_bulk` item and a single-doc write to a missing index create
    it with the matching template (its shards, mappings and aliases)."""
    d = pair.d
    d("PUT", "/_index_template/t", body={
        "index_patterns": ["auto-*"], "template": {
            "settings": {"index.number_of_shards": 3},
            "mappings": {"properties": {"k": {"type": "keyword"}}},
            "aliases": {"autos": {}}}})
    d("POST", "/_bulk", {"refresh": "true"}, "".join(
        json.dumps(x) + "\n" for x in (
            {"index": {"_index": "auto-1", "_id": "1"}}, {"k": "a"},
            {"index": {"_index": "auto-2", "_id": "1"}}, {"k": "b"})))
    assert pair.shards("auto-1") == 3
    d("GET", "/auto-1/_mapping")
    _, r = d("POST", "/autos/_search", body={"size": 5})
    assert r["hits"]["total"]["value"] == 2


def test_a_closed_index_leaves_the_front(tmp_path):
    """Closing the front's registered index unregisters it with the C++
    front (its bodies then reach the fallback, which answers the
    reference's error); after ``_open`` it is registered again."""
    from test_torch_native_http import req as post_req
    node = Node(device="cpu", data_path=str(tmp_path / "f"))
    try:
        rest = node.rest_controller
        rest.dispatch("PUT", "/f", {}, {"mappings": {"properties": {
            "t": {"type": "text"}}}})
        rest.dispatch("POST", "/f/_bulk", {"refresh": "true"}, "".join(
            json.dumps(x) + "\n" for i in range(50)
            for x in ({"index": {"_id": str(i)}}, {"t": f"red fox {i}"})))
        port = node.start(0)
        body = {"query": {"match": {"t": "red"}}, "_source": False}
        st, r = post_req(port, "POST", "/f/_search", body)
        assert st == 200 and r["hits"]["total"]["value"] == 50
        fast0 = node.http_stats()["fast"]
        assert fast0 >= 1
        rest.dispatch("POST", "/f/_close", {}, None)
        st, r = post_req(port, "POST", "/f/_search", body)
        assert st == 400 and r["error"]["type"] == "index_closed_exception"
        assert node.http_stats()["fast"] == fast0
        rest.dispatch("POST", "/f/_open", {}, None)
        st, r = post_req(port, "POST", "/f/_search", body)
        assert st == 200 and r["hits"]["total"]["value"] == 50
        assert node.http_stats()["fast"] == fast0 + 1
    finally:
        node.close()
