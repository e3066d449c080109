"""The search contexts against the reference: scroll (by score, by a
numeric and a keyword sort, on 1, 2 and 3 shards, across a refresh and a
force-merge between pages), sliced scroll, point in time, ``_count``,
the request cache, ``_explain``, ``_msearch`` and stored scripts, asked
of the reference's services and nodes and of the port's
(``Node(device="cpu")``, ``SearchService(DeviceSegmentCache("cpu"),
indices)``) on the same documents: ids, order, totals and sort values
exact, float32 scores rtol 1e-6 (every scroll page runs on the dense
executor in both). The reference's cases: test_search_service.py's
scroll, count and request-cache cases, test_rest_api.py's scroll,
count, msearch and scroll-total cases, test_search_features.py's
explain, keyword-sort scroll and sliced scroll, test_search_utils.py's
PIT and stored-script cases, and the PIT, sliced-scroll, bulk-count and
stored-script cases of the YAML suites. Also: the vectorised murmur3 bit
for bit against the scalar one, two nodes' stored scripts kept apart,
the device copies of segments a context outlived released with it, and
the C++ front bouncing ``pit`` and ``slice`` bodies."""

import json
import os
import random

import numpy as np
import pytest
import yaml

from elasticsearch_tpu.common.errors import (
    SearchContextMissingException as JaxContextMissing)
from elasticsearch_tpu.index.service import IndicesService as JaxIndices
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.search.service import SearchService as JaxSearch
from elasticsearch_tpu.testing.yaml_rest import YamlRestRunner
from elasticsearch_tpu_torch.common.errors import (
    SearchContextMissingException)
from elasticsearch_tpu_torch.index.mapper import (murmur3_hash,
                                                  murmur3_hash_array)
from elasticsearch_tpu_torch.index.service import IndicesService
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.service import (
    SearchService, resumable_scroll_batches)
from test_torch_metadata import _SHARD_COUNTS, same_hits

SUITES = os.path.join(os.path.dirname(__file__), "yaml_suites")
MAPPINGS = {"properties": {"title": {"type": "text"},
                           "tag": {"type": "keyword"},
                           "views": {"type": "long"}}}
WORDS = ["amber", "dune", "cedar", "fjord", "mesa", "krill", "lagoon",
         "harbor"]
# generated ids the two packages never share
_IDS = ("_scroll_id", "pit_id")


def strip(resp):
    if isinstance(resp, dict):
        return {k: strip(v) for k, v in resp.items()
                if k not in ("took", "_headers") + _IDS}
    if isinstance(resp, list):
        return [strip(v) for v in resp]
    return resp


def same_page(got, ref, what=""):
    """Equal answers but for float32 scores (rtol 1e-6)."""
    got, ref = strip(got), strip(ref)
    gh = got.get("hits", {}).pop("hits", [])
    rh = ref.get("hits", {}).pop("hits", [])
    assert got == ref, what
    assert [(h["_index"], h["_id"], h.get("sort")) for h in gh] == \
        [(h["_index"], h["_id"], h.get("sort")) for h in rh], what
    for g, r in zip(gh, rh):
        assert (g["_score"] is None) == (r["_score"] is None), what
        if g["_score"] is not None:
            np.testing.assert_allclose(g["_score"], r["_score"], rtol=1e-6)
        assert {k: v for k, v in g.items() if k != "_score"} == \
            {k: v for k, v in r.items() if k != "_score"}, what


# ------------------------------------------------ services of both packages

class Services:
    """Both packages' IndicesService and SearchService on data paths of
    their own; ``fill`` indexes the same documents into both."""

    def __init__(self, root):
        self.jax_indices = JaxIndices(str(root / "jax"))
        self.jax = JaxSearch(self.jax_indices)
        self.port_indices = IndicesService(str(root / "port"))
        self.port = SearchService(DeviceSegmentCache("cpu"),
                                  self.port_indices)

    def create(self, name, settings=None, mappings=MAPPINGS):
        return (self.jax_indices.create_index(name, settings, mappings),
                self.port_indices.create_index(name, settings, mappings))

    def fill(self, name="test", num_shards=2, n=20, docs=None):
        pair = self.create(name, {"index.number_of_shards": num_shards})
        docs = docs or [{
            "title": f"doc number {i} " + ("quick fox " * (i % 3)),
            "tag": "even" if i % 2 == 0 else "odd", "views": i}
            for i in range(n)]
        for idx in pair:
            for i, d in enumerate(docs):
                idx.index_doc(str(i), d)
            idx.refresh()
        return pair

    def close(self):
        self.jax_indices.close()
        self.port_indices.close()


@pytest.fixture()
def services(tmp_path):
    s = Services(tmp_path)
    yield s
    s.close()


def drain(search, first):
    """The first page and every page after it, until an empty one."""
    pages = [first]
    while pages[-1]["hits"]["hits"]:
        pages.append(search.scroll(first["_scroll_id"], scroll="1m"))
    return pages


# ------------------------------------- test_search_service.py's cases

def test_scroll_pages_through_everything(services):
    services.fill(n=17)
    body = {"sort": [{"views": "asc"}], "size": 5}
    jp = drain(services.jax, services.jax.search("test", body, scroll="1m"))
    pp = drain(services.port, services.port.search("test", body,
                                                   scroll="1m"))
    assert len(pp) == len(jp) == 5
    for g, r in zip(pp, jp):
        same_page(g, r)
    views = [h["_source"]["views"] for p in pp for h in p["hits"]["hits"]]
    assert views == list(range(17))
    sid = pp[0]["_scroll_id"]
    assert services.port.clear_scroll([sid]) == 1
    with pytest.raises(SearchContextMissingException) as pe:
        services.port.scroll(sid)
    with pytest.raises(JaxContextMissing) as je:
        services.jax.scroll(jp[0]["_scroll_id"] + "x")
    assert str(pe.value).replace(sid, "") == \
        str(je.value).replace(jp[0]["_scroll_id"] + "x", "")


def test_scroll_by_score(services):
    services.fill(n=12)
    body = {"query": {"match": {"title": "doc"}}, "size": 4}
    jp = drain(services.jax, services.jax.search("test", body, scroll="1m"))
    pp = drain(services.port, services.port.search("test", body,
                                                   scroll="1m"))
    for g, r in zip(pp, jp):
        same_page(g, r)
    ids = [h["_id"] for p in pp for h in p["hits"]["hits"]]
    assert len(ids) == len(set(ids)) == 12


def test_count(services):
    services.fill()
    body = {"query": {"term": {"tag": "even"}}}
    r = services.port.count("test", body)
    assert r == services.jax.count("test", body)
    assert r["count"] == 10


def test_shard_request_cache(tmp_path):
    """size-0 answers cache per (shard epochs, body); a refresh after a
    write misses; sized requests and request_cache false bypass it; a
    cached answer is a copy."""
    svc = Services(tmp_path)
    try:
        pair = svc.create("rc", {}, {"properties": {"v": {"type": "long"}}})
        for idx in pair:
            idx.index_doc("1", {"v": 1})
            idx.refresh()
        body = {"size": 0, "track_total_hits": True,
                "aggs": {"s": {"sum": {"field": "v"}}}}
        for search in (svc.jax, svc.port):
            r1 = search.search("rc", body)
            assert search.request_cache_stats == {"hit_count": 0,
                                                  "miss_count": 1}
            r2 = search.search("rc", body)
            assert search.request_cache_stats["hit_count"] == 1
            assert r2["aggregations"] == r1["aggregations"]
        for idx in pair:
            idx.index_doc("2", {"v": 5})
            idx.refresh()
        for search in (svc.jax, svc.port):
            r3 = search.search("rc", body)
            assert search.request_cache_stats["miss_count"] == 2
            assert r3["aggregations"]["s"]["value"] == 6.0
            search.search("rc", {"size": 1})
            search.search("rc", {**body, "request_cache": False})
            assert search.request_cache_stats == {"hit_count": 1,
                                                  "miss_count": 2}
            r3["aggregations"]["s"]["value"] = -1
            r4 = search.search("rc", dict(body))
            assert r4["aggregations"]["s"]["value"] == 6.0
        same_page(svc.port.search("rc", body), svc.jax.search("rc", body))
    finally:
        svc.close()


def test_request_cache_index_recreation_isolated(tmp_path):
    import time as _time
    svc = Services(tmp_path)
    body = {"size": 0, "track_total_hits": True,
            "aggs": {"s": {"sum": {"field": "v"}}}}

    def make(v):
        for idx in svc.create("rc", {}, {"properties": {
                "v": {"type": "long"}}}):
            idx.index_doc("1", {"v": v})
            idx.refresh()

    try:
        make(1)
        for search in (svc.jax, svc.port):
            assert search.search("rc", body)["aggregations"]["s"][
                "value"] == 1.0
        svc.jax_indices.delete_index("rc")
        svc.port_indices.delete_index("rc")
        _time.sleep(0.002)
        make(5)
        for search in (svc.jax, svc.port):
            assert search.search("rc", body)["aggregations"]["s"][
                "value"] == 5.0
    finally:
        svc.close()


def test_request_cache_misses_after_a_tombstone_only_refresh(services):
    """A delete's refresh publishes no segment, only a tombstone: the
    shard's epoch still moves, so the cached count is never served."""
    services.fill(num_shards=1, n=10)
    body = {"size": 0, "query": {"match_all": {}}}
    for search in (services.jax, services.port):
        assert search.search("test", body)["hits"]["total"]["value"] == 10
    for indices in (services.jax_indices, services.port_indices):
        idx = indices.get("test") if hasattr(indices, "has") else \
            indices["test"]
        idx.delete_doc("3")
        idx.refresh()
    for search in (services.jax, services.port):
        assert search.search("test", body)["hits"]["total"]["value"] == 9
    assert services.port.request_cache_stats == {"hit_count": 0,
                                                 "miss_count": 2}


# ------------------------------------------------ scroll at 1-3 shards

def _docs(n, seed):
    rng = np.random.default_rng(seed)
    return [{"title": " ".join(rng.choice(WORDS, 4)),
             "tag": str(rng.choice(["a", "b", "c", "d"])) if i % 7 else None,
             "views": int(rng.integers(0, 40))} for i in range(n)]


def _matches(doc, text):
    return bool(set(doc["title"].split()) & set(text.split()))


SCROLL_BODIES = {
    "score": {"query": {"match": {"title": "amber dune cedar"}},
              "size": 7},
    "views": {"query": {"match": {"title": "krill mesa"}},
              "sort": [{"views": "desc"}], "size": 6},
    "keyword": {"sort": [{"tag": "asc"}], "size": 9},
    "match_all": {"size": 11, "_source": False},
}


@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("between", ["nothing", "refresh", "forcemerge"])
@pytest.mark.parametrize("kind", sorted(SCROLL_BODIES))
def test_scroll_pages_equal_the_reference(services, shards, between, kind):
    """Three segments a shard (three refreshes), a scroll of the body;
    after its second page a write and a refresh (unseen by the pinned
    segment lists) or a force-merge (the context keeps reading the
    merged-away segments); every page equal to the reference's, the
    pages disjoint and their union every match."""
    docs = _docs(90, seed=shards)
    pair = services.create("s", {"index.number_of_shards": shards})
    for idx in pair:
        for lo in range(0, 90, 30):
            for i in range(lo, lo + 30):
                d = {k: v for k, v in docs[i].items() if v is not None}
                idx.index_doc(str(i), d)
            idx.refresh()
    body = SCROLL_BODIES[kind]
    first = [s.search("s", dict(body), scroll="1m")
             for s in (services.jax, services.port)]
    pages = [[f] for f in first]
    while pages[1][-1]["hits"]["hits"]:
        if len(pages[1]) == 2:
            for idx in pair:
                if between == "refresh":
                    idx.index_doc("new", {"title": "amber amber krill",
                                          "tag": "a", "views": 1})
                    idx.delete_doc("0")
                    idx.refresh()
                elif between == "forcemerge":
                    idx.force_merge(1)
        for k, s in enumerate((services.jax, services.port)):
            pages[k].append(s.scroll(first[k]["_scroll_id"]))
    assert len(pages[1]) == len(pages[0])
    for g, r in zip(pages[1], pages[0]):
        same_page(g, r, f"{kind} {shards} {between}")
    ids = [h["_id"] for p in pages[1] for h in p["hits"]["hits"]]
    early = {h["_id"] for p in pages[1][:2] for h in p["hits"]["hits"]}
    # a delete refreshed mid-scroll hides its doc from the later pages
    # (the pinned segment's live mask), as in the reference
    text = body.get("query", {}).get("match", {}).get("title")
    lost = int(between == "refresh" and "0" not in early
               and (text is None or _matches(docs[0], text)))
    total = first[1]["hits"]["total"]["value"]
    assert len(ids) == len(set(ids)) == total - lost
    assert "new" not in ids


# ----------------------------------- test_search_features.py's cases

def test_explain_api(services):
    from test_search_features import DOCS
    pair = services.create("idx", {}, None)
    for idx in pair:
        for i, d in enumerate(DOCS):
            idx.index_doc(str(i), d)
        idx.refresh()
    for doc_id in ("0", "3", "404"):
        body = {"query": {"match": {"title": "quick"}}}
        got = services.port.explain("idx", doc_id, body)
        ref = services.jax.explain("idx", doc_id, body)
        np.testing.assert_allclose(got["explanation"].pop("value"),
                                   ref["explanation"].pop("value"),
                                   rtol=1e-6)
        assert got == ref
    assert services.port.explain("idx", "0", {"query": {"match": {
        "title": "quick"}}})["matched"] is True
    assert services.port.explain("idx", "3", {"query": {"match": {
        "title": "quick"}}})["matched"] is False


def test_keyword_sort_scroll_across_segments(services):
    pair = services.create("k", {}, {"properties": {
        "name": {"type": "keyword"}, "n": {"type": "long"}}})
    for idx in pair:
        idx.index_doc("1", {"name": "a", "n": 1})
        idx.index_doc("2", {"name": "b", "n": 2})
        idx.refresh()
        idx.index_doc("3", {"name": "c", "n": 3})
        idx.refresh()
    body = {"sort": [{"name": "asc"}], "size": 1}
    got = [h["_source"]["name"] for p in drain(
        services.port, services.port.search("k", body, scroll="1m"))
        for h in p["hits"]["hits"]]
    assert got == ["a", "b", "c"]


@pytest.mark.parametrize("shards", [1, 2])
def test_sliced_scroll_partitions_disjoint_and_complete(services, shards):
    pair = services.create("s", {"index.number_of_shards": shards},
                           {"properties": {"n": {"type": "long"}}})
    for idx in pair:
        for i in range(40):
            idx.index_doc(str(i), {"n": i})
        idx.refresh()
    seen = []
    for sid in range(3):
        body = {"slice": {"id": sid, "max": 3}, "size": 10}
        jp = drain(services.jax, services.jax.search("s", dict(body),
                                                     scroll="1m"))
        pp = drain(services.port, services.port.search("s", dict(body),
                                                       scroll="1m"))
        for g, r in zip(pp, jp):
            same_page(g, r)
        ids = [h["_id"] for p in pp for h in p["hits"]["hits"]]
        assert ids
        assert all(abs(murmur3_hash(i)) % 3 == sid for i in ids)
        seen.extend(ids)
    assert sorted(seen, key=int) == [str(i) for i in range(40)]
    assert len(seen) == len(set(seen))


def test_slice_out_of_range_is_a_parse_error(services):
    services.fill()
    for s in (services.jax, services.port):
        with pytest.raises(Exception) as info:
            s.search("test", {"slice": {"id": 3, "max": 3}}, scroll="1m")
        assert "slice id [3] must be in [0, 3)" in str(info.value)


# ------------------------------------------- the vectorised murmur3

def test_murmur3_array_equals_the_scalar_hash_bit_for_bit():
    """On the ids of the CPU fixtures and on seeded random ids: non-ASCII
    and astral characters, empty ids, lengths 1 to 64."""
    rng = random.Random(19)
    alphabet = ("abcdefghijklmnopqrstuvwxyz0123456789-_ ./"
                "éüßøçñ漢字かなАБВ\u0000\u007f￿😀𝄞")
    ids = [str(i) for i in range(2000)] + ["", "hell", "hello",
                                          "hello wor"]
    ids += ["".join(rng.choice(alphabet) for _ in range(rng.randint(1, 64)))
            for _ in range(5000)]
    # the fixtures' ids: numbers, prefixed numbers, generated hex ids
    ids += [f"d{i}" for i in range(200)] + ["new", "new-1", "q12", "a1"]
    ids += [f"{rng.getrandbits(80):020x}" for _ in range(200)]
    got = murmur3_hash_array(ids)
    assert got.dtype == np.int32
    assert got.tolist() == [murmur3_hash(i) for i in ids]
    assert murmur3_hash_array([]).shape == (0,)


# --------------------------------------------------- point in time

def seed_logs(node):
    for i in range(10):
        st, _ = node.rest_controller.dispatch(
            "PUT", f"/logs/_doc/{i}", {},
            {"msg": f"error in module {i}",
             "level": "warn" if i % 2 else "info", "code": i})
        assert st in (200, 201)
    node.rest_controller.dispatch("POST", "/logs/_refresh", {}, None)


class NodePair:
    """Both nodes; ``d`` sends a request to both, maps the port's
    generated scroll and PIT ids to the reference's, and holds the
    answers equal (scores rtol 1e-6)."""

    def __init__(self, root):
        self.jax = JaxNode(data_path=str(root / "jax"))
        self.port = Node(device="cpu", data_path=str(root / "port"))
        self.ids = {}
        self.rest_controller = self

    def _map(self, value):
        if isinstance(value, str):
            return self.ids.get(value, value)
        if isinstance(value, dict):
            return {k: self._map(v) for k, v in value.items()}
        if isinstance(value, list):
            return [self._map(v) for v in value]
        return value

    def dispatch(self, method, path, params=None, body=None):
        params = dict(params or {})
        for part in path.split("/"):
            if part in self.ids:
                path = path.replace(part, self.ids[part])
        jst, ref = self.jax.rest_controller.dispatch(
            self._map(method), path, self._map(params), self._map(body))
        st, got = self.port.rest_controller.dispatch(
            method, path, params, body)
        for key in ("_scroll_id", "id", "pit_id"):
            if isinstance(got, dict) and isinstance(got.get(key), str) \
                    and key in (ref or {}):
                self.ids[got[key]] = ref[key]
        assert st == jst, (method, path, body, got, ref)
        if path.endswith(_SHARD_COUNTS):
            pass        # the port counts every shard in ``_shards``
        elif isinstance(got, dict) and "hits" in got:
            same_hits(strip(got), strip(ref))
        elif isinstance(got, dict) and "responses" in got:
            assert len(got["responses"]) == len(ref["responses"])
            for g, r in zip(got["responses"], ref["responses"]):
                if "hits" in g:
                    same_hits(strip(g), strip(r))
                else:
                    assert strip(g) == strip(r), (path, g, r)
        else:
            # an error's reason names the port's id: the reference's here
            text = json.dumps(got)
            for mine, theirs in self.ids.items():
                text = text.replace(mine, theirs)
            mapped = json.loads(text)
            assert strip(mapped) == strip(ref) or (
                key_only(got) == key_only(ref)), (path, got, ref)
        return st, got

    def d(self, method, path, params=None, body=None):
        return self.dispatch(method, path, params, body)

    def close(self):
        self.port.close()
        self.jax.close()


def key_only(resp):
    """A PIT open's answer: its keys (the ids are generated)."""
    return sorted(resp) if isinstance(resp, dict) and set(resp) == {
        "id"} else resp


@pytest.fixture()
def nodes(tmp_path):
    p = NodePair(tmp_path)
    yield p
    p.close()


def test_point_in_time(nodes):
    seed_logs(nodes.jax)
    seed_logs(nodes.port)
    _, r = nodes.d("POST", "/logs/_pit", {"keep_alive": "1m"})
    pit_id = r["id"]
    nodes.d("PUT", "/logs/_doc/new", {}, {"msg": "late", "code": 99})
    nodes.d("POST", "/logs/_refresh")
    _, rs = nodes.d("POST", "/_search", {}, {"pit": {"id": pit_id},
                                             "size": 20})
    assert rs["hits"]["total"]["value"] == 10
    assert rs["pit_id"] == pit_id
    _, rs2 = nodes.d("GET", "/logs/_search", {}, {"size": 20})
    assert rs2["hits"]["total"]["value"] == 11
    nodes.d("POST", "/logs/_search", {}, {"pit": {"id": pit_id}})
    assert nodes.port.search_service.open_pit_count() == 1
    _, rc = nodes.d("DELETE", "/_pit", {}, {"id": pit_id})
    assert rc["succeeded"] is True
    assert nodes.port.search_service.open_pit_count() == 0
    st, _ = nodes.d("POST", "/_search", {}, {"pit": {"id": pit_id}})
    assert st == 404
    nodes.d("DELETE", "/_pit", {}, {"id": pit_id})
    nodes.d("DELETE", "/_pit", {}, {})


def test_point_in_time_sees_later_deletes_not_later_docs(nodes):
    """The reference's PIT pins the segment list, and a refreshed delete
    flips the pinned segment's live mask: the PIT sees deletes made
    after it opened and never a doc published after it, in both
    packages."""
    seed_logs(nodes.jax)
    seed_logs(nodes.port)
    _, r = nodes.d("POST", "/logs/_pit", {"keep_alive": "1m"})
    body = {"pit": {"id": r["id"]}, "size": 20, "sort": [{"code": "asc"}]}
    nodes.d("DELETE", "/logs/_doc/3")
    nodes.d("PUT", "/logs/_doc/10", {}, {"msg": "new", "code": 10})
    nodes.d("POST", "/logs/_refresh")
    _, rs = nodes.d("POST", "/_search", {}, body)
    codes = [h["_source"]["code"] for h in rs["hits"]["hits"]]
    assert codes == [0, 1, 2, 4, 5, 6, 7, 8, 9]


def test_pit_keep_alive_expires(nodes):
    seed_logs(nodes.port)
    svc = nodes.port.search_service
    pit = svc.open_pit("logs", "1ms")
    import time as _time
    _time.sleep(0.01)
    with pytest.raises(SearchContextMissingException):
        svc.search("_all", {"pit": {"id": pit}})
    assert svc.open_pit_count() == 0


# --------------------------------------------------- REST cases

def _articles(node):
    for i in range(12):
        node.rest_controller.dispatch(
            "PUT", f"/articles/_doc/{i}", {},
            {"title": f"article about {'jax' if i % 2 else 'numpy'} {i}",
             "views": i})
    node.rest_controller.dispatch("POST", "/articles/_refresh", {}, None)


def test_count_over_rest(nodes):
    _articles(nodes.jax)
    _articles(nodes.port)
    _, r = nodes.d("GET", "/articles/_count", {}, {"query": {"match": {
        "title": "jax"}}})
    assert r["count"] == 6
    nodes.d("GET", "/articles/_count", {}, None)
    nodes.d("GET", "/nope/_count", {}, None)


def test_scroll_over_rest(nodes):
    for i in range(7):
        nodes.d("PUT", f"/s/_doc/{i}", {}, {"n": i})
    nodes.d("POST", "/s/_refresh")
    _, r = nodes.d("POST", "/s/_search", {"scroll": "1m"},
                   {"size": 3, "sort": [{"n": "asc"}]})
    seen = [h["_source"]["n"] for h in r["hits"]["hits"]]
    sid = r["_scroll_id"]
    while True:
        _, r = nodes.d("POST", "/_search/scroll", {},
                       {"scroll_id": sid, "scroll": "1m"})
        if not r["hits"]["hits"]:
            break
        seen.extend(h["_source"]["n"] for h in r["hits"]["hits"])
    assert seen == list(range(7))
    _, r = nodes.d("DELETE", "/_search/scroll", {}, {"scroll_id": sid})
    assert r["num_freed"] == 1
    nodes.d("GET", "/_search/scroll", {"scroll_id": sid})
    nodes.d("POST", "/s/_search", {"scroll": "1m"}, {"size": 3})
    nodes.d("POST", "/s/_search", {"scroll": "1m"}, {"size": 3})
    _, r = nodes.d("DELETE", "/_search/scroll", {}, None)
    assert r["num_freed"] == 2
    nodes.d("POST", "/s/_search", {"scroll": "soon"}, {"size": 3})


def test_msearch(nodes):
    nodes.d("PUT", "/a/_doc/1", {}, {"x": "alpha"})
    nodes.d("PUT", "/b/_doc/1", {}, {"x": "beta"})
    nodes.d("POST", "/a/_refresh")
    nodes.d("POST", "/b/_refresh")
    nd = "\n".join(json.dumps(x) for x in [
        {"index": "a"}, {"query": {"match_all": {}}},
        {"index": "b"}, {"query": {"match": {"x": "beta"}}},
        {"index": "nope"}, {"query": {"match_all": {}}},
        {}, {"query": {"bogus": {}}}])
    _, r = nodes.d("POST", "/_msearch", {}, nd)
    assert len(r["responses"]) == 4
    assert r["responses"][0]["hits"]["total"]["value"] == 1
    assert r["responses"][1]["hits"]["total"]["value"] == 1
    assert r["responses"][2]["status"] == 404
    assert r["responses"][3]["status"] == 400
    nodes.d("POST", "/a/_msearch", {}, [{}, {"size": 0}])


def test_scroll_reports_total_on_every_page(nodes):
    for i in range(9):
        nodes.d("PUT", f"/sc/_doc/{i}", {}, {"n": i})
    nodes.d("POST", "/sc/_refresh")
    _, r = nodes.d("POST", "/sc/_search", {"scroll": "1m"},
                   {"size": 4, "sort": [{"n": "asc"}]})
    assert r["hits"]["total"]["value"] == 9
    _, r = nodes.d("POST", "/_search/scroll", {},
                   {"scroll_id": r["_scroll_id"]})
    assert r["hits"]["total"]["value"] == 9


def test_msearch_of_16_bodies_equals_the_bodies_alone(tmp_path):
    """16 bodies of four shapes (the fast grammar, the plan path, a
    sort, an aggregation) in one ``_msearch``, its sub-searches run
    concurrently on the search pool, each answer equal to the body asked
    alone."""
    node = Node(device="cpu", data_path=str(tmp_path / "m"))
    try:
        rest = node.rest_controller
        rest.dispatch("PUT", "/m", {}, {"mappings": MAPPINGS})
        rng = np.random.default_rng(4)
        rest.dispatch("POST", "/m/_bulk", {"refresh": "true"}, "".join(
            json.dumps(x) + "\n" for i in range(400) for x in (
                {"index": {"_id": str(i)}},
                {"title": " ".join(rng.choice(WORDS, 5)),
                 "tag": str(rng.choice(["a", "b"])),
                 "views": int(rng.integers(0, 100))})))
        bodies = []
        for i in range(16):
            w = WORDS[i % len(WORDS)]
            bodies.append([
                {"query": {"match": {"title": w}}, "size": 5},
                {"query": {"bool": {"should": [
                    {"match": {"title": w}}, {"term": {"tag": "a"}}]}},
                 "size": 5},
                {"query": {"match": {"title": w}},
                 "sort": [{"views": "desc"}], "size": 5},
                {"size": 0, "query": {"match": {"title": w}},
                 "aggs": {"t": {"terms": {"field": "tag"}}}},
            ][i % 4])
        nd = "".join(json.dumps(x) + "\n" for b in bodies
                     for x in ({"index": "m"}, b))
        st, r = rest.dispatch("POST", "/_msearch", {}, nd)
        assert st == 200 and len(r["responses"]) == 16
        for b, got in zip(bodies, r["responses"]):
            _, alone = rest.dispatch("POST", "/m/_search", {},
                                     dict(b, request_cache=False))
            same_page(got, alone)
    finally:
        node.close()


# ------------------------------------------------------ stored scripts

def test_stored_scripts_crud(nodes):
    nodes.d("PUT", "/_scripts/my-tpl", {}, {"script": {
        "lang": "mustache",
        "source": {"query": {"match": {"msg": "{{q}}"}}}}})
    _, r = nodes.d("GET", "/_scripts/my-tpl")
    assert r["found"] and r["script"]["lang"] == "mustache"
    nodes.d("DELETE", "/_scripts/my-tpl")
    st, _ = nodes.d("GET", "/_scripts/my-tpl")
    assert st == 404
    nodes.d("DELETE", "/_scripts/my-tpl")
    nodes.d("PUT", "/_scripts/bad", {}, {"script": {"lang": "painless"}})


def test_script_by_id_answers_as_inline(nodes):
    seed_logs(nodes.jax)
    seed_logs(nodes.port)
    src = "doc['code'].value * 2 + _score"
    nodes.d("PUT", "/_scripts/s1", {}, {"script": {"lang": "painless",
                                                    "source": src}})
    body = {"query": {"script_score": {"query": {"match": {"msg": "error"}},
                                       "script": {"id": "s1"}}},
            "size": 5}
    _, by_id = nodes.d("POST", "/logs/_search", {}, body)
    inline = {"query": {"script_score": {"query": {"match": {"msg": "error"}},
                                         "script": {"source": src}}},
              "size": 5}
    _, r = nodes.d("POST", "/logs/_search", {}, inline)
    same_page(by_id, r)
    nodes.d("POST", "/logs/_search", {}, {"query": {"script_score": {
        "query": {"match_all": {}}, "script": {"id": "nope"}}}})


def test_two_nodes_keep_their_stored_scripts_apart(tmp_path):
    """Each port node resolves a script ``id`` in its own store (the
    reference's process-wide resolver lets the last node constructed
    win)."""
    a = Node(device="cpu", data_path=str(tmp_path / "a"))
    b = Node(device="cpu", data_path=str(tmp_path / "b"))
    try:
        for n, factor in ((a, 2), (b, 3)):
            rest = n.rest_controller
            rest.dispatch("PUT", "/i/_doc/1", {"refresh": "true"},
                          {"v": 5})
            rest.dispatch("PUT", "/_scripts/s", {}, {"script": {
                "source": f"doc['v'].value * {factor}"}})
        body = {"query": {"script_score": {"query": {"match_all": {}},
                                           "script": {"id": "s"}}}}
        for n, want in ((a, 10.0), (b, 15.0)):
            st, r = n.rest_controller.dispatch("POST", "/i/_search", {},
                                               body)
            assert st == 200 and r["hits"]["hits"][0]["_score"] == want
        b.rest_controller.dispatch("DELETE", "/_scripts/s", {}, None)
        st, r = b.rest_controller.dispatch("POST", "/i/_search", {}, body)
        assert st == 400 and r["error"]["type"] == "parsing_exception"
        st, r = a.rest_controller.dispatch("POST", "/i/_search", {}, body)
        assert st == 200
    finally:
        a.close()
        b.close()


# ------------------------------------------ contexts on the device

def test_segments_a_context_outlived_leave_the_device(tmp_path):
    """A scroll and a PIT open, the index force-merged: their next pages
    upload the retired segments again; once both close, no retired
    segment is resident and the breaker equals the resident bytes."""
    node = Node(device="cpu", data_path=str(tmp_path / "c"))
    try:
        rest = node.rest_controller
        rest.dispatch("PUT", "/c", {}, {"mappings": MAPPINGS})
        for lo in range(0, 60, 20):
            rest.dispatch("POST", "/c/_bulk", {"refresh": "true"}, "".join(
                json.dumps(x) + "\n" for i in range(lo, lo + 20) for x in (
                    {"index": {"_id": str(i)}},
                    {"title": f"{WORDS[i % 8]} x", "views": i})))
        svc = node.search_service
        r = svc.search("c", {"query": {"match": {"title": "x"}},
                             "size": 5}, scroll="1m")
        pit = svc.open_pit("c", "1m")
        old = node.indices["c"].segment_names()
        assert len(old) == 3
        rest.dispatch("POST", "/c/_forcemerge", {}, None)
        assert not any(node.device_cache.resident(n) for n in old)
        page = svc.scroll(r["_scroll_id"])
        assert len(page["hits"]["hits"]) == 5
        svc.search("_all", {"pit": {"id": pit}, "size": 3})
        assert all(node.device_cache.resident(n) for n in old)
        svc.clear_scroll([r["_scroll_id"]])
        assert all(node.device_cache.resident(n) for n in old)
        svc.close_pit(pit)
        assert not any(node.device_cache.resident(n) for n in old)
        hbm = node.breaker_service.get_breaker("hbm")
        stats = node.device_cache.engine_stats()
        assert hbm.used == stats["hbm"]["total_bytes"]
    finally:
        node.close()


def test_resumable_scroll_batches_survive_a_lost_context(services):
    services.fill(n=25)
    port = services.port
    out = []
    batches = resumable_scroll_batches(port, "test",
                                       {"sort": [{"views": "asc"}]}, 4)
    for i, hits in enumerate(batches):
        out.extend(h["_source"]["views"] for h in hits)
        if i == 2:
            port.clear_scroll(["_all"])
    assert out == list(range(25))
    assert port.open_scroll_count() == 0
    scanned = [h["_id"] for h in port.scan("test", {}, page=6)]
    assert sorted(scanned, key=int) == [str(i) for i in range(25)]


def test_front_bounces_pit_and_slice_bodies(tmp_path):
    """The C++ grammar refuses ``pit`` and ``slice`` (and any path with
    a query string, such as ``?scroll``): the front's ``fast`` counter
    does not grow and the search service answers."""
    from test_torch_native_http import req as post_req
    node = Node(device="cpu", data_path=str(tmp_path / "f"))
    try:
        rest = node.rest_controller
        rest.dispatch("PUT", "/f", {}, {"mappings": {"properties": {
            "title": {"type": "text"}}}})
        rest.dispatch("POST", "/f/_bulk", {"refresh": "true"}, "".join(
            json.dumps(x) + "\n" for i in range(30)
            for x in ({"index": {"_id": str(i)}}, {"title": "red fox"})))
        port = node.start(0)
        base = {"query": {"match": {"title": "red"}}, "_source": False}
        st, _ = post_req(port, "POST", "/f/_search", base)
        fast0 = node.http_stats()["fast"]
        assert st == 200 and fast0 >= 1
        st, r = post_req(port, "POST", "/f/_search", dict(base, slice={"id": 0,
                                                           "max": 2}))
        assert st == 200
        pit = node.search_service.open_pit("f", "1m")
        st, r = post_req(port, "POST", "/_search", dict(base, pit={"id": pit}))
        assert st == 200 and r["hits"]["total"]["value"] == 30
        st, r = post_req(port, "POST", "/f/_search?scroll=1m", base)
        assert st == 200 and "_scroll_id" in r
        assert node.http_stats()["fast"] == fast0
    finally:
        node.close()


# ---------------------------------------------------------- the YAML cases

class _PairFactory:
    def __init__(self, root):
        self.root = root
        self.n = 0

    def __call__(self):
        self.n += 1
        return NodePair(self.root / f"y{self.n}")


def run_yaml_cases(root, suite, names, stop_before=None):
    """The named cases of a YAML suite (its setup first), each against a
    fresh pair of nodes whose every answer must agree; ``stop_before``
    (a path) ends a case before that request."""
    with open(os.path.join(SUITES, suite)) as fh:
        doc = {}
        for part in yaml.safe_load_all(fh):
            doc.update(part or {})
    runner = YamlRestRunner(_PairFactory(root))
    for name in names:
        runner.node = runner.node_factory()
        runner.vars = {}
        try:
            steps = list(doc.get("setup") or []) + list(doc[name])
            if stop_before is not None:
                cut = next(i for i, s in enumerate(steps)
                           if "do" in s and stop_before in json.dumps(s))
                steps = steps[:cut]
            runner._run_steps(steps, f"{suite}::{name}")
        finally:
            runner.node.close()


@pytest.mark.parametrize("suite,case", [
    ("29_async_pit.yml", "point in time pins a view across writes"),
    ("29_async_pit.yml", "sliced scroll partitions the corpus"),
    ("30_bulk_count.yml", "bulk indexes and count sees refreshed docs"),
    ("32_templates_scripts.yml",
     "index template applies mappings and settings on create"),
    ("32_templates_scripts.yml", "component templates compose"),
    ("32_templates_scripts.yml", "inline search template renders"),
])
def test_yaml_cases(tmp_path, suite, case):
    run_yaml_cases(tmp_path, suite, [case])


def test_yaml_stored_script_case(tmp_path):
    """32_templates_scripts.yml's stored-script case through its
    templated search (search/template.py), on both nodes."""
    run_yaml_cases(tmp_path, "32_templates_scripts.yml",
                   ["stored script and templated search"])
