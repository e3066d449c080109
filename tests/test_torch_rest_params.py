"""Requests the port once took without serving them, now answered as the
reference answers them or refused with a typed 400, through both nodes'
``rest_controller.dispatch`` on the same documents: the `_search` URL
parameters (``q``, ``from``, ``size``, ``request_cache``,
``allow_partial_search_results``; ``scroll``, ``timeout`` and the rest
are a later slice), the mapping's ``dynamic`` setting, ``copy_to`` and
``number_of_shards`` other than 1."""

import json

import numpy as np
import pytest

from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.index.mapper import (
    DocumentMapper, StrictDynamicMappingException)
from elasticsearch_tpu_torch.node import Node

DOCS = [{"t": "red fox", "n": 0}, {"t": "blue sky", "n": 1},
        {"t": "red sun", "n": 2}, {"t": "green hill", "n": 3}]
ONE_SHARD = {"index": {"number_of_shards": 1}}


def _bulk(docs):
    return "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                   + json.dumps(d) + "\n" for i, d in enumerate(docs))


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("params")))
    node = Node(device="cpu")
    for c in (jax_node.rest_controller, node.rest_controller):
        st, _ = c.dispatch("PUT", "/p", {}, {
            "mappings": {"properties": {"t": {"type": "text"},
                                        "n": {"type": "long"}}},
            "settings": ONE_SHARD})
        assert st == 200
        st, r = c.dispatch("POST", "/p/_bulk", {"refresh": "true"},
                           _bulk(DOCS))
        assert st == 200 and not r["errors"], r
    yield jax_node, node
    node.close()
    jax_node.close()


def both(nodes, method, path, params, body):
    jax_node, node = nodes
    return (jax_node.rest_controller.dispatch(method, path, dict(params),
                                              body),
            node.rest_controller.dispatch(method, path, dict(params), body))


def hits_of(r):
    return [(h["_id"], h["_score"]) for h in r["hits"]["hits"]]


def assert_same_hits(ref, got):
    assert got["hits"]["total"] == ref["hits"]["total"]
    assert [i for i, _ in hits_of(got)] == [i for i, _ in hits_of(ref)]
    np.testing.assert_allclose([s for _, s in hits_of(got)],
                               [s for _, s in hits_of(ref)], rtol=1e-5)


# the probe cases: (URL parameters, body)
SERVED = [
    ({"q": "t:red"}, None),
    ({"q": "red"}, None),                        # every field: multi_match
    ({"q": "t:red", "size": "1"}, None),
    ({"size": "1"}, {"size": 3, "sort": [{"n": "asc"}]}),
    ({"from": "2"}, {"from": 0, "sort": [{"n": "asc"}]}),
    ({"from": "1", "size": "2"}, {"query": {"match": {"t": "red sun"}}}),
    ({"q": "t:blue"}, {"query": {"match": {"t": "red"}}}),   # body wins
]


@pytest.mark.parametrize("ci", range(len(SERVED)))
def test_served_url_parameters_answer_as_the_reference(nodes, ci):
    params, body = SERVED[ci]
    (jst, ref), (st, got) = both(nodes, "POST", "/p/_search", params, body)
    assert jst == st == 200, (ref, got)
    assert_same_hits(ref, got)


@pytest.mark.parametrize("key", ["request_cache",
                                 "allow_partial_search_results"])
def test_boolean_url_parameters_refuse_other_values(nodes, key):
    (jst, ref), (st, got) = both(nodes, "POST", "/p/_search",
                                 {key: "maybe"}, None)
    assert jst == st == 400
    assert got["error"]["type"] == ref["error"]["type"] \
        == "illegal_argument_exception"


def test_a_valid_boolean_parameter_meets_the_body_keys(nodes):
    """``request_cache=true`` goes into the body, which the slice refuses
    as it refuses the body key (the reference serves both)."""
    _, (st, got) = both(nodes, "POST", "/p/_search",
                        {"request_cache": "true"}, None)
    _, (bst, bgot) = both(nodes, "POST", "/p/_search", {},
                          {"request_cache": True})
    assert st == bst == 400
    assert got["error"]["type"] == bgot["error"]["type"] \
        == "unsupported_in_slice_exception"
    (jst, _), (st, got) = both(nodes, "POST", "/p/_search",
                               {"allow_partial_search_results": "false"},
                               None)
    assert jst == 200 and st == 400
    assert got["error"]["type"] == "unsupported_in_slice_exception"


@pytest.mark.parametrize("params", [{"scroll": "1m"}, {"timeout": "1s"},
                                    {"search_type": "dfs_query_then_fetch"},
                                    {"q": "t:red", "typed_keys": "true"}])
def test_other_url_parameters_are_a_typed_400(nodes, params):
    (jst, ref), (st, got) = both(nodes, "POST", "/p/_search", params, None)
    assert jst == 200
    assert st == 400
    assert got["error"]["type"] == "unsupported_in_slice_exception"
    if "scroll" in params:
        assert "_scroll_id" in ref


# ---------------------------------------------------------------------------
# the mapping's dynamic setting
# ---------------------------------------------------------------------------

def test_strict_dynamic_rejects_as_the_reference():
    mappings = {"dynamic": "strict", "properties": {"a": {"type": "long"}}}
    with pytest.raises(StrictDynamicMappingException):
        DocumentMapper(mappings).parse("1", {"a": 1, "unknown": "x"})
    ref = MapperService(mappings=mappings)
    with pytest.raises(Exception) as e:
        ref.parse("1", {"a": 1, "unknown": "x"})
    assert type(e.value).__name__ == "StrictDynamicMappingException"


def test_dynamic_false_ignores_as_the_reference():
    mappings = {"dynamic": "false", "properties": {"a": {"type": "long"}}}
    m = DocumentMapper(mappings)
    doc = m.parse("1", {"a": 1, "unknown": "x"})
    ref = MapperService(mappings=mappings)
    rdoc = ref.parse("1", {"a": 1, "unknown": "x"})
    assert m.field_type("unknown") is None
    assert ref.field_type("unknown") is None
    assert "unknown" not in doc.text_tokens
    assert "unknown" not in rdoc.text_tokens
    assert doc.numeric_values == {"a": [1.0]}


@pytest.mark.parametrize("dynamic", ["strict", "false", "true"])
def test_dynamic_over_rest_answers_as_the_reference(tmp_path, dynamic):
    jax_node = JaxNode(data_path=str(tmp_path / "dyn"))
    node = Node(device="cpu")
    try:
        docs = [{"a": 1}, {"a": 2, "extra": "x"}, {"a": 3}, {"a": 4}]
        out = []
        for c in (jax_node.rest_controller, node.rest_controller):
            st, _ = c.dispatch("PUT", "/d", {}, {
                "mappings": {"dynamic": dynamic,
                             "properties": {"a": {"type": "long"}}},
                "settings": ONE_SHARD})
            assert st == 200
            st, bulk = c.dispatch("POST", "/d/_bulk", {"refresh": "true"},
                                  _bulk(docs))
            assert st == 200
            items = [(it["index"]["status"],
                      it["index"].get("error", {}).get("type"))
                     for it in bulk["items"]]
            st, all_ = c.dispatch("POST", "/d/_search", {},
                                  {"query": {"match_all": {}}})
            st2, ex = c.dispatch("POST", "/d/_search", {},
                                 {"query": {"exists": {"field": "extra"}}})
            assert st == st2 == 200
            out.append((bulk["errors"], items,
                        all_["hits"]["total"]["value"],
                        ex["hits"]["total"]["value"]))
        assert out[1] == out[0]
        errors, items, n_all, n_extra = out[1]
        if dynamic == "strict":
            assert errors and items[1] == (
                400, "strict_dynamic_mapping_exception") and n_all == 3
        else:
            assert not errors and n_all == 4
            assert n_extra == (0 if dynamic == "false" else 1)
    finally:
        node.close()
        jax_node.close()


# ---------------------------------------------------------------------------
# copy_to
# ---------------------------------------------------------------------------

def test_copy_to_indexes_into_the_target_as_the_reference(tmp_path):
    """The `copy_to` case of tests/yaml_suites/31_mapper_types.yml, and
    a keyword target beside it."""
    jax_node = JaxNode(data_path=str(tmp_path / "copy"))
    node = Node(device="cpu")
    mappings = {"properties": {
        "first": {"type": "text", "copy_to": "full"},
        "last": {"type": "text", "copy_to": ["full", "names"]},
        "full": {"type": "text"}, "names": {"type": "keyword"}}}
    docs = [{"first": "Ada", "last": "Lovelace"},
            {"first": "Alan", "last": "Turing"},
            {"first": "Grace", "last": "Hopper"}]
    try:
        for c in (jax_node.rest_controller, node.rest_controller):
            st, _ = c.dispatch("PUT", "/persons", {}, {
                "mappings": mappings, "settings": ONE_SHARD})
            assert st == 200
            st, r = c.dispatch("POST", "/persons/_bulk", {"refresh": "true"},
                               _bulk(docs))
            assert st == 200 and not r["errors"], r
        for body, want in (({"query": {"match": {"full": "Ada Lovelace"}}},
                            1),
                           ({"query": {"match": {"full": "turing"}}}, 1),
                           ({"query": {"match": {"full": "grace hopper "
                                                          "ada"}}}, 2),
                           ({"query": {"term": {"names": "Hopper"}}}, 1)):
            (jst, ref), (st, got) = both((jax_node, node), "POST",
                                         "/persons/_search", {}, body)
            assert jst == st == 200, (ref, got)
            assert got["hits"]["total"]["value"] == want
            assert_same_hits(ref, got)
    finally:
        node.close()
        jax_node.close()


# ---------------------------------------------------------------------------
# number_of_shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("settings", [
    {"index.number_of_shards": 3}, {"number_of_shards": 3},
    {"index": {"number_of_shards": 3}}, {"index": {"number_of_shards": "2"}}])
def test_several_shards_are_a_typed_400(settings):
    node = Node(device="cpu")
    try:
        st, r = node.rest_controller.dispatch(
            "PUT", "/s", {}, {"settings": settings})
        assert st == 400
        assert r["error"]["type"] == "unsupported_in_slice_exception"
        assert "s" not in node.indices
    finally:
        node.close()


@pytest.mark.parametrize("settings", [
    {}, {"index.number_of_shards": 1}, {"number_of_shards": "1"},
    {"index": {"number_of_shards": 1, "similarity": {"default": {}}}}])
def test_one_shard_is_served(settings):
    node = Node(device="cpu")
    try:
        st, _ = node.rest_controller.dispatch(
            "PUT", "/s", {}, {"settings": settings})
        assert st == 200
    finally:
        node.close()
