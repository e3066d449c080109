"""The port's remaining field types against the reference's, on the CPU.

- The mapper: every key of the reference's ``FIELD_TYPES`` maps in the
  port; ``PUT /{index}`` with each type answers as the reference does; a
  document of each type parses to the reference's columns (numeric
  values, keyword terms, tokens with their positions and offsets) and
  ``to_mapping`` re-emits what the reference's does.
- The reference's tests/test_mapper_extras.py, the cases of the types
  this slice ports (range fields, wildcard, constant_keyword,
  search_as_you_type, token_count, murmur3, flattened, annotated_text):
  the same docs through both packages, the same bodies through both
  (``SegmentContext`` level, scores rtol 1e-6).
- ``ip``: a term, CIDR terms of /24 and /16, ranges, on float32 columns,
  pinned to the reference's own answers (the float32 column merges an
  address with its neighbours above 2^24; ``f32_neighbours`` counts
  them); range fields' open bounds (``gt``/``lt``, a float64
  ``nextafter`` that the float32 column rounds away).
- One slice test: a node of each package takes the same bulk of every
  new type (two segments, deletes) and answers the same bodies over
  REST (ids, order, totals, sort values exact; scores rtol 1e-5).
"""

import ipaddress
import json

import numpy as np
import pytest

from elasticsearch_tpu.index.mapper import FIELD_TYPES as JAX_TYPES
from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.index.mapper import \
    parse_annotated_text as jax_parse_annotated
from elasticsearch_tpu.index.service import murmur3_hash as jax_murmur3
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.index.mapper import (FIELD_TYPES,
                                                  DocumentMapper,
                                                  MapperParsingException,
                                                  murmur3_hash,
                                                  parse_annotated_text)
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search.plan import compile_plan
from elasticsearch_tpu_torch.search.queries import parse_query
from test_torch_dense import assert_same_page
from test_torch_geo import ctx_pair, matching
from test_torch_node import assert_same_hits

# the reference's tests/test_mapper_extras.py documents, without the
# rank_feature(s) fields (ported and held in test_torch_rank_features.py)
MAPPINGS = {"properties": {
    "age_range": {"type": "integer_range"},
    "when": {"type": "date_range"},
    "code": {"type": "wildcard"},
    "env": {"type": "constant_keyword", "value": "prod"},
    "title": {"type": "search_as_you_type"},
    "title_len": {"type": "token_count", "analyzer": "standard"},
    "h": {"type": "murmur3"},
}}
DOCS = [
    {"age_range": {"gte": 10, "lte": 20}, "code": "alpha-123",
     "title": "quick brown fox", "title_len": "one two three", "h": "a"},
    {"age_range": {"gte": 15, "lte": 30}, "code": "beta-456",
     "title": "quick brawl", "title_len": "one two", "h": "b",
     "env": "prod"},
    {"age_range": {"gte": 40, "lte": 50}, "code": "alpha-789",
     "title": "slow snail", "title_len": "one", "h": "a"},
]
FLAT_DOCS = [
    {"labels": {"priority": "urgent", "release": ["v1.2", "v1.3"],
                "owner": {"team": "infra"}}},
    {"labels": {"priority": "low", "owner": {"team": "web"}}},
]

# a mapping of every new type, with a nested object
ALL_MAPPINGS = {"properties": {
    "ip": {"type": "ip"}, "ir": {"type": "integer_range"},
    "lr": {"type": "long_range"}, "fr": {"type": "float_range"},
    "dr": {"type": "double_range"}, "dater": {"type": "date_range"},
    "ipr": {"type": "ip_range"}, "loc": {"type": "geo_point"},
    "shape": {"type": "geo_shape"},
    "rel": {"type": "join", "relations": {"q": ["a", "c"]}},
    "pq": {"type": "percolator"}, "ck": {"type": "constant_keyword"},
    "w": {"type": "wildcard"}, "fl": {"type": "flattened"},
    "tc": {"type": "token_count"}, "m3": {"type": "murmur3"},
    "ann": {"type": "annotated_text"},
    "sayt": {"type": "search_as_you_type", "max_shingle_size": 4},
    "msg": {"type": "text", "fields": {"raw": {"type": "keyword"}}},
    "items": {"type": "nested", "properties": {
        "sku": {"type": "keyword"}, "n": {"type": "long"}}},
}}


@pytest.fixture(scope="module")
def ctx():
    return ctx_pair(MAPPINGS, DOCS)


@pytest.fixture(scope="module")
def flat_ctx():
    return ctx_pair({"properties": {"labels": {"type": "flattened"}}},
                    FLAT_DOCS)


# ---------------------------------------------------------------------------
# the mapper
# ---------------------------------------------------------------------------

def test_every_reference_type_maps():
    assert set(FIELD_TYPES) == set(JAX_TYPES)


@pytest.mark.parametrize("type_name", sorted(JAX_TYPES) + ["nested",
                                                           "no_such_type"])
def test_put_index_with_each_type_answers_as_the_reference(tmp_path,
                                                           type_name):
    conf = {"type": type_name}
    if type_name == "dense_vector":
        conf["dims"] = 3
    if type_name == "join":
        conf["relations"] = {"q": "a"}
    jax_node = JaxNode(data_path=str(tmp_path))
    node = Node(device="cpu")
    try:
        body = {"mappings": {"properties": {"f": conf}}}
        st, r = node.rest_controller.dispatch("PUT", "/t", {}, body)
        st2, r2 = jax_node.rest_controller.dispatch("PUT", "/t", {}, body)
        assert st == st2, (r, r2)
        if st != 200:
            assert r["error"]["type"] == r2["error"]["type"] == \
                "mapper_parsing_exception"
    finally:
        node.close()
        jax_node.close()


ALL_DOC = {
    "ip": "192.168.1.10", "ir": {"gte": 1, "lt": 9},
    "lr": {"gt": -5, "lte": 2 ** 40}, "fr": {"gte": 0.5, "lt": 1.5},
    "dr": {"from": -1.25, "to": 3.75},
    "dater": {"gte": "2024-01-01", "lt": "2024-02-01T12:00:00"},
    "ipr": {"gte": "10.0.0.0", "lte": "10.0.255.255"},
    "loc": [[13.4, 52.5], "48.8566,2.3522"],
    "shape": {"type": "polygon", "coordinates": [[[0, 0], [4, 1], [2, 5],
                                                  [0, 0]]]},
    "rel": {"name": "a", "parent": "p1"},
    "pq": {"bool": {"must": [{"match": {"msg": "disk"}}]}},
    "ck": "eu-west", "w": "alpha-123",
    "fl": {"a": "x", "b": {"c": ["y", "z"]}, "d": [{"e": 1}]},
    "tc": "one two three four", "m3": "hello",
    "ann": "New mayor [John Smith](Person&q42) of [Boston](Location)",
    "sayt": "quick brown fox jumps", "msg": ["disk full", "again"],
    "items": [{"sku": "s1", "n": 3}, {"sku": "s2", "n": 5}],
}


def _columns(parsed):
    return (parsed.numeric_values, parsed.keyword_terms,
            {f: [(t.term, t.position, t.start_offset, t.end_offset)
                 for t in toks] for f, toks in parsed.text_tokens.items()})


def test_a_document_of_every_type_parses_to_the_reference_columns():
    jm, pm = MapperService(mappings=ALL_MAPPINGS), DocumentMapper(ALL_MAPPINGS)
    got, want = _columns(pm.parse("1", ALL_DOC)), \
        _columns(jm.parse("1", ALL_DOC))
    assert got == want
    # the constant pinned by the first value, on both sides
    assert pm.fields["ck"].value == jm.mapper.fields["ck"].value == "eu-west"


def test_to_mapping_re_emits_the_reference_mapping():
    jm, pm = MapperService(mappings=ALL_MAPPINGS), DocumentMapper(ALL_MAPPINGS)
    assert pm.to_mapping() == jm.to_mapping()
    assert pm.to_mapping()["properties"]["items"]["type"] == "nested"


@pytest.mark.parametrize("doc", [
    {"rel": "zz"}, {"rel": {"name": "a"}}, {"rel": 5},
    {"pq": {"no_such_query": {}}}, {"pq": "match"},
    {"ir": 12}, {"ir": {"gte": 1, "above": 2}}, {"ip": "300.1.1.1"},
    {"fl": "scalar"}, {"shape": "POINT (1 2)"},
    {"ann": "[x](type=person)"}, {"ck": "a", "ck2": "b"}])
def test_refused_documents_match_the_reference(doc):
    jm, pm = MapperService(mappings=ALL_MAPPINGS), DocumentMapper(ALL_MAPPINGS)
    ok_ref = ok_port = True
    try:
        jm.parse("x", doc)
    except Exception:
        ok_ref = False
    try:
        pm.parse("x", doc)
    except Exception:
        ok_port = False
    assert ok_port == ok_ref
    if "ck" not in doc:
        assert not ok_port


def test_join_parent_routing():
    jm, pm = MapperService(mappings=ALL_MAPPINGS), DocumentMapper(ALL_MAPPINGS)
    for doc in ({"rel": {"name": "a", "parent": "p1"}}, {"rel": "q"}, {}):
        assert pm.join_parent_routing(doc) == \
            jm.mapper.join_parent_routing(doc)


@pytest.mark.parametrize("key", ["", "a", "hello", "routing-key-42",
                                 "é-unicode", "x" * 37])
def test_murmur3_hash_matches_the_reference(key):
    assert murmur3_hash(key) == jax_murmur3(key)


# ---------------------------------------------------------------------------
# the reference's tests/test_mapper_extras.py cases
# ---------------------------------------------------------------------------

def test_range_field_intersects(ctx):
    assert matching(ctx, {"range": {"age_range": {
        "gte": 18, "lte": 25}}}) == {0, 1}


def test_range_field_within(ctx):
    assert matching(ctx, {"range": {"age_range": {
        "gte": 5, "lte": 35, "relation": "within"}}}) == {0, 1}


def test_range_field_contains(ctx):
    assert matching(ctx, {"range": {"age_range": {
        "gte": 16, "lte": 18, "relation": "contains"}}}) == {0, 1}


def test_range_field_term_containment(ctx):
    assert matching(ctx, {"term": {"age_range": {"value": 45}}}) == {2}
    assert matching(ctx, {"term": {"age_range": {"value": 15}}}) == {0, 1}


def test_range_field_exists(ctx):
    assert matching(ctx, {"exists": {"field": "age_range"}}) == {0, 1, 2}


def test_range_field_rejects_scalar():
    with pytest.raises(MapperParsingException):
        DocumentMapper(MAPPINGS).parse("x", {"age_range": 12})


def test_date_range_parses_dates():
    p = DocumentMapper(MAPPINGS).parse(
        "x", {"when": {"gte": "2024-01-01", "lt": "2024-02-01"}})
    assert p.numeric_values == MapperService(mappings=MAPPINGS).parse(
        "x", {"when": {"gte": "2024-01-01", "lt": "2024-02-01"}}
    ).numeric_values
    assert p.numeric_values["when.lo"][0] < p.numeric_values["when.hi"][0]


def test_range_unknown_relation_is_a_parsing_error(ctx):
    from elasticsearch_tpu_torch.common.errors import ParsingException
    with pytest.raises(ParsingException):
        parse_query({"range": {"age_range": {"gte": 1, "relation": "over"}}}
                    ).execute(ctx[1])


def test_wildcard_field_wildcard_query(ctx):
    assert matching(ctx, {"wildcard": {"code": {"value": "alpha-*"}}}) == \
        {0, 2}
    assert matching(ctx, {"wildcard": {"code": {"value": "*-456"}}}) == {1}


def test_wildcard_field_term_query(ctx):
    assert matching(ctx, {"term": {"code": "beta-456"}}) == {1}


def test_constant_keyword_term_matches_all(ctx):
    assert matching(ctx, {"term": {"env": "prod"}}) == {0, 1, 2}
    assert matching(ctx, {"term": {"env": "staging"}}) == set()


def test_constant_keyword_exists_matches_all(ctx):
    assert matching(ctx, {"exists": {"field": "env"}}) == {0, 1, 2}


def test_constant_keyword_rejects_other_value():
    with pytest.raises(MapperParsingException):
        DocumentMapper(MAPPINGS).parse("x", {"env": "staging"})


def test_constant_keyword_pins_first_value():
    m = DocumentMapper({"properties": {"dc": {"type": "constant_keyword"}}})
    m.parse("a", {"dc": "us-east"})
    with pytest.raises(MapperParsingException):
        m.parse("b", {"dc": "eu-west"})


def test_sayt_match_on_root(ctx):
    assert matching(ctx, {"match": {"title": "quick"}}) == {0, 1}


def test_sayt_2gram_shingles(ctx):
    assert matching(ctx, {"match": {"title._2gram": "quick brown"}}) == {0}
    assert matching(ctx, {"match": {"title._2gram": "brown fox"}}) == {0}
    assert matching(ctx, {"match": {"title._2gram": "quick"}}) == set()


def test_sayt_3gram_shingles(ctx):
    assert matching(ctx, {"match": {"title._3gram":
                                    "quick brown fox"}}) == {0}


def test_sayt_index_prefix(ctx):
    assert matching(ctx, {"term": {"title._index_prefix": "bra"}}) == {1}
    assert matching(ctx, {"term": {"title._index_prefix": "qu"}}) == {0, 1}


def test_sayt_bool_prefix(ctx):
    assert matching(ctx, {"match_bool_prefix": {"title": "quick br"}}) == \
        {0, 1}


def test_sayt_subfields_hidden_from_mapping():
    props = DocumentMapper(MAPPINGS).to_mapping()["properties"]
    assert "title" in props and "_2gram" not in str(props["title"])
    assert props == MapperService(mappings=MAPPINGS).to_mapping()[
        "properties"]


def test_token_count(ctx):
    assert matching(ctx, {"range": {"title_len": {"gte": 3}}}) == {0}
    assert matching(ctx, {"term": {"title_len": 2}}) == {1}


def test_murmur3_same_value_same_hash(ctx):
    nv = ctx[1].segment.numerics["h"]
    assert nv.values[0] == nv.values[2] and nv.values[0] != nv.values[1]
    np.testing.assert_array_equal(nv.values,
                                  ctx[0].segment.numerics["h"].values)


def test_flattened_keyed_term(flat_ctx):
    assert matching(flat_ctx, {"term": {"labels.priority": "urgent"}}) == {0}
    assert matching(flat_ctx, {"term": {"labels.owner.team": "web"}}) == {1}
    assert matching(flat_ctx, {"term": {"labels.release": "v1.3"}}) == {0}


def test_flattened_root_matches_any_value(flat_ctx):
    assert matching(flat_ctx, {"term": {"labels": "urgent"}}) == {0}
    assert matching(flat_ctx, {"term": {"labels": "infra"}}) == {0}


def test_flattened_rejects_scalar():
    with pytest.raises(MapperParsingException):
        DocumentMapper({"properties": {"labels": {"type": "flattened"}}}
                       ).parse("x", {"labels": "not-an-object"})


@pytest.mark.parametrize("text", [
    "New mayor is [John Smith](John%20Smith&Person) of [Boston](Location)",
    "no markup at all", "[only](a)", "[empty]() and [two](x&y) [x](z)"])
def test_annotated_text_parse(text):
    assert parse_annotated_text(text) == jax_parse_annotated(text)
    plain, anns = parse_annotated_text(
        "New mayor is [John Smith](John%20Smith&Person) of "
        "[Boston](Location)")
    assert plain == "New mayor is John Smith of Boston"
    assert anns == [(13, 23, ["John Smith", "Person"]),
                    (27, 33, ["Location"])]
    with pytest.raises(MapperParsingException):
        parse_annotated_text("[x](type=person)")


def _pair_nodes(tmp_path, mappings, docs, name="t"):
    jax_node = JaxNode(data_path=str(tmp_path))
    node = Node(device="cpu")
    for c in (jax_node.rest_controller, node.rest_controller):
        assert c.dispatch("PUT", f"/{name}", {}, {
            "mappings": mappings,
            "settings": {"index": {"number_of_shards": 1}}})[0] == 200
        bulk = "".join(json.dumps({"index": {"_id": i}}) + "\n"
                       + json.dumps(d) + "\n" for i, d in docs)
        st, r = c.dispatch("POST", f"/{name}/_bulk", {"refresh": "true"},
                           bulk)
        assert st == 200 and not r["errors"], r
    return jax_node, node


def test_annotated_text_search(tmp_path):
    jax_node, node = _pair_nodes(
        tmp_path, {"properties": {"body": {"type": "annotated_text"}}},
        [("1", {"body": "New mayor is [John Smith](Person&q42) of the city"}),
         ("2", {"body": "John Smith went home"})], "news")
    try:
        for body, want in (
                ({"query": {"match": {"body": "smith"}}}, ["1", "2"]),
                ({"query": {"term": {"body": "Person"}}}, ["1"]),
                ({"query": {"term": {"body": "person"}}}, []),
                ({"query": {"match_phrase": {"body": "mayor is john smith"}}},
                 ["1"]),
                ({"query": {"bool": {"must": [
                    {"term": {"body": "q42"}},
                    {"match_phrase": {"body": "john smith of the city"}}]}}},
                 ["1"])):
            st, got = node.rest_controller.dispatch("POST", "/news/_search",
                                                    {}, body)
            st2, ref = jax_node.rest_controller.dispatch(
                "POST", "/news/_search", {}, body)
            assert st == st2 == 200
            assert_same_page(got, ref)
            assert sorted(h["_id"] for h in got["hits"]["hits"]) == want
    finally:
        node.close()
        jax_node.close()


# ---------------------------------------------------------------------------
# ip and the range fields' open bounds, pinned to the reference
# ---------------------------------------------------------------------------

def _ip_docs():
    """Addresses on a few /16 and /24 networks, neighbours of
    192.168.1.10 among them, and docs without one."""
    rng = np.random.default_rng(31)
    docs = []
    for i in range(600):
        net = ["192.168", "10.1", "172.16", "8.8"][int(rng.integers(0, 4))]
        ip = f"{net}.{int(rng.integers(0, 4))}.{int(rng.integers(0, 256))}"
        docs.append({"ip": ip} if i % 17 else {"other": 1})
    docs += [{"ip": f"192.168.1.{k}"} for k in range(0, 20)]
    docs += [{"ip": "2001:db8::1"}, {"ip": "::1"}]
    return docs


IP_MAPPINGS = {"properties": {"ip": {"type": "ip"},
                              "other": {"type": "long"}}}


@pytest.fixture(scope="module")
def ip_ctx():
    return ctx_pair(IP_MAPPINGS, _ip_docs())


def f32_neighbours(docs, ip: str) -> int:
    """Docs whose address differs from ``ip`` but shares its float32
    value: what a term on ``ip`` also matches."""
    want = np.float32(float(int(ipaddress.ip_address(ip))))
    return sum(1 for d in docs if "ip" in d and d["ip"] != ip
               and np.float32(float(int(ipaddress.ip_address(d["ip"]))))
               == want)


@pytest.mark.parametrize("body", [
    {"term": {"ip": "192.168.1.10"}},
    {"term": {"ip": "192.168.1.0/24"}},
    {"term": {"ip": "10.1.0.0/16"}},
    {"term": {"ip": "8.8.3.7/32"}},
    {"range": {"ip": {"gte": "172.16.0.0", "lt": "172.16.2.0"}}},
    {"range": {"ip": {"gt": "192.168.1.10", "lte": "192.168.1.15"}}},
    {"terms": {"ip": ["8.8.0.1", "10.1.2.3"]}},
    {"exists": {"field": "ip"}},
    {"term": {"ip": "::1"}}])
def test_ip_queries_pinned_to_the_reference(ip_ctx, body):
    matching(ip_ctx, body)


def test_ip_term_merges_its_float32_neighbours(ip_ctx):
    """192.168.1.10 is above 2^31, where float32 values are 256 apart:
    its column value is shared by its neighbours on the same /24, and a
    term matches them too, as the reference's does."""
    docs = _ip_docs()
    hits = matching(ip_ctx, {"term": {"ip": "192.168.1.10"}})
    exact = sum(1 for d in docs if d.get("ip") == "192.168.1.10")
    assert len(hits) == exact + f32_neighbours(docs, "192.168.1.10")
    assert f32_neighbours(docs, "192.168.1.10") > 0


def test_ip_bad_cidr_is_illegal_argument(ip_ctx):
    from elasticsearch_tpu_torch.common.errors import \
        IllegalArgumentException
    with pytest.raises(IllegalArgumentException):
        parse_query({"term": {"ip": "1.2.3.4/99"}}).execute(ip_ctx[1])


RANGE_MAPPINGS = {"properties": {"r": {"type": "long_range"},
                                 "d": {"type": "double_range"}}}


@pytest.fixture(scope="module")
def range_ctx():
    rng = np.random.default_rng(32)
    docs = []
    for i in range(300):
        lo = int(rng.integers(-50, 50))
        a, b = float(rng.uniform(-5, 5)), float(rng.uniform(0, 3))
        kind = i % 4
        r = ({"gte": lo, "lte": lo + 10}, {"gt": lo, "lt": lo + 10},
             {"gte": lo}, {"lt": lo})[kind]
        docs.append({"r": r, "d": {"gt": a, "lte": a + b}} if i % 13
                    else {})
    return ctx_pair(RANGE_MAPPINGS, docs)


@pytest.mark.parametrize("body", [
    {"range": {"r": {"gte": 0, "lte": 5}}},
    {"range": {"r": {"gt": -20, "lt": 40, "relation": "within"}}},
    {"range": {"r": {"gte": 3, "lte": 4, "relation": "contains"}}},
    {"range": {"r": {"gt": 10, "relation": "intersects"}}},
    {"range": {"d": {"gt": 0.5, "lt": 2.5, "relation": "within"}}},
    {"range": {"d": {"gte": -1, "lte": 1, "relation": "contains"}}},
    {"term": {"r": 7}}, {"term": {"d": 0.25}},
    {"exists": {"field": "d"}}])
def test_range_relations_pinned_to_the_reference(range_ctx, body):
    assert matching(range_ctx, body)


def test_open_bound_acts_closed_on_the_float32_column(range_ctx):
    """``gt: lo`` stores nextafter(lo) in float64, which float32 rounds
    back to lo: a term on lo still matches, on both sides."""
    m = DocumentMapper(RANGE_MAPPINGS)
    p = m.parse("x", {"r": {"gt": 5, "lt": 9}})
    assert p.numeric_values["r.lo"][0] == np.nextafter(5.0, np.inf)
    assert np.float32(p.numeric_values["r.lo"][0]) == np.float32(5.0)
    ctx = ctx_pair(RANGE_MAPPINGS, [{"r": {"gt": 5, "lt": 9}}])
    assert matching(ctx, {"term": {"r": 5}}) == {0}
    assert matching(ctx, {"term": {"r": 9}}) == {0}


# ---------------------------------------------------------------------------
# the slice test: one bulk of every new type through both nodes
# ---------------------------------------------------------------------------

def slice_docs(n=240, seed=33):
    rng = np.random.default_rng(seed)
    words = ["disk", "full", "error", "quick", "brown", "fox", "alpha",
             "beta", "gamma", "delta", "lake", "river"]
    docs = []
    for i in range(n):
        lo = int(rng.integers(0, 100))
        lat, lon = float(rng.uniform(40, 55)), float(rng.uniform(-5, 15))
        d = {
            "ip": f"10.{int(rng.integers(0, 3))}.{int(rng.integers(0, 4))}."
                  f"{int(rng.integers(0, 256))}",
            "ir": {"gte": lo, "lte": lo + int(rng.integers(0, 30))},
            "dater": {"gte": 1704067200000 + lo * 3600000,
                      "lt": 1704067200000 + (lo + 5) * 3600000},
            "ipr": {"gte": f"10.0.{lo}.0", "lte": f"10.0.{lo}.255"},
            "loc": {"lat": round(lat, 5), "lon": round(lon, 5)},
            "shape": {"type": "envelope", "coordinates": [
                [round(lon - 0.5, 4), round(lat + 0.5, 4)],
                [round(lon + 0.5, 4), round(lat - 0.5, 4)]]},
            "ck": "eu-west",
            "w": f"{words[i % 12]}-{int(rng.integers(100, 999))}",
            "fl": {"tier": ["gold", "silver", "bronze"][i % 3],
                   "owner": {"team": words[i % 5]}},
            "tc": " ".join(rng.choice(words, int(rng.integers(1, 8)))),
            "m3": words[i % 7],
            "ann": f"the [{words[i % 12]}](E{i % 4}) "
                   f"{' '.join(rng.choice(words, 3))}",
            "sayt": " ".join(rng.choice(words, int(rng.integers(2, 6)))),
            "msg": " ".join(rng.choice(words, int(rng.integers(2, 9)))),
            "items": [{"sku": f"s{int(rng.integers(0, 6))}",
                       "n": int(rng.integers(0, 10))}
                      for _ in range(int(rng.integers(0, 4)))],
        }
        if i % 10 == 0:
            d["rel"] = "q"
        elif i % 10 < 4:
            d["rel"] = {"name": "a", "parent": str(i - i % 10)}
        if i % 29 == 0:
            d["pq"] = {"match": {"msg": words[i % 12]}}
        if i % 23 == 0:
            del d["loc"], d["ip"]
        docs.append((str(i), d))
    return docs


SLICE_BODIES = [
    {"query": {"term": {"ip": "10.1.2.0/24"}}, "size": 50},
    {"query": {"range": {"ip": {"gte": "10.0.0.0", "lt": "10.0.3.0"}}},
     "size": 30, "sort": [{"ip": "asc"}, "_doc"]},
    {"query": {"range": {"ir": {"gte": 40, "lte": 45,
                                "relation": "contains"}}}, "size": 50},
    {"query": {"range": {"dater": {"gte": 1704067200000 + 20 * 3600000,
                                   "lte": 1704067200000 + 60 * 3600000,
                                   "relation": "within"}}}, "size": 50},
    {"query": {"term": {"ipr": "10.0.17.3"}}, "size": 20},
    {"query": {"bool": {"must": [{"match": {"msg": "disk error"}}],
                        "filter": [{"term": {"ck": "eu-west"}},
                                   {"exists": {"field": "ir"}}]}}},
    {"query": {"term": {"fl.tier": "gold"}}, "size": 5,
     "sort": [{"m3": "desc"}, "_doc"]},
    {"query": {"term": {"fl": "quick"}}, "size": 100},
    {"query": {"wildcard": {"w": {"value": "ga*-*"}}}, "size": 100},
    {"query": {"range": {"tc": {"gte": 5}}}, "size": 100},
    {"query": {"match": {"ann": "alpha river"}}, "size": 100},
    {"query": {"term": {"ann": "E3"}}, "size": 100},
    {"query": {"match_bool_prefix": {"sayt": "quick bro"}}, "size": 30},
    {"query": {"multi_match": {"query": "lake riv", "type": "bool_prefix",
                               "fields": ["sayt", "sayt._2gram",
                                          "sayt._3gram"]}}, "size": 30},
    {"query": {"match": {"sayt._2gram": "lake river"}}},
    {"query": {"match": {"sayt._3gram": "gamma fox fox"}}},
    {"query": {"geo_distance": {"distance": "300km",
                                "loc": {"lat": 48.0, "lon": 5.0}}},
     "size": 40, "sort": [{"_geo_distance": {"loc": [5.0, 48.0],
                                             "unit": "km"}}]},
    {"query": {"geo_shape": {"shape": {"shape": {
        "type": "envelope", "coordinates": [[0, 50], [6, 45]]},
        "relation": "within"}}}, "size": 50},
    {"query": {"has_child": {"type": "a", "query": {"match": {
        "msg": "quick"}}, "score_mode": "max"}}, "size": 30},
    {"query": {"has_parent": {"parent_type": "q", "query": {"match": {
        "msg": "fox"}}, "score": True}}, "size": 30},
    {"query": {"parent_id": {"type": "a", "id": "30"}}},
    {"query": {"nested": {"path": "items", "query": {"bool": {"must": [
        {"term": {"items.sku": "s2"}}, {"range": {"items.n": {"gte": 5}}}]}},
        "inner_hits": {"size": 2}}}, "size": 30},
    {"query": {"percolate": {"field": "pq", "document": {
        "msg": "disk error on the lake"}}}, "size": 20},
    {"query": {"term": {"rel": "q"}}, "size": 5},
    {"query": {"exists": {"field": "loc"}}, "size": 0},
]


@pytest.fixture(scope="module")
def slice_nodes(tmp_path_factory):
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("slice")))
    node = Node(device="cpu")
    docs = slice_docs()
    for c in (jax_node.rest_controller, node.rest_controller):
        assert c.dispatch("PUT", "/all", {}, {
            "mappings": ALL_MAPPINGS,
            "settings": {"index": {"number_of_shards": 1}}})[0] == 200
        for lo, hi in ((0, 150), (150, len(docs))):
            bulk = "".join(json.dumps({"index": {"_id": i}}) + "\n"
                           + json.dumps(d) + "\n" for i, d in docs[lo:hi])
            st, r = c.dispatch("POST", "/all/_bulk", {"refresh": "true"},
                               bulk)
            assert st == 200 and not r["errors"], r
        st, r = c.dispatch("POST", "/all/_bulk", {"refresh": "true"},
                           "".join(json.dumps({"delete": {"_id": i}}) + "\n"
                                   for i in ("7", "151", "200")))
        assert st == 200 and not r["errors"], r
    yield jax_node, node
    node.close()
    jax_node.close()


def _plan_path(node, body) -> bool:
    """Whether the port's plan path serves ``body`` (where the reference's
    does): its float32 prefix sums may order a tie apart."""
    if body.get("sort"):
        return False
    searcher = node.search_service._shard_searchers(node.indices["all"])[0]
    query = parse_query(body["query"]).rewrite(searcher)
    return compile_plan(query, searcher) is not None


@pytest.mark.parametrize("bi", range(len(SLICE_BODIES)))
def test_slice_bodies_match_the_reference(slice_nodes, bi):
    jax_node, node = slice_nodes
    body = SLICE_BODIES[bi]
    plan = _plan_path(node, body)
    st, got = node.rest_controller.dispatch("POST", "/all/_search", {},
                                            body)
    ref_body = dict(body, size=body.get("size", 10) + 1) if plan else body
    st2, ref = jax_node.rest_controller.dispatch("POST", "/all/_search", {},
                                                 ref_body)
    assert st == st2 == 200, (got, ref)
    if plan:
        assert_same_hits(got, ref, body.get("size", 10), rtol=1e-5)
    else:
        assert_same_page(got, ref)
        for a, b in zip(got["hits"]["hits"], ref["hits"]["hits"]):
            assert a.get("fields") == b.get("fields")
            assert a.get("inner_hits") == b.get("inner_hits")
    assert got["hits"]["total"]["value"] > 0, body
