"""The port's highlighter against the reference's, on the CPU, over REST
on both nodes.

- The seven cases of the reference's tests/test_highlight.py, asserted
  on the port's answer and compared with the reference's: fragments
  sized and scored, ``number_of_fragments: 0``, ``no_match_size``,
  custom tags with ``order: none``, ``type: plain``, ``type: fvh`` with
  ``matched_fields`` and fragments centred on a match. The
  matched_fields case's subfield is standard-analyzed here (the
  reference's is ``whitespace``; the port's analysis has the standard
  analyzer only, ROADMAP Queue 1 item 7).
- One body per query family of the full-text slice (phrases, multi-term
  queries, fuzzy, intervals, spans, query_string, simple_query_string,
  more_like_this, ...) and the compound queries: the port highlights
  exactly what the reference does (the terms ``_collect_terms`` visits;
  a phrase or multi-term query highlights nothing).

The answers are equal: ids, order, totals, and each hit's highlight
fragments; scores rtol 1e-5 on the dense executor, or the tie-aware
compare of tests/test_torch_plan.py where the plan path serves.
"""

import json

import pytest

from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.node import Node
from test_torch_fetch import assert_same

PARA = (
    "The quick brown fox jumps over the lazy dog. "
    "Weather today is mild and calm with little wind. "
    "A second fox appeared near the river bank at dawn. "
    "Nothing else of note happened during the long morning hours. "
    "Later the fox and the wolf crossed the old wooden bridge together. "
    "The afternoon passed quietly in the small village square. "
    "Finally the wolf returned alone under a pale evening sky."
)
FILLER = "lorem ipsum dolor sit amet " * 20
ZEBRA = FILLER + "the zebra appears here " + FILLER

MORE = [
    "A fox and a wolf met near the quick river.",
    "Brown bears, brown foxes and one wolf in the forest.",
    "The river bank was quiet; no fox today. Dawn came late.",
    "Quickly the wolves crossed the bridge at dawn.",
]


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """Both nodes with "hl" (the reference's two docs and four more),
    "books2" (a title with a subfield) and "books3" (the zebra doc)."""
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("hl")))
    node = Node(device="cpu")
    indices = {
        "hl": ({"body": {"type": "text"}, "tag": {"type": "keyword"}},
               [{"body": PARA, "tag": "para"},
                {"body": "no matching words here", "tag": "none"}]
               + [{"body": t, "tag": "more"} for t in MORE]),
        "books2": ({"title": {"type": "text",
                              "fields": {"exact": {"type": "text"}}}},
                   [{"title": "Running with Scissors"}]),
        "books3": (None, [{"body": ZEBRA}]),
    }
    for c in (jax_node.rest_controller, node.rest_controller):
        for name, (props, docs) in indices.items():
            body = {"settings": {"index": {"number_of_shards": 1}}}
            if props:
                body["mappings"] = {"properties": props}
            assert c.dispatch("PUT", f"/{name}", {}, body)[0] == 200
            bulk = "".join(json.dumps({"index": {"_id": str(i + 1)}})
                           + "\n" + json.dumps(d) + "\n"
                           for i, d in enumerate(docs))
            st, r = c.dispatch("POST", f"/{name}/_bulk",
                               {"refresh": "true"}, bulk)
            assert st == 200 and not r["errors"], r
    yield jax_node, node
    node.close()
    jax_node.close()


def search(nodes, index, body):
    """The port's answer, checked equal to the reference's."""
    jax_node, node = nodes
    st, got = node.rest_controller.dispatch("POST", f"/{index}/_search",
                                            {}, body)
    st2, ref = jax_node.rest_controller.dispatch(
        "POST", f"/{index}/_search", {}, body)
    assert st == st2 == 200, (got, ref)
    assert_same(got, ref)
    return got


def hit(out, _id):
    return next(h for h in out["hits"]["hits"] if h["_id"] == _id)


# ---------------------------------------------------------------------------
# the reference's tests/test_highlight.py
# ---------------------------------------------------------------------------

def test_fragments_are_sized_and_scored(nodes):
    out = search(nodes, "hl", {
        "query": {"match": {"body": "fox wolf"}}, "size": 1,
        "sort": [{"tag": "desc"}],
        "highlight": {"fields": {"body": {
            "fragment_size": 80, "number_of_fragments": 3}}}})
    frags = hit(out, "1")["highlight"]["body"]
    assert 1 <= len(frags) <= 3
    assert all(len(f) < len(PARA) for f in frags)
    assert all(len(f) <= 80 + 60 for f in frags)   # sentence-snap slack
    # score order: the best passage (fox AND wolf) comes first
    assert "<em>fox</em>" in frags[0] and "<em>wolf</em>" in frags[0]


def test_number_of_fragments_zero_highlights_whole_field(nodes):
    out = search(nodes, "hl", {
        "query": {"match": {"body": "fox"}}, "sort": [{"tag": "desc"}],
        "highlight": {"fields": {"body": {"number_of_fragments": 0}}}})
    frags = hit(out, "1")["highlight"]["body"]
    assert len(frags) == 1
    assert frags[0].count("<em>fox</em>") == 3
    assert frags[0].replace("<em>", "").replace("</em>", "") == PARA


def test_no_match_size(nodes):
    out = search(nodes, "hl", {
        "query": {"match_all": {}},
        "highlight": {"fields": {"body": {"no_match_size": 60}}}})
    frags = hit(out, "2")["highlight"]["body"]
    assert len(frags) == 1 and "<em>" not in frags[0]
    assert 0 < len(frags[0]) <= 120
    out2 = search(nodes, "hl", {
        "query": {"match": {"body": "fox"}}, "sort": [{"tag": "desc"}],
        "highlight": {"fields": {"body": {}}}})
    assert "body" in hit(out2, "1")["highlight"]


def test_custom_tags_and_source_order(nodes):
    out = search(nodes, "hl", {
        "query": {"match": {"body": "wolf"}}, "sort": [{"tag": "desc"}],
        "highlight": {"pre_tags": ["[["], "post_tags": ["]]"],
                      "fields": {"body": {
                          "fragment_size": 60,
                          "number_of_fragments": 5,
                          "order": "none"}}}})
    frags = hit(out, "1")["highlight"]["body"]
    assert any("[[wolf]]" in f for f in frags)
    pos = [PARA.find(f.replace("[[", "").replace("]]", "")[:25])
           for f in frags]
    assert pos == sorted(pos)


def test_plain_type_keeps_whole_field(nodes):
    out = search(nodes, "hl", {
        "query": {"match": {"body": "fox"}}, "sort": [{"tag": "desc"}],
        "highlight": {"fields": {"body": {"type": "plain"}}}})
    frags = hit(out, "1")["highlight"]["body"]
    assert len(frags) == 1
    assert frags[0].replace("<em>", "").replace("</em>", "") == PARA


def test_fvh_matched_fields_merges_subfield_hits(nodes):
    out = search(nodes, "books2", {
        "query": {"match": {"title.exact": "Running"}},
        "highlight": {"fields": {"title": {
            "type": "fvh",
            "matched_fields": ["title", "title.exact"]}}}})
    frag = out["hits"]["hits"][0]["highlight"]["title"][0]
    assert frag.count("<em>") == 1
    assert "<em>Running</em>" in frag


def test_fvh_fragments_center_on_matches(nodes):
    out = search(nodes, "books3", {
        "query": {"match": {"body": "zebra"}},
        "highlight": {"fields": {"body": {
            "type": "fvh", "fragment_size": 60,
            "number_of_fragments": 2}}}})
    frags = out["hits"]["hits"][0]["highlight"]["body"]
    assert len(frags) >= 1
    assert "<em>zebra</em>" in frags[0]
    assert len(frags[0]) < 140


# ---------------------------------------------------------------------------
# every query family: the port highlights what the reference does
# ---------------------------------------------------------------------------

FAMILIES = [
    {"match": {"body": "quick river"}},
    {"match": {"body": {"query": "fox wolf", "operator": "and"}}},
    {"multi_match": {"query": "fox dawn", "fields": ["body", "tag"]}},
    {"term": {"body": "wolf"}},
    {"terms": {"body": ["fox", "bridge"]}},
    {"bool": {"must": [{"match": {"body": "fox"}}],
              "should": [{"match": {"body": "dawn"}}],
              "filter": [{"term": {"tag": "more"}}],
              "must_not": [{"match": {"body": "bears"}}]}},
    {"constant_score": {"filter": {"match": {"body": "wolf"}}}},
    {"dis_max": {"queries": [{"match": {"body": "fox"}},
                             {"match": {"body": "river"}}]}},
    {"boosting": {"positive": {"match": {"body": "fox"}},
                  "negative": {"match": {"body": "wolf"}},
                  "negative_boost": 0.5}},
    {"function_score": {"query": {"match": {"body": "dawn"}},
                        "functions": [{"weight": 2.0}]}},
    {"script_score": {"query": {"match": {"body": "bridge"}},
                      "script": {"source": "_score * 2"}}},
    {"match_phrase": {"body": "the wolf"}},
    {"match_phrase": {"body": {"query": "fox wolf", "slop": 3}}},
    {"match_phrase_prefix": {"body": "river ba"}},
    {"match_bool_prefix": {"body": "quick riv"}},
    {"prefix": {"body": "wol"}},
    {"wildcard": {"body": "f*x"}},
    {"regexp": {"body": "bri.*"}},
    {"fuzzy": {"body": "wolv"}},
    {"query_string": {"query": "body:fox AND body:wolf"}},
    {"query_string": {"query": "dawn OR bridge", "default_field": "body"}},
    {"simple_query_string": {"query": "fox +river", "fields": ["body"]}},
    {"more_like_this": {"fields": ["body"],
                        "like": "fox wolf river bridge dawn",
                        "min_term_freq": 1, "min_doc_freq": 1}},
    {"intervals": {"body": {"match": {"query": "fox wolf",
                                      "max_gaps": 5}}}},
    {"span_term": {"body": "fox"}},
    {"span_near": {"clauses": [{"span_term": {"body": "fox"}},
                               {"span_term": {"body": "wolf"}}],
                   "slop": 3, "in_order": True}},
    {"terms_set": {"body": {"terms": ["fox", "wolf"],
                            "minimum_should_match_script": {
                                "source": "1"}}}},
]


@pytest.mark.parametrize("query", FAMILIES)
@pytest.mark.parametrize("htype", ["unified", "plain", "fvh"])
def test_query_family_highlights_as_the_reference(nodes, query, htype):
    search(nodes, "hl", {
        "query": query, "size": 10, "sort": [{"tag": "desc"}, "_doc"],
        "highlight": {"fields": {"body": {"type": htype,
                                          "fragment_size": 50},
                                 "tag": {}}}})
