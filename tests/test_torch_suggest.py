"""The port's suggesters (search/suggest.py) and completion field against
the reference's, on the CPU.

- ``CompletionValues``: top k under a prefix with weights, contexts and
  deletes, against the reference's class on seeded inputs; built by the
  SegmentWriter, merged with deletes and entered through
  ``segment_from_numpy``, equal to the reference's.
- ``suggest`` over REST on both nodes: the reference's cases of
  tests/test_search_features.py (term, term on a known word, phrase,
  completion over the term dictionary), the options of the term
  suggester (size, max_edits, prefix_length, min_word_length,
  suggest_mode), the phrase suggester's max_errors, and a completion
  field of weighted, context-tagged inputs over two segments with
  deletes. Suggestions are equal, options and scores included.
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.index.segment import CompletionValues as JaxCV
from elasticsearch_tpu.index.segment import SegmentWriter as JaxWriter
from elasticsearch_tpu.index.segment import merge_segments as jax_merge
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.index.segment import (CompletionValues,
                                                   SegmentWriter,
                                                   merge_segments,
                                                   segment_from_numpy)
from elasticsearch_tpu_torch.node import Node

DOCS = [
    {"title": "the quick brown fox", "body": "jumps over the lazy dog",
     "group": "a", "rank": 3},
    {"title": "quick brown rabbits", "body": "rabbits hop quickly away",
     "group": "a", "rank": 1},
    {"title": "brown quick fox", "body": "a fox of a different color",
     "group": "b", "rank": 2},
    {"title": "slow green turtle", "body": "the turtle walks slowly home",
     "group": "b", "rank": 5},
    {"title": "quick silver surfer", "body": "surfing the quick waves",
     "group": "c", "rank": 4},
]

C_MAPPINGS = {"properties": {
    "suggest": {"type": "completion",
                "contexts": [{"name": "genre", "type": "category"}]},
    "title": {"type": "text"}}}
SONGS = ["nevermind", "nirvana", "nine inch nails", "no doubt", "norah",
         "nothing else matters", "numb", "november rain", "new order",
         "nena", "neil young", "nick cave", "nico", "nile rodgers"]
GENRES = ["rock", "pop", "jazz"]


def c_docs():
    rng = np.random.default_rng(21)
    docs = []
    for i in range(60):
        song = SONGS[i % len(SONGS)]
        inputs = [song] if rng.random() < 0.5 else [song, song.split()[0]]
        d = {"title": song,
             "suggest": {"input": inputs,
                         "weight": int(rng.integers(1, 100))}}
        if rng.random() < 0.6:
            d["suggest"]["contexts"] = {
                "genre": list(rng.choice(GENRES, int(rng.integers(1, 3)),
                                         replace=False))}
        if i % 9 == 0:
            d["suggest"] = song                 # a bare string input
        docs.append(d)
    return docs


def _bulk(docs, lo, hi):
    return "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                   + json.dumps(docs[i]) + "\n" for i in range(lo, hi))


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """Both nodes with "idx" (DOCS) and "songs" (c_docs, two segments
    with deletes)."""
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("suggest")))
    node = Node(device="cpu")
    cdocs = c_docs()
    for c in (jax_node.rest_controller, node.rest_controller):
        for name, mappings, docs, parts in (
                ("idx", None, DOCS, [(0, 5)]),
                ("songs", C_MAPPINGS, cdocs, [(0, 35), (35, 60)])):
            body = {"settings": {"index": {"number_of_shards": 1}}}
            if mappings:
                body["mappings"] = mappings
            assert c.dispatch("PUT", f"/{name}", {}, body)[0] == 200
            for lo, hi in parts:
                st, r = c.dispatch("POST", f"/{name}/_bulk",
                                   {"refresh": "true"}, _bulk(docs, lo, hi))
                assert st == 200 and not r["errors"], r
        deletes = "".join(json.dumps({"delete": {"_id": str(i)}}) + "\n"
                          for i in (1, 14, 40))
        st, r = c.dispatch("POST", "/songs/_bulk", {"refresh": "true"},
                           deletes)
        assert st == 200 and not r["errors"], r
    yield jax_node, node
    node.close()
    jax_node.close()


def suggest(nodes, index, spec, **extra):
    jax_node, node = nodes
    body = {"suggest": spec, "size": 0, **extra}
    st, got = node.rest_controller.dispatch("POST", f"/{index}/_search",
                                            {}, body)
    st2, ref = jax_node.rest_controller.dispatch(
        "POST", f"/{index}/_search", {}, body)
    assert st == st2 == 200, (got, ref)
    assert got["suggest"] == ref["suggest"]
    return got["suggest"]


# ---------------------------------------------------------------------------
# CompletionValues
# ---------------------------------------------------------------------------

def _inputs(seed, n=400):
    rng = np.random.default_rng(seed)
    letters = list("abcde")
    inputs = ["".join(rng.choice(letters, int(rng.integers(1, 6))))
              for _ in range(n)]
    weights = rng.integers(0, 20, n).astype(np.float64)
    doc_of = rng.integers(0, n // 2, n)
    ctxs = [frozenset(f"g={g}" for g in rng.choice(
        ["x", "y", "z"], int(rng.integers(0, 3)), replace=False))
        for _ in range(n)]
    live = rng.random(n // 2) > 0.2
    return inputs, weights, doc_of, ctxs, live


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("prefix", ["", "a", "ab", "cde", "e", "zz"])
def test_completion_top_k_as_the_reference(seed, prefix):
    inputs, weights, doc_of, ctxs, live = _inputs(seed)
    port = CompletionValues("f", inputs, weights, doc_of, ctxs)
    ref = JaxCV("f", inputs, weights, doc_of, ctxs)
    assert port.inputs == ref.inputs
    for k in (1, 5, 40):
        for cf in (None, frozenset({"g=x"}), frozenset({"g=x", "g=y"})):
            for lv in (None, live):
                assert port.top_k(prefix, k, cf, lv) == \
                    ref.top_k(prefix, k, cf, lv), (k, cf)


def _segments(docs, split):
    jm, pm = MapperService(mappings=C_MAPPINGS), DocumentMapper(C_MAPPINGS)
    out = {}
    for pkg, mapper, writer in (("jax", jm, JaxWriter),
                                ("port", pm, SegmentWriter)):
        w1, w2 = writer(), writer()
        for i, d in enumerate(docs):
            (w1 if i < split else w2).add(mapper.parse(str(i), d))
        out[pkg] = [w1.build("s1"), w2.build("s2")]
    return out


def assert_same_completions(cv, jcv):
    assert cv.inputs == jcv.inputs
    np.testing.assert_array_equal(cv.weights, jcv.weights)
    np.testing.assert_array_equal(cv.doc_of, jcv.doc_of)
    assert cv.contexts == jcv.contexts


def test_completions_build_and_merge_as_the_reference():
    segs = _segments(c_docs(), 35)
    for p, j in zip(segs["port"], segs["jax"]):
        assert set(p.completions) == set(j.completions) == {"suggest"}
        assert_same_completions(p.completions["suggest"],
                                j.completions["suggest"])
    for s in segs["port"] + segs["jax"]:
        s.delete(3)
    merged = merge_segments("m", segs["port"])
    jmerged = jax_merge("m", segs["jax"])
    assert_same_completions(merged.completions["suggest"],
                            jmerged.completions["suggest"])
    cv = merged.completions["suggest"]
    got = segment_from_numpy({
        "numerics": {"x": {"values": np.zeros(merged.n_docs)}},
        "completions": {"suggest": {
            "inputs": cv.inputs, "weights": cv.weights,
            "doc_of": cv.doc_of, "contexts": cv.contexts}}})
    assert_same_completions(got.completions["suggest"], cv)


# ---------------------------------------------------------------------------
# suggest over REST
# ---------------------------------------------------------------------------

def test_term_suggester(nodes):
    out = suggest(nodes, "idx", {
        "my-suggestion": {"text": "quikc", "term": {"field": "title"}}})
    entries = out["my-suggestion"]
    assert entries[0]["text"] == "quikc"
    assert "quick" in [o["text"] for o in entries[0]["options"]]


def test_term_suggester_existing_word_no_options(nodes):
    out = suggest(nodes, "idx", {
        "s": {"text": "quick", "term": {"field": "title"}}})
    assert out["s"][0]["options"] == []


def test_phrase_suggester(nodes):
    out = suggest(nodes, "idx", {
        "s": {"text": "quikc brown", "phrase": {"field": "title"}}})
    assert "quick brown" in [o["text"] for o in out["s"][0]["options"]]


def test_completion_suggester_over_the_term_dictionary(nodes):
    out = suggest(nodes, "idx", {
        "s": {"prefix": "qu", "completion": {"field": "title"}}})
    assert "quick" in [o["text"] for o in out["s"][0]["options"]]


@pytest.mark.parametrize("spec", [
    {"text": "brwn qick foks", "term": {"field": "title"}},
    {"text": "brwn qick", "term": {"field": "title", "size": 1}},
    {"text": "rabits turle", "term": {"field": "title", "max_edits": 1}},
    {"text": "qwick", "term": {"field": "title", "prefix_length": 0}},
    {"text": "fox bro", "term": {"field": "title", "min_word_length": 2}},
    {"text": "quick brown", "term": {"field": "title",
                                     "suggest_mode": "always"}},
    {"text": "quick brown", "term": {"field": "title",
                                     "suggest_mode": "popular"}},
    {"text": "jumsp ovr", "term": {"field": "body"}},
    {"text": "slwo gren turtel", "phrase": {"field": "title"}},
    {"text": "slwo gren turtel", "phrase": {"field": "title",
                                            "max_errors": 2, "size": 3}},
    {"text": "qick brwn", "phrase": {"field": "title",
                                     "max_errors": 0.5}},
    {"text": "", "phrase": {"field": "title"}},
    {"prefix": "b", "completion": {"field": "title", "size": 2}},
    {"prefix": "s", "completion": {"field": "body"}},
    {"prefix": "", "completion": {"field": "group.keyword"}},
])
def test_suggest_options_as_the_reference(nodes, spec):
    suggest(nodes, "idx", {"s": spec})


def test_global_text_and_several_suggesters(nodes):
    suggest(nodes, "idx", {"text": "quikc brwn",
                           "a": {"term": {"field": "title"}},
                           "b": {"phrase": {"field": "title"}},
                           "c": {"text": "tur", "completion": {
                               "field": "title"}}},
            query={"match": {"title": "fox"}})


@pytest.mark.parametrize("prefix", ["n", "ne", "ni", "no", "nov", "x", ""])
@pytest.mark.parametrize("extra", [{}, {"size": 3},
                                   {"contexts": {"genre": ["rock"]}},
                                   {"contexts": {"genre": ["rock", "pop"]}},
                                   {"contexts": {"genre": "jazz"},
                                    "size": 10}])
def test_completion_field(nodes, prefix, extra):
    """A completion field's prefix index over two segments with deletes:
    weights order the options, contexts filter them, a deleted doc's
    inputs never come back."""
    out = suggest(nodes, "songs", {"s": {
        "prefix": prefix, "completion": {"field": "suggest", **extra}}})
    ids = [o["_id"] for o in out["s"][0]["options"]]
    assert not {"1", "14", "40"} & set(ids)
