"""The port's analysis against the reference's, on the CPU.

- Every case of the reference's tests/test_analysis.py, asserted on the
  port's registry and compared token by token (term, position, offsets)
  with the reference's answer on the same text.
- Every builtin analyzer, tokenizer, token filter and char filter over
  seeded English-like texts (corpus.py ``english_docs``: inflected forms,
  stop words, HTML markup, accented, hyphenated and camel-case words),
  token by token against the reference's.
- A mapped index per builtin analyzer, plus the custom chains of
  corpus.py ``ANALYSIS_SETTINGS``, searched through both nodes by
  ``match``, ``match_phrase``, a highlight and ``more_like_this``: ids,
  order and totals equal, scores rtol 1e-5.
- `_analyze` bodies (named, ad hoc chains of names and inline
  definitions, the index's own components, ``explain``, lists of texts)
  and `_termvectors`/`_mtermvectors` bodies equal to the reference's
  answers, with the reference's `_termvectors` cases of
  tests/test_search_utils.py. The one departure, `_analyze` with
  ``field`` on a field of another analyzer, is held by its own test.
- The fast path's gate: an index is registered with the front only when
  its text field indexes and searches with the builtin standard analyzer
  itself, so a redefined ``default`` or ``standard`` is refused.

Tolerance: tokens, ids, order, totals, highlights and term vectors are
exact; BM25 scores rtol 1e-5 (float32 against the reference's float32).
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.analysis import AnalysisRegistry as JaxRegistry
from elasticsearch_tpu.analysis import filters as jfilters
from elasticsearch_tpu.analysis.tokenizers import Token as JaxToken
from elasticsearch_tpu.common.errors import \
    IllegalArgumentException as JaxIllegalArgument
from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.analysis import filters as pfilters
from elasticsearch_tpu_torch.analysis.analyzers import (AnalysisRegistry,
                                                        StandardAnalyzer,
                                                        is_builtin_standard)
from elasticsearch_tpu_torch.analysis.tokenizers import (StandardTokenizer,
                                                         Token)
from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.corpus import (ANALYSIS_MAPPINGS,
                                            ANALYSIS_SETTINGS, EN_ACCENTED,
                                            EN_CAMEL, EN_HYPHENATED,
                                            english_docs)
from elasticsearch_tpu_torch.node import Node
from test_torch_node import assert_same_hits


def rows(tokens):
    return [(t.term, t.position, t.start_offset, t.end_offset)
            for t in tokens]


def registries(settings=None):
    return (JaxRegistry(Settings.from_dict(settings or {})),
            AnalysisRegistry(settings or {}))


def same_tokens(settings, name, text):
    """The port's tokens of ``text`` through analyzer ``name``, after
    asserting them equal to the reference's."""
    jreg, preg = registries(settings)
    want = rows(jreg.get(name).analyze(text))
    got = rows(preg.get(name).analyze(text))
    assert got == want, (name, text)
    return [t for t, *_ in got]


# ------------------------------------------- tests/test_analysis.py


def test_standard_analyzer():
    assert same_tokens(None, "standard",
                       "The Quick-Brown Fox, jumped over 2 dogs!") == [
        "the", "quick", "brown", "fox", "jumped", "over", "2", "dogs"]


def test_standard_tokenizer_offsets_positions():
    toks = StandardTokenizer().tokenize("foo bar")
    assert toks == [Token("foo", 0, 0, 3), Token("bar", 1, 4, 7)]
    from elasticsearch_tpu.analysis.tokenizers import \
        StandardTokenizer as JaxStandard
    assert rows(toks) == rows(JaxStandard().tokenize("foo bar"))


def test_whitespace_and_keyword():
    assert same_tokens(None, "whitespace", "Foo Bar-Baz") == ["Foo",
                                                              "Bar-Baz"]
    assert same_tokens(None, "keyword", "New York") == ["New York"]


def test_stop_analyzer():
    assert same_tokens(None, "stop", "the quick fox") == ["quick", "fox"]


def test_english_analyzer_stems():
    assert same_tokens(None, "english", "running quickly") == ["run",
                                                               "quickli"]


@pytest.mark.parametrize("word,stem", [
    ("caresses", "caress"), ("ponies", "poni"), ("cats", "cat"),
    ("feed", "feed"), ("agreed", "agre"), ("plastered", "plaster"),
    ("motoring", "motor"), ("sing", "sing"), ("conflated", "conflat"),
    ("troubled", "troubl"), ("sized", "size"), ("hopping", "hop"),
    ("falling", "fall"), ("hissing", "hiss"), ("happy", "happi"),
    ("relational", "relat"), ("conditional", "condit"),
    ("vietnamization", "vietnam"), ("predication", "predic"),
    ("feudalism", "feudal"), ("hopefulness", "hope"),
    ("formalize", "formal"), ("electricity", "electr"),
    ("adjustable", "adjust"), ("defensible", "defens"),
    ("effective", "effect"), ("probate", "probat"), ("rate", "rate"),
    ("controlling", "control"), ("rolling", "roll"),
])
def test_porter_stemmer_vectors(word, stem):
    assert pfilters.PorterStemFilter()._stem(word) == stem
    assert (pfilters.PorterStemFilter().filter([Token(word, 0, 0, 1)])[0]
            .term == jfilters.PorterStemFilter()._stem(word) == stem)


def test_unicode_folding():
    settings = {
        "index.analysis.analyzer.folded.type": "custom",
        "index.analysis.analyzer.folded.tokenizer": "standard",
        "index.analysis.analyzer.folded.filter": ["lowercase",
                                                  "asciifolding"]}
    assert same_tokens(settings, "folded", "Crème Brûlée") == ["creme",
                                                               "brulee"]


def test_custom_analyzer_from_settings():
    settings = {
        "index.analysis.filter.my_stop.type": "stop",
        "index.analysis.filter.my_stop.stopwords": ["foo"],
        "index.analysis.analyzer.my.type": "custom",
        "index.analysis.analyzer.my.tokenizer": "whitespace",
        "index.analysis.analyzer.my.filter": ["lowercase", "my_stop"]}
    assert same_tokens(settings, "my", "Foo BAR baz") == ["bar", "baz"]


def test_html_strip_char_filter():
    settings = {
        "index.analysis.analyzer.h.type": "custom",
        "index.analysis.analyzer.h.tokenizer": "standard",
        "index.analysis.analyzer.h.char_filter": ["html_strip"],
        "index.analysis.analyzer.h.filter": ["lowercase"]}
    assert same_tokens(settings, "h", "<p>Hello &amp; <b>World</b></p>") \
        == ["hello", "world"]


def test_unknown_analyzer_raises():
    jreg, preg = registries()
    with pytest.raises(JaxIllegalArgument) as jerr:
        jreg.get("nope")
    with pytest.raises(IllegalArgumentException) as perr:
        preg.get("nope")
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("group,name", [
    ("filter", "made_up"), ("char_filter", "made_up"),
    ("tokenizer", "made_up")])
def test_unknown_filter_raises(group, name):
    """An unknown token filter (the reference's case), char filter or
    tokenizer of a custom analyzer: the same reason in both."""
    settings = {
        "index.analysis.analyzer.bad.type": "custom",
        "index.analysis.analyzer.bad.tokenizer": "standard",
        f"index.analysis.analyzer.bad.{group}": (
            name if group == "tokenizer" else [name])}
    with pytest.raises(JaxIllegalArgument) as jerr:
        JaxRegistry(Settings.from_dict(settings))
    with pytest.raises(IllegalArgumentException) as perr:
        AnalysisRegistry(settings)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("group", ["tokenizer", "filter", "char_filter"])
def test_unknown_component_type_raises(group):
    settings = {f"index.analysis.{group}.x.type": "made_up"}
    with pytest.raises(JaxIllegalArgument) as jerr:
        JaxRegistry(Settings.from_dict(settings))
    with pytest.raises(IllegalArgumentException) as perr:
        AnalysisRegistry(settings)
    assert str(perr.value) == str(jerr.value)


def test_shingle_filter():
    settings = {
        "index.analysis.analyzer.sh.type": "custom",
        "index.analysis.analyzer.sh.tokenizer": "whitespace",
        "index.analysis.analyzer.sh.filter": ["shingle"]}
    assert same_tokens(settings, "sh", "a b c") == ["a", "a b", "b", "b c",
                                                    "c"]


def test_ngram_tokenizer():
    settings = {
        "index.analysis.tokenizer.ng.type": "ngram",
        "index.analysis.tokenizer.ng.min_gram": 2,
        "index.analysis.tokenizer.ng.max_gram": 3,
        "index.analysis.analyzer.ng.type": "custom",
        "index.analysis.analyzer.ng.tokenizer": "ng"}
    assert same_tokens(settings, "ng", "abcd") == ["ab", "abc", "bc", "bcd",
                                                   "cd"]


def test_synonym_filter():
    settings = {"index": {"analysis": {
        "filter": {"syn": {"type": "synonym",
                           "synonyms": ["car, auto", "tv => television"]}},
        "analyzer": {"a": {"type": "custom", "tokenizer": "standard",
                           "filter": ["lowercase", "syn"]}}}}}
    assert same_tokens(settings, "a", "my car and tv") == [
        "my", "car", "auto", "and", "television"]
    toks = AnalysisRegistry(settings).get("a").analyze("car")
    assert {t.position for t in toks} == {0}
    same_tokens(settings, "a", "car")


def test_phonetic_filters():
    assert pfilters.soundex("smith") == pfilters.soundex("smyth")
    assert pfilters.soundex("robert") == "R163"
    assert pfilters.metaphone("catherine") == pfilters.metaphone("kathryn")
    for w in ("smith", "smyth", "robert", "catherine", "kathryn", "knight",
              "phone", "xavier", "thomas", "", "a1"):
        assert pfilters.soundex(w) == jfilters.soundex(w)
        assert pfilters.metaphone(w) == jfilters.metaphone(w)
    toks = [Token("smith", 0, 0, 5), Token("kathryn", 1, 6, 13)]
    jtoks = [JaxToken("smith", 0, 0, 5), JaxToken("kathryn", 1, 6, 13)]
    for enc in ("metaphone", "soundex"):
        for replace in (True, False):
            assert rows(pfilters.PhoneticFilter(enc, replace).filter(toks)) \
                == rows(jfilters.PhoneticFilter(enc, replace).filter(jtoks))


def test_word_delimiter_graph():
    settings = {"index": {"analysis": {
        "analyzer": {"a": {"type": "custom", "tokenizer": "whitespace",
                           "filter": ["word_delimiter_graph",
                                      "lowercase"]}}}}}
    assert same_tokens(settings, "a", "PowerShot500 foo-bar") == [
        "power", "shot", "500", "foo", "bar"]


def test_cjk_bigram():
    settings = {"index": {"analysis": {
        "analyzer": {"a": {"type": "custom", "tokenizer": "standard",
                           "filter": ["cjk_bigram"]}}}}}
    assert same_tokens(settings, "a", "日本語 test") == ["日本", "本語",
                                                       "test"]


def test_elision_and_apostrophe():
    settings = {"index": {"analysis": {
        "analyzer": {
            "fr": {"type": "custom", "tokenizer": "whitespace",
                   "filter": ["lowercase", "elision"]},
            "tr": {"type": "custom", "tokenizer": "whitespace",
                   "filter": ["apostrophe"]}}}}}
    assert same_tokens(settings, "fr", "l'avion") == ["avion"]
    assert same_tokens(settings, "tr", "Istanbul'da") == ["Istanbul"]


def test_keyword_marker_protects_stemming():
    settings = {"index": {"analysis": {
        "filter": {"km": {"type": "keyword_marker",
                          "keywords": ["running"]}},
        "analyzer": {"a": {"type": "custom", "tokenizer": "standard",
                           "filter": ["lowercase", "km",
                                      "porter_stem"]}}}}}
    assert same_tokens(settings, "a", "running jumping") == ["running",
                                                             "jump"]


def test_word_delimiter_unicode_and_positions():
    f = pfilters.WordDelimiterGraphFilter()
    jf = jfilters.WordDelimiterGraphFilter()
    for term, want in (("café-bar", ["café", "bar"]),
                       ("PowerShot", ["Power", "Shot"]),
                       ("XMLHttp", ["XML", "Http"])):
        toks = f.filter([Token(term, 0, 0, len(term))])
        assert [t.term for t in toks] == want
        assert rows(toks) == rows(jf.filter([JaxToken(term, 0, 0,
                                                      len(term))]))
    toks = f.filter([Token("PowerShot", 0, 0, 9)])
    assert [(t.term, t.position) for t in toks] == [("Power", 0),
                                                    ("Shot", 1)]


def test_keyword_marker_survives_rebuilding_filters():
    settings = {"index": {"analysis": {
        "filter": {"km": {"type": "keyword_marker",
                          "keywords": ["running"]}},
        "analyzer": {"a": {"type": "custom", "tokenizer": "whitespace",
                           "filter": ["km", "lowercase", "asciifolding",
                                      "porter_stem"]}}}}}
    assert same_tokens(settings, "a", "running jumping") == ["running",
                                                             "jump"]


def test_cjk_bigram_preserves_noncjk_positions():
    f = pfilters.CjkBigramFilter()
    toks = f.filter([Token("alpha", 0, 0, 5), Token("gamma", 2, 10, 15)])
    assert [(t.term, t.position) for t in toks] == [("alpha", 0),
                                                    ("gamma", 2)]
    assert rows(toks) == rows(jfilters.CjkBigramFilter().filter(
        [JaxToken("alpha", 0, 0, 5), JaxToken("gamma", 2, 10, 15)]))


def test_analyze_explain_detail(nodes):
    body = {"tokenizer": "standard", "char_filter": ["html_strip"],
            "filter": ["lowercase", "porter_stem"],
            "text": "<b>Running</b> QUICKLY", "explain": True}
    jst, want = nodes[0].rest_controller.dispatch("GET", "/_analyze", None,
                                                  body)
    st, r = nodes[1].rest_controller.dispatch("GET", "/_analyze", None, body)
    assert st == jst == 200 and r == want
    d = r["detail"]
    assert d["custom_analyzer"] is True
    assert d["charfilters"][0]["name"] == "html_strip"
    assert "<b>" not in d["charfilters"][0]["filtered_text"][0]
    assert [t["token"] for t in d["tokenizer"]["tokens"]] == ["Running",
                                                             "QUICKLY"]
    stages = {tf["name"]: [t["token"] for t in tf["tokens"]]
              for tf in d["tokenfilters"]}
    assert stages["lowercase"] == ["running", "quickly"]
    assert stages[list(stages)[-1]][0] == "run"


# --------------------------------------------- every component, seeded

SPECIAL = [" ".join(EN_ACCENTED), " ".join(EN_HYPHENATED),
           " ".join(EN_CAMEL), "<p>Hello &amp; <b>World</b></p> &lt;x&gt;",
           "l'avion d'Istanbul'da qu'il", "日本語 test 東京タワー",
           "٣٤ ١٢٣ digits 42", "", "   ", "a" * 300 + " short",
           "PowerShot500 foo-bar snake_case x.y.z", "The the THE the."]


def seeded_texts(n=120, seed=21):
    docs = english_docs(n, np.random.default_rng(seed))
    return [d["body"] for d in docs] + [d["title"] for d in docs[:20]] \
        + [d["tags"] for d in docs[:20]] + SPECIAL


TEXTS = seeded_texts()

COMPONENTS = {
    # name -> index settings of an analyzer "x"
    **{f"builtin_{a}": {"index.analysis.analyzer.x.type": a}
       for a in ("standard", "simple", "whitespace", "stop", "keyword",
                 "english")},
    **{f"tokenizer_{t}": {"index.analysis.analyzer.x.tokenizer": t}
       for t in ("standard", "whitespace", "keyword", "letter", "pattern",
                 "ngram", "edge_ngram")},
    "tokenizer_standard_max_5": {
        "index.analysis.tokenizer.t5.type": "standard",
        "index.analysis.tokenizer.t5.max_token_length": 5,
        "index.analysis.analyzer.x.tokenizer": "t5"},
    "tokenizer_pattern_comma": {
        "index.analysis.tokenizer.pc.type": "pattern",
        "index.analysis.tokenizer.pc.pattern": "[,.]\\s*",
        "index.analysis.analyzer.x.tokenizer": "pc"},
    "tokenizer_ngram_2_4": {
        "index.analysis.tokenizer.ng.type": "ngram",
        "index.analysis.tokenizer.ng.min_gram": 2,
        "index.analysis.tokenizer.ng.max_gram": 4,
        "index.analysis.analyzer.x.tokenizer": "ng"},
    **{f"filter_{f}": {"index.analysis.analyzer.x.tokenizer": "whitespace",
                       "index.analysis.analyzer.x.filter": [f]}
       for f in ("lowercase", "uppercase", "stop", "asciifolding", "length",
                 "trim", "truncate", "unique", "reverse", "edge_ngram",
                 "shingle", "porter_stem", "stemmer", "kstem", "snowball",
                 "synonym", "elision", "apostrophe", "decimal_digit",
                 "keyword_marker", "word_delimiter", "word_delimiter_graph",
                 "cjk_bigram", "synonym_graph")},
    "filter_stop_list": {
        "index.analysis.filter.s.type": "stop",
        "index.analysis.filter.s.stopwords": "run, walk,the",
        "index.analysis.analyzer.x.tokenizer": "standard",
        "index.analysis.analyzer.x.filter": ["lowercase", "s"]},
    "filter_length_3_6": {
        "index.analysis.filter.l.type": "length",
        "index.analysis.filter.l.min": 3, "index.analysis.filter.l.max": 6,
        "index.analysis.analyzer.x.tokenizer": "standard",
        "index.analysis.analyzer.x.filter": ["l"]},
    "filter_shingle_2_3": {
        "index.analysis.filter.sh.type": "shingle",
        "index.analysis.filter.sh.max_shingle_size": 3,
        "index.analysis.filter.sh.output_unigrams": "false",
        "index.analysis.analyzer.x.tokenizer": "standard",
        "index.analysis.analyzer.x.filter": ["lowercase", "stop", "sh"]},
    "filter_synonym_rules": {
        "index.analysis.filter.sy.type": "synonym",
        "index.analysis.filter.sy.synonyms": ["run, jog, sprint",
                                              "walk => stroll, amble"],
        "index.analysis.analyzer.x.tokenizer": "standard",
        "index.analysis.analyzer.x.filter": ["lowercase", "sy",
                                             "porter_stem"]},
    "filter_keyword_marker_porter": {
        "index.analysis.filter.km.type": "keyword_marker",
        "index.analysis.filter.km.keywords": ["running", "walker"],
        "index.analysis.analyzer.x.tokenizer": "standard",
        "index.analysis.analyzer.x.filter": ["lowercase", "km",
                                             "porter_stem", "reverse"]},
    "filter_word_delimiter_options": {
        "index.analysis.filter.wd.type": "word_delimiter_graph",
        "index.analysis.filter.wd.catenate_all": True,
        "index.analysis.filter.wd.preserve_original": "true",
        "index.analysis.analyzer.x.tokenizer": "whitespace",
        "index.analysis.analyzer.x.filter": ["wd", "lowercase"]},
    "filter_cjk_unigrams": {
        "index.analysis.filter.cj.type": "cjk_bigram",
        "index.analysis.filter.cj.output_unigrams": True,
        "index.analysis.analyzer.x.tokenizer": "standard",
        "index.analysis.analyzer.x.filter": ["cj"]},
    "filter_elision_articles": {
        "index.analysis.filter.el.type": "elision",
        "index.analysis.filter.el.articles": ["d", "qu"],
        "index.analysis.analyzer.x.tokenizer": "whitespace",
        "index.analysis.analyzer.x.filter": ["el"]},
    **{f"char_filter_{c}": {"index.analysis.analyzer.x.tokenizer": "standard",
                            "index.analysis.analyzer.x.char_filter": [c]}
       for c in ("html_strip", "mapping", "pattern_replace")},
    "char_filter_mapping_rules": {
        "index.analysis.char_filter.m.type": "mapping",
        "index.analysis.char_filter.m.mappings": ["& => and", "e => 3"],
        "index.analysis.analyzer.x.tokenizer": "standard",
        "index.analysis.analyzer.x.char_filter": ["m"]},
    "char_filter_pattern_replace_digits": {
        "index.analysis.char_filter.p.type": "pattern_replace",
        "index.analysis.char_filter.p.pattern": "[0-9]+",
        "index.analysis.char_filter.p.replacement": "N",
        "analysis.analyzer.x.tokenizer": "standard",
        "analysis.analyzer.x.char_filter": "p, html_strip"},
    # corpus.py's chains, each under its own name
    "custom_exact": ANALYSIS_SETTINGS,
    "custom_english_syn": ANALYSIS_SETTINGS,
}


@pytest.mark.parametrize("component", sorted(COMPONENTS))
def test_component_equals_the_reference(component):
    """Every text of the seeded set through the component: term,
    position and offsets of each token equal the reference's."""
    settings = COMPONENTS[component]
    jreg, preg = registries(settings)
    name = (component[len("custom_"):] if component.startswith("custom_")
            else "x")
    a, ja = preg.get(name), jreg.get(name)
    for text in TEXTS:
        assert rows(a.analyze(text)) == rows(ja.analyze(text)), text


def test_standard_fast_paths_equal_the_chain():
    """The builtin standard analyzer's TermRun and its ASCII shortcut
    give the tokens of its own chain (tokenizer, then lowercase), as a
    custom analyzer of the same components does."""
    std = StandardAnalyzer()
    chain = AnalysisRegistry({
        "analysis.analyzer.c.tokenizer": "standard",
        "analysis.analyzer.c.filter": ["lowercase"]}).get("c")
    assert is_builtin_standard(std) and not is_builtin_standard(chain)
    for text in TEXTS:
        want = rows(pfilters.LowercaseFilter().filter(
            std.tokenizer.tokenize(text)))
        assert rows(std.analyze(text)) == want
        assert rows(chain.analyze(text)) == want
        assert rows(std.index_terms(text)) == want


# ------------------------------------------------ mapped, searched


def _bulk(index, docs):
    return "".join(json.dumps({"index": {"_index": index, "_id": str(i)}})
                   + "\n" + json.dumps(d) + "\n" for i, d in enumerate(docs))


ANALYZERS = ("standard", "simple", "whitespace", "stop", "keyword",
             "english", "exact", "english_syn")
DOCS = english_docs(150, np.random.default_rng(5))


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """Both nodes: an index "ix_{a}" for each analyzer a (field ``t``,
    its ``t.std`` subfield standard, one shard), "an18" with
    corpus.py's mapping (two shards), "tv" and "tv2" of the reference's
    term vector cases."""
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("analysis")))
    node = Node(device="cpu")
    analysis = ANALYSIS_SETTINGS["index"]["analysis"]
    for c in (jax_node.rest_controller, node.rest_controller):
        for a in ANALYZERS:
            st, r = c.dispatch("PUT", f"/ix_{a}", {}, {
                "settings": {"index": {"number_of_shards": 1,
                                       "analysis": analysis}},
                "mappings": {"properties": {"t": {
                    "type": "text", "analyzer": a,
                    "fields": {"std": {"type": "text"}}},
                    "k": {"type": "keyword"}}}})
            assert st == 200, r
            docs = [{"t": d["body"], "k": d["tags"]} for d in DOCS]
            st, r = c.dispatch("POST", "/_bulk", {"refresh": "true"},
                               _bulk(f"ix_{a}", docs))
            assert st == 200 and not r["errors"], r
        st, r = c.dispatch("PUT", "/an18", {}, {
            "settings": {"index": dict(ANALYSIS_SETTINGS["index"],
                                       number_of_shards=2)},
            "mappings": ANALYSIS_MAPPINGS})
        assert st == 200, r
        st, r = c.dispatch("POST", "/_bulk", {"refresh": "true"},
                           _bulk("an18", DOCS))
        assert st == 200 and not r["errors"], r
        c.dispatch("PUT", "/an18/_alias/an18_alias", {}, None)
    yield jax_node, node
    node.close()
    jax_node.close()


def both(nodes, method, path, params=None, body=None):
    jax_node, node = nodes
    return (jax_node.rest_controller.dispatch(method, path, dict(params or {}),
                                              body),
            node.rest_controller.dispatch(method, path, dict(params or {}),
                                          body))


def search_both(nodes, path, body):
    """Both answers of a `_search`, the reference asked one hit more."""
    jax_node, node = nodes
    size = int(body.get("size", 10))
    ref = jax_node.rest_controller.dispatch("POST", path, {},
                                            dict(body, size=size + 1))
    got = node.rest_controller.dispatch("POST", path, {}, dict(body))
    return ref, got, size


def assert_same_search(ref, got, size, rtol):
    """Statuses 200, the page equal under the tie-aware compare of
    tests/test_torch_node.py (the reference scores in float32 and may
    split a true tie), and each hit's highlight equal."""
    jst, want = ref
    st, r = got
    assert st == jst == 200, (got, ref)
    assert_same_hits(r, want, size, rtol=rtol)
    theirs = {h["_id"]: h.get("highlight") for h in want["hits"]["hits"]}
    for h in r["hits"]["hits"]:
        if h["_id"] in theirs:      # a cut tie may hold other members
            assert h.get("highlight") == theirs[h["_id"]], h


def query_text(seed, n=3):
    rng = np.random.default_rng(seed)
    d = DOCS[int(rng.integers(len(DOCS)))]["body"].split()
    i = int(rng.integers(max(1, len(d) - n)))
    return " ".join(d[i:i + n])


KINDS = {
    "match": lambda f, s: {"query": {"match": {f: query_text(s)}},
                           "size": 20},
    "match_and": lambda f, s: {"query": {"match": {f: {
        "query": query_text(s, 2), "operator": "and"}}}, "size": 20},
    "match_phrase": lambda f, s: {"query": {"match_phrase": {
        f: query_text(s, 2)}}, "size": 20},
    "match_phrase_slop": lambda f, s: {"query": {"match_phrase": {
        f: {"query": query_text(s, 3), "slop": 2}}}, "size": 20},
    "highlight": lambda f, s: {"query": {"match": {f: query_text(s)}},
                               "size": 10, "highlight": {"fields": {f: {}}}},
    "highlight_fvh": lambda f, s: {
        "query": {"bool": {"should": [{"match": {f: query_text(s)}},
                                      {"match": {"t.std": query_text(s)}}]}},
        "size": 10, "highlight": {"fields": {"t": {
            "type": "fvh", "matched_fields": ["t", "t.std"]}}}},
    "more_like_this": lambda f, s: {"query": {"more_like_this": {
        "fields": [f], "like": DOCS[s % len(DOCS)]["body"],
        "unlike": [query_text(s + 1, 2)], "min_term_freq": 1,
        "min_doc_freq": 1}}, "size": 20},
    "mlt_by_id": lambda f, s: {"query": {"more_like_this": {
        "fields": [f], "like": [{"_id": str(s % len(DOCS))}],
        "min_term_freq": 1, "min_doc_freq": 1}}, "size": 20},
}


# the dense executor's scores against the reference's: rtol 1e-5; the
# plan path's: the suite's 1e-4 (the reference's float32 plan sums land
# up to ~4e-5 off float64, tests/test_torch_node.py assert_same_hits)
DENSE_RTOL, PLAN_RTOL = 1e-5, 1e-4


@pytest.mark.parametrize("path", ["plan", "dense"])
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("analyzer", ANALYZERS)
def test_mapped_analyzer_searches_as_the_reference(nodes, analyzer, kind,
                                                   path):
    """Each body as it comes (the plan path where it serves it) and
    with a ``min_score``, which takes the dense executor."""
    for s in range(4):
        body = KINDS[kind]("t", 100 * s + 7)
        if path == "dense":
            body["min_score"] = 1e-9
        ref, got, size = search_both(nodes, f"/ix_{analyzer}/_search", body)
        assert_same_search(ref, got, size,
                           DENSE_RTOL if path == "dense" else PLAN_RTOL)


AN18_BODIES = [
    {"query": {"match": {"body": "running quickly"}}, "size": 50},
    {"query": {"match": {"body": "jog fast"}}, "size": 50},
    {"query": {"match": {"body": "search the walkers"}}, "size": 50},
    {"query": {"match": {"body.exact": "PowerShot real-time café"}},
     "size": 50},
    {"query": {"match": {"body.exact": "<b>runs</b> &amp; cafe"}},
     "size": 50},
    {"query": {"match": {"tags": "PowerPoint jumpation"}}, "size": 50},
    {"query": {"match": {"title": "Running dogs"}}, "size": 50},
    {"query": {"match_phrase": {"body": "run the jump"}}, "size": 50},
    {"query": {"bool": {"must": [{"match": {"body": "run"}}],
                        "filter": [{"match": {"tags": "jumpation"}}]}}},
    {"query": {"multi_match": {"query": "running walks",
                               "fields": ["title", "body", "body.exact"]}},
     "size": 30},
    {"query": {"match": {"body": "runs"}}, "min_score": 1e-9, "size": 30},
    {"query": {"match": {"body": "walking"}}, "size": 10,
     "highlight": {"fields": {"body": {}, "body.exact": {}}}},
    {"query": {"match_bool_prefix": {"body": "running wal"}}, "size": 30},
    {"query": {"intervals": {"body": {"match": {"query": "run jump",
                                                "max_gaps": 3}}}}},
    {"query": {"more_like_this": {"fields": ["body", "body.exact"],
                                  "like": DOCS[3]["body"],
                                  "min_term_freq": 1, "min_doc_freq": 1}}},
    {"size": 0, "aggs": {"sig": {"significant_text": {
        "field": "body", "min_doc_count": 1}}},
     "query": {"match": {"body": "run"}}},
    {"suggest": {"s": {"text": "runing walkng", "term": {"field": "body"}}}},
]


@pytest.mark.parametrize("i", range(len(AN18_BODIES)))
def test_an18_bodies_as_the_reference(nodes, i):
    body = AN18_BODIES[i]
    ref, got, size = search_both(nodes, "/an18/_search", body)
    (jst, want), (st, r) = ref, got
    assert st == jst == 200, (r, want)
    if "aggregations" in want:
        assert r["aggregations"] == want["aggregations"]
    if "suggest" in want:
        assert r["suggest"] == want["suggest"]
    assert_same_search(ref, got, size,
                       DENSE_RTOL if "min_score" in body else PLAN_RTOL)


# ---------------------------------------------- _analyze, term vectors

ANALYZE_BODIES = [
    ("/_analyze", {"text": "The Quick brown-fox"}),
    ("/_analyze", {"analyzer": "english", "text": "Running dogs are fast"}),
    ("/_analyze", {"analyzer": "whitespace", "text": ["a B", "c D e"]}),
    ("/_analyze", {"analyzer": "keyword", "text": "New York"}),
    ("/_analyze", {"analyzer": "stop", "text": "the x1 fox"}),
    ("/_analyze", {"analyzer": "simple", "text": "ab-cd 12ef"}),
    ("/_analyze", {"tokenizer": "whitespace",
                   "filter": ["lowercase", {"type": "stop",
                                            "stopwords": ["b"]}],
                   "text": "A b C"}),
    ("/_analyze", {"tokenizer": {"type": "ngram", "min_gram": 2,
                                 "max_gram": 3}, "text": "abcd"}),
    ("/_analyze", {"tokenizer": "standard",
                   "char_filter": [{"type": "mapping",
                                    "mappings": ["ph => f"]}],
                   "filter": ["asciifolding"], "text": "phönix"}),
    ("/_analyze", {"filter": ["uppercase"], "text": "up it"}),
    ("/_analyze", {"tokenizer": "keyword", "filter": ["reverse"],
                   "text": "abc", "explain": True}),
    ("/_analyze", {"analyzer": "english", "text": "walks", "explain": True}),
    ("/an18/_analyze", {"analyzer": "exact",
                        "text": "<b>PowerShot</b> & the cafés"}),
    ("/an18/_analyze", {"analyzer": "english_syn", "text": "jog fast"}),
    ("/an18/_analyze", {"tokenizer": "pattern",
                        "filter": ["few_stop", "en_syn"],
                        "char_filter": ["amp"], "text": "run & the a"}),
    ("/an18/_analyze", {"analyzer": "exact", "text": ["x-y", "zZ9"],
                        "explain": "true"}),
    ("/an18/_analyze", {"field": "title", "text": "Running Dogs"}),
    ("/an18/_analyze", {"analyzer": "english", "field": "tags",
                        "text": "Running Dogs"}),
]


@pytest.mark.parametrize("i", range(len(ANALYZE_BODIES)))
def test_analyze_equals_the_reference(nodes, i):
    path, body = ANALYZE_BODIES[i]
    for method in ("GET", "POST"):
        ref, got = both(nodes, method, path, None, body)
        assert got == ref


@pytest.mark.parametrize("body", [
    {"analyzer": "made_up", "text": "x"},
    {"tokenizer": "made_up", "text": "x"},
    {"filter": ["made_up"], "text": "x"},
    {"char_filter": [{"type": "made_up"}], "text": "x"}])
def test_analyze_unknown_component_is_the_reference_400(nodes, body):
    (jst, want), (st, r) = both(nodes, "POST", "/_analyze", None, body)
    assert st == jst == 400
    assert r["error"]["type"] == want["error"]["type"]
    assert r["error"]["reason"] == want["error"]["reason"]


def test_analyze_of_a_missing_index_is_404(nodes):
    (jst, want), (st, r) = both(nodes, "POST", "/nope/_analyze", None,
                                {"text": "x"})
    assert st == jst == 404
    assert r["error"]["type"] == want["error"]["type"]


def test_analyze_field_takes_the_field_analyzer(nodes):
    """A departure from the reference, which ignores ``field`` (it
    analyzes with ``standard``): the port takes the field's index
    analyzer, as Elasticsearch does. On a standard field the two agree
    (test_analyze_equals_the_reference)."""
    node = nodes[1]
    st, r = node.rest_controller.dispatch("POST", "/an18/_analyze", None, {
        "field": "body", "text": "Running dogs"})
    assert st == 200
    assert [t["token"] for t in r["tokens"]] == ["run", "dog"]
    st, r = node.rest_controller.dispatch("POST", "/an18/_analyze", None, {
        "field": "tags", "text": "Running Dogs"})
    assert [t["token"] for t in r["tokens"]] == ["Running", "Dogs"]
    jst, j = nodes[0].rest_controller.dispatch("POST", "/an18/_analyze",
                                               None, {"field": "body",
                                                      "text": "Running"})
    assert [t["token"] for t in j["tokens"]] == ["running"]


@pytest.mark.parametrize("doc", [0, 1, 7, 33, 149])
@pytest.mark.parametrize("params", [{}, {"term_statistics": "true"},
                                    {"fields": "body,tags"},
                                    {"fields": "body.exact",
                                     "term_statistics": "true"}])
def test_termvectors_equal_the_reference(nodes, doc, params):
    for index in ("an18", "an18_alias", "ix_english", "ix_exact"):
        ref, got = both(nodes, "GET", f"/{index}/_termvectors/{doc}", params)
        assert got == ref


def test_mtermvectors_equal_the_reference(nodes):
    body = {"docs": [{"_index": "an18", "_id": "3"},
                     {"_index": "nope", "_id": "1"},
                     {"_index": "an18"},
                     {"_index": "ix_stop", "_id": "4",
                      "term_statistics": True},
                     {"_index": "an18", "_id": "999"}]}
    (jst, want), (st, r) = both(nodes, "POST", "/an18/_mtermvectors", None,
                                body)
    assert st == jst == 200
    assert [d["found"] for d in r["docs"]] == [d["found"]
                                               for d in want["docs"]]
    for a, b in zip(r["docs"], want["docs"]):
        if "error" in b:
            assert a["error"]["type"] == b["error"]["type"]
        else:
            assert a == b
    ref, got = both(nodes, "GET", "/an18/_mtermvectors", None,
                    {"ids": ["1", "2", "998"], "term_statistics": True})
    assert got == ref


def _tv_nodes(tmp_path, settings):
    jn = JaxNode(data_path=str(tmp_path / "tvj"))
    pn = Node(device="cpu")
    for n in (jn, pn):
        st, _ = n.rest_controller.dispatch("PUT", "/tv", {}, {
            "settings": settings,
            "mappings": {"properties": {"t": {"type": "text"},
                                        "k": {"type": "keyword"}}}})
        assert st == 200
    return jn, pn


def test_termvectors_api(tmp_path):
    """The reference's tests/test_search_utils.py case, on both nodes."""
    jn, pn = _tv_nodes(tmp_path, {})
    try:
        for n in (jn, pn):
            c = n.rest_controller
            c.dispatch("PUT", "/tv/_doc/1", {}, {"t": "the quick quick fox",
                                                 "k": "skip"})
            c.dispatch("PUT", "/tv/_doc/2", {}, {"t": "lazy fox"})
            c.dispatch("POST", "/tv/_refresh", {}, None)
        ref, got = both((jn, pn), "GET", "/tv/_termvectors/1",
                        {"term_statistics": "true"})
        assert got == ref
        st, r = got
        assert st == 200 and r["found"]
        terms = r["term_vectors"]["t"]["terms"]
        assert terms["quick"]["term_freq"] == 2
        assert len(terms["quick"]["tokens"]) == 2
        assert terms["fox"]["doc_freq"] == 2
        assert "k" not in r["term_vectors"]
        ref, got = both((jn, pn), "GET", "/tv/_termvectors/404")
        assert got == ref and got[1]["found"] is False
        ref, got = both((jn, pn), "POST", "/tv/_mtermvectors", None,
                        {"ids": ["1", "2"]})
        assert got == ref
        assert [d["found"] for d in got[1]["docs"]] == [True, True]
    finally:
        jn.close()
        pn.close()


def test_termvectors_arrays_routing_and_errors(tmp_path):
    """The reference's second case: an array's values 100 positions
    apart, a routed document, per-document errors of `_mtermvectors`."""
    jn, pn = _tv_nodes(tmp_path, {"index.number_of_shards": 3})
    try:
        for n in (jn, pn):
            n.rest_controller.dispatch(
                "PUT", "/tv/_doc/1", {"routing": "abc", "refresh": "true"},
                {"t": ["quick fox", "lazy dog"]})
        ref, got = both((jn, pn), "GET", "/tv/_termvectors/1",
                        {"routing": "abc"})
        assert got == ref
        r = got[1]
        assert r["found"], r
        terms = r["term_vectors"]["t"]["terms"]
        assert set(terms) == {"quick", "fox", "lazy", "dog"}
        assert terms["lazy"]["tokens"][0]["position"] >= 100
        body = {"docs": [{"_index": "nope", "_id": "1"}, {"_index": "tv"},
                         {"_index": "tv", "_id": "1", "routing": "abc"}]}
        (jst, want), (st, r) = both((jn, pn), "POST", "/tv/_mtermvectors",
                                    None, body)
        assert st == jst == 200
        assert [d["found"] for d in r["docs"]] == [False, False, True]
        assert r["docs"][2] == want["docs"][2]
        assert r["docs"][1] == want["docs"][1]
        assert r["docs"][0]["error"]["type"] == want["docs"][0]["error"][
            "type"]
    finally:
        jn.close()
        pn.close()


# ------------------------------------------------------ the fast gate


@pytest.fixture
def started(tmp_path):
    node = Node(device="cpu")
    node.start(0)
    yield node
    node.close()


def _one_index(node, name, settings, field_conf):
    c = node.rest_controller
    st, r = c.dispatch("PUT", f"/{name}", {}, {
        "settings": dict(settings, number_of_shards=1),
        "mappings": {"properties": {"t": field_conf}}})
    assert st == 200, r
    st, r = c.dispatch("POST", "/_bulk", {"refresh": "true"}, _bulk(
        name, [{"t": d["body"]} for d in DOCS[:40]]))
    assert st == 200 and not r["errors"]
    node.refresh_front()


def _registered(node):
    reg = node.fastpath.front_registration()
    return None if reg is None else reg["index"]


REFUSED = {
    "english": ({}, {"type": "text", "analyzer": "english"}),
    "whitespace_search": ({}, {"type": "text",
                               "search_analyzer": "whitespace"}),
    "redefined_default": (
        {"analysis": {"analyzer": {"default": {
            "type": "custom", "tokenizer": "standard",
            "filter": ["lowercase"]}}}},
        {"type": "text", "analyzer": "default"}),
    "unknown_name_to_redefined_default": (
        {"analysis": {"analyzer": {"default": {
            "type": "custom", "tokenizer": "standard",
            "filter": ["lowercase"]}}}},
        {"type": "text", "analyzer": "made_up"}),
    "redefined_standard": (
        {"index.analysis.analyzer.standard.type": "custom",
         "index.analysis.analyzer.standard.tokenizer": "whitespace"},
        {"type": "text"}),
    "custom_same_chain": (
        {"analysis": {"analyzer": {"mine": {
            "type": "custom", "tokenizer": "standard",
            "filter": ["lowercase"]}}}},
        {"type": "text", "analyzer": "mine"}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_fast_gate_refuses_other_analyzers(started, case):
    """The builtin standard field registers; a field of any other
    analyzer (a redefined ``default`` or ``standard``, or a custom chain
    of the standard's own components, included) is refused by the
    front's registration and by ``_search``'s fast grammar, and the
    bodies the plan path then serves answer as the reference's would
    (test_mapped_analyzer_searches_as_the_reference)."""
    node = started
    _one_index(node, "std", {}, {"type": "text"})
    assert _registered(node) == "std"
    settings, conf = REFUSED[case]
    node.rest_controller.dispatch("DELETE", "/std", {}, None)
    _one_index(node, "other", settings, conf)
    assert _registered(node) is None
    svc = node.indices["other"]
    assert not svc.mapper.standard_analyzed(svc.mapper.field_type("t"))
    body = {"query": {"match": {"t": "run"}}, "size": 10}
    assert node.rest_controller._fast_body(svc, body) is None
    st, r = node.rest_controller.dispatch("POST", "/other/_search", {}, body)
    assert st == 200


def test_fast_gate_takes_a_standard_field_beside_a_redefined_default(
        started):
    """A field that names no analyzer indexes with ``standard`` even when
    the index redefines ``default`` (the reference resolves the name
    ``standard``, and falls to ``default`` only for a name it lacks), so
    it is the builtin analyzer and the front registers it."""
    _one_index(started, "std2", REFUSED["redefined_default"][0],
               {"type": "text"})
    assert _registered(started) == "std2"


# --------------------------------------------- segments of token lists

SEG_SETTINGS = {"analysis": {
    "filter": {"wd": {"type": "word_delimiter_graph",
                      "catenate_all": True, "preserve_original": True},
               "syn": {"type": "synonym",
                       "synonyms": ["run, jog, sprint", "walk => stroll"]}},
    "analyzer": {
        "gaps": {"type": "custom", "tokenizer": "whitespace",
                 "filter": ["wd", "lowercase", "stop", "syn",
                            "porter_stem"]}}}}
SEG_MAPPINGS = {"properties": {
    "a": {"type": "text", "analyzer": "gaps"},
    "e": {"type": "text", "analyzer": "english"},
    "w": {"type": "text", "analyzer": "whitespace"},
    "s": {"type": "text"}}}


def _seg_docs(n, seed):
    rng = np.random.default_rng(seed)
    docs = english_docs(n, rng)
    out = []
    for i, d in enumerate(docs):
        text = d["body"]
        if i % 7 == 0:
            # past the stream's 512 positions, with split and catenated
            # words across the cut
            text = " ".join([d["body"]] * 30 + ["PowerShot500 Wi-Fi"] * 8)
        out.append({"a": text, "e": [text, d["title"]], "w": d["tags"],
                    "s": d["title"]})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_segments_of_analyzed_fields_equal_the_reference(seed):
    """Postings and token streams of fields whose analyzers leave
    position gaps (stop words), stack tokens at a position (synonyms,
    preserved and catenated words) and run past the stream's length:
    the field length the count of emitted tokens, a stream slot
    first-write-wins, stopped positions -1 holes, a row cut where the
    reference's loop breaks, all equal to the reference's arrays."""
    from elasticsearch_tpu.index.mapper import MapperService
    from elasticsearch_tpu.index.segment import SegmentWriter as JaxWriter
    from elasticsearch_tpu_torch.index.mapper import DocumentMapper
    from elasticsearch_tpu_torch.index.segment import SegmentWriter
    jm = MapperService(Settings.from_dict(SEG_SETTINGS), SEG_MAPPINGS)
    pm = DocumentMapper(SEG_MAPPINGS, AnalysisRegistry(SEG_SETTINGS))
    jw, pw = JaxWriter(), SegmentWriter()
    for i, d in enumerate(_seg_docs(60, seed)):
        jw.add(jm.parse(str(i), d))
        pw.add(pm.parse(str(i), d))
    js, ps = jw.build("_s"), pw.build("_s")
    assert sorted(ps.postings) == sorted(js.postings)
    for f, pf in ps.postings.items():
        jf = js.postings[f]
        assert pf.terms == list(jf.terms), f
        for a in ("doc_freq", "total_term_freq", "term_block_start",
                  "term_block_count", "block_docids", "block_tfs",
                  "field_lengths"):
            np.testing.assert_array_equal(getattr(pf, a),
                                          np.asarray(getattr(jf, a)),
                                          err_msg=f"{f}.{a}")
    assert sorted(ps.streams) == sorted(js.streams)
    for f, st in ps.streams.items():
        np.testing.assert_array_equal(st.tokens,
                                      np.asarray(js.streams[f].tokens),
                                      err_msg=f)
        np.testing.assert_array_equal(st.lengths,
                                      np.asarray(js.streams[f].lengths),
                                      err_msg=f)
    assert (np.asarray(ps.streams["a"].tokens) == -1).any()


# --------------------- analysis settings through the index metadata


def _search_both(nodes, index, body):
    ref, got, size = search_both(nodes, f"/{index}/_search", body)
    assert_same_search(ref, got, size, PLAN_RTOL)
    return got[1]


def test_analysis_settings_through_templates_streams_and_resize(nodes):
    """An index template's ``analysis`` reaches the index a write
    auto-creates and each backing index of a data stream (rolled over
    too); a clone keeps its source's analyzers: each one's `_analyze`
    and searches on its custom fields as the reference's."""
    analysis = ANALYSIS_SETTINGS["index"]["analysis"]
    mappings = {"properties": {
        "@timestamp": {"type": "date"},
        "msg": {"type": "text", "analyzer": "exact",
                "search_analyzer": "english_syn"}}}
    for name, extra in (("tplan", {}), ("dsan", {"data_stream": {}})):
        ref, got = both(nodes, "PUT", f"/_index_template/{name}", None,
                        dict(extra, index_patterns=[f"{name}-*"],
                             template={"settings": {"analysis": analysis},
                                       "mappings": mappings}))
        assert got[0] == ref[0] == 200, (got, ref)
    lines = "".join(json.dumps(x) + "\n" for i, d in enumerate(DOCS[:60])
                    for x in ({"create": {"_id": str(i)}},
                              {"@timestamp": "2026-01-01T00:00:00Z",
                               "msg": d["body"]}))
    ref, got = both(nodes, "PUT", "/_data_stream/dsan-x")
    assert got[0] == ref[0] == 200
    # (the reference's `_bulk?refresh` on a stream answers 404 after
    # writing: refresh apart)
    for index in ("tplan-1", "dsan-x"):
        ref, got = both(nodes, "POST", f"/{index}/_bulk", None, lines)
        assert got[0] == ref[0] == 200 and not got[1]["errors"]
        both(nodes, "POST", f"/{index}/_refresh")
    ref, got = both(nodes, "POST", "/dsan-x/_rollover", None, {})
    assert got[0] == ref[0] == 200 and got[1]["rolled_over"]
    lines2 = lines.replace('"_id": "', '"_id": "b')
    ref, got = both(nodes, "POST", "/dsan-x/_bulk", None, lines2)
    assert got[0] == ref[0] == 200 and not got[1]["errors"]
    both(nodes, "POST", "/dsan-x/_refresh")
    backing = got[1]["items"][0]["create"]["_index"]
    # a clone of the auto-created index, under a write block
    for path in ("/tplan-1/_block/write", "/tplan-1/_clone/tplan-clone"):
        ref, got = both(nodes, "PUT", path)
        assert got[0] == ref[0] == 200, (got, ref)
    for index in ("tplan-1", backing, "tplan-clone"):
        for body in ({"analyzer": "exact", "text": "<b>PowerShot</b> cafés"},
                     {"analyzer": "english_syn", "text": "jog fast"}):
            ref, got = both(nodes, "POST", f"/{index}/_analyze", None, body)
            assert got == ref, index
    for index in ("tplan-1", "dsan-x", "tplan-clone"):
        for text in ("running walks", "PowerShot real-time", "jog"):
            r = _search_both(nodes, index, {"query": {"match": {
                "msg": text}}, "size": 30})
        assert r["hits"]["total"]["value"] > 0


def test_field_types_with_other_analyzers(nodes):
    """token_count, search_as_you_type (its shingle subfields and
    prefixes) and annotated_text under a non-standard analyzer, searched
    as the reference."""
    mappings = {"properties": {
        "n": {"type": "token_count", "analyzer": "english"},
        "s": {"type": "search_as_you_type", "analyzer": "english"},
        "a": {"type": "annotated_text", "analyzer": "whitespace"}}}
    docs = []
    for i, d in enumerate(DOCS[:80]):
        words = d["body"].split()
        docs.append({"n": d["body"], "s": d["title"],
                     "a": f"[{words[0]}](Anchor{i % 3}&x) " + " ".join(
                         words[1:])})
    for c in (nodes[0].rest_controller, nodes[1].rest_controller):
        st, r = c.dispatch("PUT", "/ftx", {}, {
            "settings": {"index": {"number_of_shards": 1}},
            "mappings": mappings})
        assert st == 200, r
        st, r = c.dispatch("POST", "/_bulk", {"refresh": "true"},
                           _bulk("ftx", docs))
        assert st == 200 and not r["errors"], r
    title = DOCS[4]["title"].split()
    for body in (
            {"query": {"range": {"n": {"gte": 10, "lte": 20}}},
             "size": 100, "sort": [{"n": "asc"}, "_doc"]},
            {"query": {"match_bool_prefix": {
                "s": " ".join(title[:2]) + " " + title[2][:3]}}},
            {"query": {"multi_match": {
                "query": " ".join(title[:2]), "type": "bool_prefix",
                "fields": ["s", "s._2gram", "s._3gram"]}}},
            {"query": {"match_phrase": {"s._2gram": " ".join(title[:3])}}},
            {"query": {"match": {"a": "Anchor1"}}, "size": 50},
            {"query": {"match": {"a": DOCS[7]["body"].split()[2]}}}):
        ref, got, size = search_both(nodes, "/ftx/_search", body)
        assert_same_search(ref, got, size, PLAN_RTOL)
        assert [h.get("sort") for h in got[1]["hits"]["hits"]] == \
            [h.get("sort") for h in ref[1]["hits"]["hits"][:size]]
