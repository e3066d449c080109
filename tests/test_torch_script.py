"""Script scoring in the port against the reference, on the CPU.

The same seeded inputs go through both packages:

- the expression tier (search/script.py ``compile_script``) over seeded
  float32 columns: arithmetic, comparisons, every ``Math`` function,
  ``saturation``, ``sigmoid``, ``params``, ``.value``, ``.size()``,
  ``.empty`` and ``_score``; the sandbox's refusals; the straight-line
  fold; the Painless interpreter on the programs of
  tests/test_painless.py;
- ``script_score``, ``function_score`` and the vector functions
  (cosineSimilarity, dotProduct, l2norm on cosine, dot_product and
  l2_norm slabs) at the ops level, on the reference's query fixture;
- the plan path (the reference's tests/test_plan.py script cases
  through both ``ShardSearcher``s), NaN, -inf, +inf and negative script
  values on both executors, the PlanBatcher's cohorts (one script per
  cohort) and block-max pruning under a script;
- ``_search`` on both nodes: the rescorer (the reference's
  tests/test_search_features.py cases and every ``score_mode``), and
  BASELINE config 3's bodies on the same ``_bulk``-indexed documents.

Tolerances: expression columns equal to rtol 1e-6, transcendental
``Math`` functions (log, log10, sqrt, exp, pow, sigmoid) within 2 ulps
(XLA's and PyTorch's float32 implementations round differently), NaN
in the same places; dense-executor answers exact in ids, order and
totals with scores rtol 1e-5 (vector functions rtol 1e-5: the float32
sums of a bfloat16 product run in another order); plan-path answers
with test_torch_plan's tie-aware rtol 1e-4 compare.
"""

import ast
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elasticsearch_tpu.search.plan as jplan
import elasticsearch_tpu.search.script as jscript
from elasticsearch_tpu.common.errors import \
    ScriptException as JaxScriptException
from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.index.segment import SegmentWriter as JaxWriter
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.ops.device import DeviceSegment as JaxDeviceSegment
from elasticsearch_tpu.script import compile_painless as jax_painless
from elasticsearch_tpu.search.context import \
    DeviceSegmentCache as JaxSegmentCache
from elasticsearch_tpu.search.context import SegmentContext as JaxContext
from elasticsearch_tpu.search.context import ShardStats as JaxStats
from elasticsearch_tpu.search.queries import parse_query as jax_parse
from elasticsearch_tpu.search.searcher import ShardSearcher as JaxSearcher
from elasticsearch_tpu_torch.common.errors import ScriptException
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops.device import READBACKS, DeviceSegment
from elasticsearch_tpu_torch.script import compile_painless
from elasticsearch_tpu_torch.search import plan as tplan
from elasticsearch_tpu_torch.search import script as tscript
from elasticsearch_tpu_torch.search.batching import PlanBatcher
from elasticsearch_tpu_torch.search.context import (DeviceSegmentCache,
                                                    SegmentContext,
                                                    ShardStats)
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported
from elasticsearch_tpu_torch.search.plan import compile_plan
from elasticsearch_tpu_torch.search.queries import ParsingException, parse_query
from elasticsearch_tpu_torch.search.searcher import ShardSearcher
from test_torch_node import assert_same_hits, bulk_body, http
from test_torch_plan import as_hits, both, searchers  # noqa: F401

RTOL = 1e-5
PLAN_RTOL = 1e-4
MAX_ULPS = 2

# ---------------------------------------------------------------------------
# the expression tier
# ---------------------------------------------------------------------------

N = 96
_rng = np.random.default_rng(5)
COLS = {"a": ((_rng.random(N) * 10).astype(np.float32), _rng.random(N) < 0.2),
        "b": ((_rng.standard_normal(N) * 3).astype(np.float32),
              _rng.random(N) < 0.1)}
SCORE = (_rng.random(N) * 5).astype(np.float32)
PARAMS = {"pivot": 4, "k": 2.0, "e": 0.6, "w": 1.25}

EXPRESSIONS = [
    "doc['a'].value * 2 + _score",
    "doc['a'].value - doc['b'].value / 3",
    "doc['a'].value % 3",
    "doc['b'].value // 2",
    "doc['a'].value ** 2",
    "-doc['b'].value + +_score",
    "(doc['a'].value > 5) * 1.5 + (doc['b'].value <= 0)",
    "doc['a'].value == doc['a'].value",
    "doc['a'].value != 2",
    "doc['a'].value < _score",
    "doc['a'].value >= 3",
    "Math.log(doc['a'].value + 1)",
    "Math.log10(doc['a'].value + 1)",
    "Math.sqrt(doc['a'].value)",
    "Math.exp(_score / 5)",
    "Math.abs(doc['b'].value)",
    "Math.min(doc['a'].value, 3)",
    "Math.max(2, doc['b'].value)",
    "Math.pow(doc['a'].value, 1.5)",
    "Math.pow(2, _score)",
    "Math.floor(doc['b'].value)",
    "Math.ceil(doc['b'].value)",
    "Math.E * _score + Math.PI",
    "Math.log(2) * _score",
    "Math.sqrt(params.k) + _score",
    "Math.max(Math.min(doc['a'].value, _score), 1)",
    "saturation(doc['a'].value, params.pivot)",
    "sigmoid(doc['a'].value + 1, params.k, params.e)",
    "params.w * _score",
    "params['w'] + doc['a'].value",
    "doc['a'].size() + doc['b'].size()",
    "doc['a'].empty * 3.0",
    "_score",
    "3",
    "params.k * 2.5 if params.w > 1 else 0",
    "True * _score",
    "Math.log(doc['b'].value)",
    "Math.sqrt(doc['b'].value)",
    "1 / (doc['a'].value - doc['a'].value)",
    "double x = doc['a'].value * 2; double y = x + 1.5; return y * _score;",
]
_TRANSCENDENTAL = ("Math.log", "Math.sqrt", "Math.exp", "Math.pow",
                   "sigmoid")


def jax_expression(src):
    c = jscript.compile_script(src)
    ctx = jscript.ScriptContext(
        lambda f: jscript._DocColumn(jnp.asarray(COLS[f][0]),
                                     jnp.asarray(COLS[f][1])),
        PARAMS, score=jnp.asarray(SCORE))
    return c.vectorized, np.asarray(jnp.broadcast_to(
        jnp.asarray(c(ctx), jnp.float32), (N,)))


def port_expression(src):
    c = tscript.compile_script(src)
    ctx = tscript.ScriptContext(
        lambda f: tscript._DocColumn(torch.from_numpy(COLS[f][0]),
                                     torch.from_numpy(COLS[f][1])),
        PARAMS, score=torch.from_numpy(SCORE))
    return c.vectorized, tscript.as_column(c(ctx), N, "cpu").numpy()


@pytest.mark.parametrize("src", EXPRESSIONS)
def test_expression_tier_matches_reference(src):
    (jv, ref), (pv, got) = jax_expression(src), port_expression(src)
    assert jv is pv is True
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(ref)],
                                  ref[~fin & ~np.isnan(ref)])
    if any(t in src for t in _TRANSCENDENTAL):
        ulps = np.abs(got[fin].view(np.int32).astype(np.int64)
                      - ref[fin].view(np.int32).astype(np.int64))
        assert ulps.max(initial=0) <= MAX_ULPS, src
    else:
        np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=0)


def test_math_lifts_numbers_to_float32_on_the_column_device():
    col = torch.ones(3, dtype=torch.float32)
    for fn in ("log", "sqrt", "exp", "abs", "floor", "ceil", "log10"):
        out = getattr(tscript._Math, fn)(2)
        assert out.dtype == torch.float32 and out.ndim == 0
        ref = np.asarray(getattr(jscript._Math, fn)(2.0))
        assert np.asarray(out) == ref, fn
    assert tscript._Math.max(col, 3).dtype == torch.float32
    assert tscript._Math.pow(2, col).device == col.device
    d = tscript._DocColumn(col, torch.tensor([False, True, False]))
    assert d.size().dtype == torch.int32
    assert d.size().tolist() == [1, 0, 1]


SANDBOX = [
    "__import__('os').system('x')",
    "open('/etc/passwd')",
    "doc.__class__",
    "_score.__class__.__bases__",
    "params.__class__",
    "[x for x in [1, 2]]",
    "exec('1')",
    "(lambda: 1)()",
    "getattr(doc, 'x')",
]


@pytest.mark.parametrize("src", SANDBOX)
def test_sandbox_refuses_as_the_reference(src):
    with pytest.raises(JaxScriptException):
        jax_parse({"script_score": {"query": {"match_all": {}},
                                    "script": {"source": src}}})
    with pytest.raises(ScriptException):
        parse_query({"script_score": {"query": {"match_all": {}},
                                      "script": {"source": src}}})


@pytest.mark.parametrize("src", [
    "a and b", "_score and 1", "1 if _score else 2", "not _score",
    "params.nope * 2", "doc['a'].value.foo"])
def test_runtime_errors_are_script_exceptions(src):
    with pytest.raises(JaxScriptException):
        jax_expression(src)
    with pytest.raises(ScriptException):
        port_expression(src)


# torch tensors are mutable where jax arrays are not: an in-place method
# on a column would overwrite the resident doc values
IN_PLACE = ["doc['a'].value.zero_()", "doc['a'].value.add_(1)",
            "doc['a'].empty.fill_(True)", "_score.zero_()",
            "doc['b'].value.copy_(_score)"]


@pytest.mark.parametrize("src", IN_PLACE)
def test_in_place_methods_are_refused(src):
    before = {f: (v.copy(), m.copy()) for f, (v, m) in COLS.items()}
    score = SCORE.copy()
    with pytest.raises(JaxScriptException):
        jax_expression(src)
    with pytest.raises(ScriptException):
        port_expression(src)
    with pytest.raises(ScriptException):
        tscript._validate(ast.parse(src, mode="eval"), src)
    for f, (v, m) in before.items():
        np.testing.assert_array_equal(COLS[f][0], v)
        np.testing.assert_array_equal(COLS[f][1], m)
    np.testing.assert_array_equal(SCORE, score)


DESUGAR = [
    "double boost = doc['rank'].value * 2; double adj = boost + 1.5; "
    "return adj * _score;",
    "double s=0; for (int i=0;i<2;i++){s+=1;} return s;",
    "double a = 7 / 2; return a;",
    "int a = 5; return a / 2;",
    "def a = doc['rank'].value; return a / 2;",
    "def a = doc['rank'].value; return a * 2;",
    "double x = doc['a'].value; x = x * x; return x + _score;",
    "float f = doc['a;b'].value; return f + 1;",
    "return _score;",
    "return;",
    "double q = 'it''s'; return q;",
    "x = 1",
]


@pytest.mark.parametrize("src", DESUGAR)
def test_straightline_fold_matches_reference(src):
    assert tscript._desugar_straightline(src) == \
        jscript._desugar_straightline(src)


@pytest.mark.parametrize("src", DESUGAR[:7])
def test_tier_choice_matches_reference(src):
    assert tscript.compile_script(src).vectorized is \
        jscript.compile_script(src).vectorized


# the programs of tests/test_painless.py (the language tests), with their
# environments; each runs through both packages' compile_painless
PAINLESS = [
    ("""int total = 0;
        for (int i = 1; i <= 10; i++) { total += i; }
        int j = 0;
        while (j < 3) { total += 100; j++; }
        do { total += 1000; } while (false);
        return total;""", {}),
    ("""int fib(int n) { if (n < 2) return n; return fib(n-1)+fib(n-2); }
        return fib(12);""", {}),
    ("""def out = [];
        for (def w : params.words) {
            if (w.length() > 3) { out.add(w.toUpperCase()); }
        }
        Map counts = [:];
        for (def w : out) { counts[w] = w.length(); }
        return counts;""", {"params": {"words": ["a", "hello", "worlds",
                                                  "xy"]}}),
    ("return -7 / 2;", {}),
    ("return -7 % 3;", {}),
    ("return 7 / 2;", {}),
    ("return 7.0 / 2;", {}),
    ("return 1 + 'x' + null + true;", {}),
    ("return params.a?.b ?: 42;", {"params": {"a": None}}),
    ("return params.a?.b ?: 42;", {"params": {"a": {"b": 7}}}),
    ("return params.x > 3 ? 'big' : 'small';", {"params": {"x": 5}}),
    ("return 'Quick Fox'.toLowerCase().contains('fox');", {}),
    ("def l = [3,1,2]; l.sort((a,b) -> a - b); return l;", {}),
    ("def m = ['a': 1]; m.merge('a', 5, (x, y) -> x + y); return m.a;", {}),
    ("return ''.__class__;", {}),
    ("return params.__globals__;", {"params": {}}),
    ("return 'x'.encode();", {}),
    ("def f = Math.log; return f.__self__;", {}),
    ("while (true) { int x = 1; }", {}),
    ("""try { throw new IllegalArgumentException('boom'); }
        catch (Exception e) { return 'caught:' + e.getMessage(); }""", {}),
    ("return (int) 3.9;", {}),
    ("double d = 3; return d / 2;", {}),
    ("return ((double) 3) / 2;", {}),
    ("return params.v instanceof String;", {"params": {"v": "s"}}),
    ("return params.v instanceof List;", {"params": {"v": [1]}}),
    ("""StringBuilder sb = new StringBuilder();
        for (int i = 0; i < 3; i++) { sb.append(i).append(','); }
        return sb.toString();""", {}),
    ("return Math.max(Math.abs(-5), 3) + Integer.parseInt('10');", {}),
    ("return String.join('-', ['a','b','c']);", {}),
    ("int x = ;", {}),
]


def _outcome(compile_fn, src, env):
    try:
        return "ok", compile_fn(src).execute(dict(env))
    except Exception as e:   # compared with the other package's below
        return type(e).__name__, str(e)


@pytest.mark.parametrize("pi", range(len(PAINLESS)))
def test_painless_programs_match_reference(pi):
    src, env = PAINLESS[pi]
    got = _outcome(compile_painless, src, env)
    ref = _outcome(jax_painless, src, env)
    assert got == ref
    if got[0] != "ok":
        with pytest.raises(ScriptException):
            compile_painless(src).execute(dict(env))


# ---------------------------------------------------------------------------
# ops level: the reference's query fixture with vector fields
# ---------------------------------------------------------------------------

Q_MAPPINGS = {"properties": {
    "title": {"type": "text"},
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "views": {"type": "long"},
    "price": {"type": "float"},
    "flag": {"type": "boolean"},
    "vec": {"type": "dense_vector", "dims": 4, "similarity": "cosine"},
    "vdot": {"type": "dense_vector", "dims": 4,
             "similarity": "dot_product"},
    "vl2": {"type": "dense_vector", "dims": 4, "similarity": "l2_norm"},
}}
Q_DOCS = [
    {"title": "quick brown fox", "body": "jumps over the lazy dog",
     "tag": "animal", "views": 10, "price": 1.5, "flag": True,
     "vec": [1.0, 0.0, 0.0, 0.0]},
    {"title": "quick red fox", "body": "eats the quick rabbit",
     "tag": "animal", "views": 50, "price": 2.5, "flag": False,
     "vec": [0.0, 1.0, 0.0, 0.0]},
    {"title": "slow green turtle", "body": "swims in the sea",
     "tag": "reptile", "views": 5, "price": 3.5, "flag": True,
     "vec": [0.9, 0.1, 0.0, 0.0]},
    {"title": "lazy dog", "body": "sleeps all day",
     "tag": "animal", "views": 100, "flag": False},
]
_vr = np.random.default_rng(17)
for _d in Q_DOCS:
    _u = _vr.standard_normal(4)
    _d["vdot"] = (_u / np.linalg.norm(_u)).round(4).tolist()
    _d["vl2"] = (_vr.standard_normal(4) * 2).round(3).tolist()

QV = [0.6, -0.2, 0.3, 0.5]
OPS_CASES = [
    # the reference's tests/test_queries.py script cases
    {"script_score": {"query": {"term": {"tag": "animal"}},
                      "script": {"source": "doc['views'].value * 2 + _score"}}},
    {"script_score": {"query": {"match_all": {}},
                      "script": {"source": "cosineSimilarity(params.qv, "
                                           "'vec') + 1.0",
                                 "params": {"qv": [1.0, 0.0, 0.0, 0.0]}}}},
    {"function_score": {"query": {"term": {"tag": "animal"}},
                        "script_score": {"script": {
                            "source": "doc['views'].value"}},
                        "boost_mode": "replace"}},
    # the vector functions on every similarity
    *[{"script_score": {"query": {"match": {"title": "quick fox"}},
                        "script": {"source": f"{fn}(params.qv, '{f}') + 2",
                                   "params": {"qv": QV}}}}
      for fn in ("cosineSimilarity", "dotProduct", "l2norm")
      for f in ("vec", "vdot", "vl2")],
    # function_score: weights, score_mode, boost_mode, boost
    *[{"function_score": {"query": {"match": {"title": "quick fox"}},
                          "functions": [
                              {"script_score": {"script": {
                                  "source": "doc['price'].value + 1"}},
                               "weight": 2.0},
                              {"weight": 3.0}],
                          "score_mode": mode, "boost_mode": bmode,
                          "boost": 1.5}}
      for mode in ("multiply", "sum")
      for bmode in ("multiply", "sum", "replace")],
    {"script_score": {"query": {"match_all": {}},
                      "script": {"source": "doc['views'].value / 10"},
                      "min_score": 2.0}},
    {"script_score": {"query": {"bool": {"filter": [
        {"term": {"tag": "animal"}}]}},
        "script": {"source": "_score + doc['price'].size() * 4"},
        "boost": 2.0}},
    {"script_score": {"query": {"match": {"body": "the"}},
                      "script": {"source": """
                          double s = 0;
                          if (doc['views'].value > 20) { s = 1; }
                          return s + doc['views'].value;"""}}},
]


@pytest.fixture(scope="module")
def qctx():
    jm, pm = MapperService(mappings=Q_MAPPINGS), DocumentMapper(Q_MAPPINGS)
    jw, pw = JaxWriter(), SegmentWriter()
    for i, d in enumerate(Q_DOCS):
        jw.add(jm.parse(str(i), d))
        pw.add(pm.parse(str(i), d))
    js, ps = jw.build("s0"), pw.build("s0")
    return (JaxContext(js, JaxDeviceSegment(js), jm, JaxStats([js])),
            SegmentContext(ps, DeviceSegment(ps, "cpu"), pm,
                           ShardStats([ps])))


@pytest.mark.parametrize("ci", range(len(OPS_CASES)))
def test_script_queries_match_reference(qctx, ci):
    jctx, pctx = qctx
    js, jm = jax_parse(OPS_CASES[ci]).execute(jctx)
    ps, pm = parse_query(OPS_CASES[ci]).execute(pctx)
    assert ps.dtype == torch.float32
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=RTOL,
                               atol=1e-6)


def test_reference_query_assertions_hold_on_the_port(qctx):
    """The reference's own assertions of tests/test_queries.py."""
    _, pctx = qctx

    def run(body):
        s, m = parse_query(body).execute(pctx)
        return s.numpy()[:4], m.numpy()[:4]
    base, _ = run({"term": {"tag": "animal"}})
    s, _ = run(OPS_CASES[0])
    np.testing.assert_allclose(s[0], 20 + base[0], rtol=1e-5)
    assert s[2] == 0.0
    s, _ = run(OPS_CASES[1])
    assert s[0] == pytest.approx(2.0, abs=1e-2)
    assert s[2] == pytest.approx(1.0 + 0.9 / np.sqrt(0.82), abs=1e-2)
    assert s[1] == pytest.approx(1.0, abs=1e-2)
    s, _ = run(OPS_CASES[2])
    assert s[0] == 10 and s[1] == 50 and s[3] == 100
    q = parse_query({"script_score": {"query": {"match_all": {}},
                                      "script": {"source": "params.nope * 2"}}})
    with pytest.raises(ScriptException):
        q.execute(pctx)


def test_typed_refusals():
    """The function_score shapes this slice does not serve are typed
    400s; a stored-script reference parsed outside a node's request and
    a script without source or id are parse errors, as the
    reference's."""
    with pytest.raises(ParsingException, match="stored script"):
        parse_query({"script_score": {"query": {"match_all": {}},
                                      "script": {"id": "s1"}}})
    with pytest.raises(SliceUnsupported):
        parse_query({"function_score": {"query": {"match_all": {}},
                                        "functions": [{"gauss": {}}]}})
    with pytest.raises(SliceUnsupported):
        parse_query({"function_score": {"query": {"match_all": {}},
                                        "score_mode": "avg"}})
    with pytest.raises(SliceUnsupported):
        parse_query({"function_score": {"query": {"match_all": {}},
                                        "max_boost": 3}})
    with pytest.raises(ValueError, match="source"):
        parse_query({"script_score": {"query": {"match_all": {}},
                                      "script": {"params": {}}}})


# ---------------------------------------------------------------------------
# the plan path (the reference's tests/test_plan.py script cases)
# ---------------------------------------------------------------------------

PLAN_CASES = [
    ({"script_score": {
        "query": {"match": {"title": "alpha beta"}},
        "script": {"source": "doc['views'].value * 0.5 + _score"}}}, True),
    ({"script_score": {
        "query": {"bool": {"must": [{"match": {"title": "wolf"}}],
                           "filter": [{"term": {"tag": "red"}}]}},
        "script": {
            "source": "saturation(doc['views'].value, params.pivot) "
                      "+ Math.log(1 + _score)",
            "params": {"pivot": 10}}}}, True),
    ({"script_score": {
        "query": {"match": {"title": "alpha"}},
        "script": {"source": """
            double s = 0;
            for (int i = 0; i < 2; i++) { s += doc['views'].value; }
            return s + _score;
        """}}}, False),
    ({"script_score": {
        "query": {"match": {"title": "alpha"}},
        "script": {"source": "_score * 2"},
        "min_score": 1.5}}, False),
    ({"script_score": {
        "query": {"match": {"title": "alpha"}},
        "script": {"source": "_score * 2"}, "boost": 3.0}}, False),
    ({"script_score": {
        "query": {"multi_match": {"query": "fox dog",
                                  "fields": ["title", "body"]}},
        "script": {"source": "double f = doc['views'].value; "
                             "return f * f / 100 + _score;"}}}, True),
    ({"script_score": {
        "query": {"match": {"title": "alpha"}},
        "script": {"source": "Math.max(params.a, 1) * Math.log(10)",
                   "params": {"a": 3}}}}, True),
]


@pytest.mark.parametrize("size", [10, 500])
@pytest.mark.parametrize("ci", range(len(PLAN_CASES)))
def test_plan_script_cases_match_reference(searchers, ci, size):  # noqa: F811
    body, plannable = PLAN_CASES[ci]
    ref, port = searchers
    plan = compile_plan(parse_query(body), port)
    assert (plan is not None and plan.script is not None) == plannable
    jp = jplan.compile_plan(jax_parse(body), ref)
    got, want = both(searchers, body, size)
    assert got["hits"]["total"]["value"] > 0
    if ci == 4:
        # the reference plans a boosted script_score and drops its boost
        # there (ROADMAP Queue 3); the port's dense executor applies it,
        # as the reference's dense executor does
        assert jp is not None
        dense = dense_both(searchers, body, size)[1]
        assert [h["_score"] for h in want["hits"]["hits"]] != \
            [h["_score"] for h in dense["hits"]["hits"]]
        want = dense
    else:
        assert (jp is not None) == plannable
    assert_same_hits(got, want, size, rtol=PLAN_RTOL)


def dense_both(pair, body, size):
    """The port's dense executor and the reference's (collect_masks
    forces it) on ``body``, as ``assert_same_hits`` takes them."""
    ref, port = pair
    r = ref.query_phase(jax_parse(body), size + 1, collect_masks=True)
    p = port.query_phase(parse_query(body), size, allow_plan=False)
    return as_hits(p, port.segments), as_hits(r, ref.segments)


@pytest.mark.parametrize("ci", range(len(PLAN_CASES)))
def test_dense_script_cases_match_reference(searchers, ci):  # noqa: F811
    got, want = dense_both(searchers, PLAN_CASES[ci][0], 200)
    assert_same_hits(got, want, 200, rtol=RTOL)


# NaN (log of a negative), -inf (log 0), +inf (1/0) and negative values
ODD_SCRIPTS = [
    "Math.log(doc['views'].value - 50) + _score",
    "_score - doc['views'].value",
    "1 / (doc['views'].value - 50) + _score",
    "Math.sqrt(doc['views'].value - 30) * _score",
]


@pytest.mark.parametrize("size", [10, 300])
@pytest.mark.parametrize("src", ODD_SCRIPTS)
@pytest.mark.parametrize("executor", ["plan", "dense"])
def test_nan_inf_and_negative_scores_follow_reference(searchers,  # noqa: F811
                                                      src, size, executor):
    """Each executor answers as the reference's same executor: a NaN or
    -inf score is counted and never returned; +inf is returned by the
    plan path and dropped by the dense one (the reference's two paths
    differ there: ROADMAP Queue 3); negative scores rank as numbers."""
    body = {"script_score": {"query": {"match": {"title": "alpha wolf"}},
                             "script": {"source": src}}}
    if executor == "plan":
        got, want = both(searchers, body, size)
    else:
        got, want = dense_both(searchers, body, size)
    if src.startswith("Math.log") and size == 300:
        # the NaN and -inf docs count, but are not hits
        assert got["hits"]["total"]["value"] > len(got["hits"]["hits"])
    assert not any(np.isnan(h["_score"]) for h in got["hits"]["hits"])
    assert_same_hits(got, want, size,
                     rtol=PLAN_RTOL if executor == "plan" else RTOL)


def test_reference_paths_differ_on_inf(searchers):  # noqa: F811
    """The reference's plan path returns a +inf script score, its dense
    path drops it (``keep = isfinite``): the port keeps each path's
    answer (ROADMAP Queue 3)."""
    body = {"script_score": {"query": {"match": {"title": "alpha wolf"}},
                             "script": {"source": "1 / (doc['views'].value"
                                                  " - 50) + _score"}}}
    for which in (both(searchers, body, 300),
                  dense_both(searchers, body, 300)):
        got, ref = which
        assert [h["_score"] == np.inf for h in got["hits"]["hits"]] == \
            [h["_score"] == np.inf for h in ref["hits"]["hits"]][:300]
    plan_ref = both(searchers, body, 300)[1]
    dense_ref = dense_both(searchers, body, 300)[1]
    assert any(h["_score"] == np.inf for h in plan_ref["hits"]["hits"])
    assert not any(h["_score"] == np.inf
                   for h in dense_ref["hits"]["hits"])


def test_plan_script_on_a_field_without_doc_values(searchers):  # noqa: F811
    """A field the segment has no numeric column of: the reference's
    plan path raises ScriptException, its dense path reads it as all
    missing (value 0), and so do the port's."""
    body = {"script_score": {"query": {"match": {"title": "alpha"}},
                             "script": {"source": "doc['nope'].value + 1"}}}
    ref, port = searchers
    with pytest.raises(JaxScriptException):
        ref.query_phase(jax_parse(body), 10)
    with pytest.raises(ScriptException, match="nope"):
        port.query_phase(parse_query(body), 10)
    got, want = dense_both(searchers, body, 10)
    assert_same_hits(got, want, 10, rtol=RTOL)


def test_statement_tier_reads_back_through_the_funnel(searchers):  # noqa: F811
    body = PLAN_CASES[2][0]
    before = {k: READBACKS[k] for k in ("search.script.statement_score",
                                        "search.script.statement_mask",
                                        "search.script.statement_column")}
    searchers[1].query_phase(parse_query(body), 10)
    n_seg = len(searchers[1].segments)
    for site, n in before.items():
        assert READBACKS[site] == n + n_seg, site


# ---------------------------------------------------------------------------
# the PlanBatcher: one script per cohort
# ---------------------------------------------------------------------------

def one_window(searcher, bodies, k):
    """Every body's query phase from its own thread, the batcher's
    launch slots held until all of them queued, so the cohorts form
    deterministically."""
    batcher = searcher.batcher
    out = [None] * len(bodies)

    def call(i):
        out[i] = searcher.query_phase(parse_query(bodies[i]), k)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(bodies))]
    held = 0
    while batcher._launch_slots.acquire(blocking=False):
        held += 1
    try:
        for t in threads:
            t.start()
        while True:
            with batcher._lock:
                if sum(map(len, batcher._pending.values())) \
                        == len(bodies):
                    break
            time.sleep(0.001)
    finally:
        for _ in range(held):
            batcher._launch_slots.release()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return out


def script_body(src, text="alpha beta"):
    return {"script_score": {"query": {"match": {"title": text}},
                             "script": {"source": src}}}


@pytest.mark.parametrize("n_scripts", [1, 2])
def test_one_script_per_cohort(searchers, n_scripts):  # noqa: F811
    """Eight callers over the same inner query on one segment: one
    script forms one cohort, two scripts two; every answer equals its
    query launched alone."""
    _, port = searchers
    srcs = ["doc['views'].value * 0.5 + _score",
            "_score * 3 - doc['views'].value / 7"][:n_scripts]
    bodies = [script_body(srcs[i % n_scripts]) for i in range(8)]
    # one segment: each caller's query phase is one launch
    solo = ShardSearcher(port.segments[:1], port.mapper, port.cache)
    solo = [solo.query_phase(parse_query(b), 20) for b in bodies]
    batched = ShardSearcher(port.segments[:1], port.mapper, port.cache)
    batched.batcher = PlanBatcher()
    out = one_window(batched, bodies, 20)
    assert batched.batcher.stats()["launches"] == n_scripts
    assert batched.batcher.stats()["batched_queries"] == 8
    for a, b in zip(out, solo):
        assert [(d.segment_idx, d.docid) for d in a.docs] == \
            [(d.segment_idx, d.docid) for d in b.docs]
        assert [d.score for d in a.docs] == [d.score for d in b.docs]
        assert a.total_hits == b.total_hits


# ---------------------------------------------------------------------------
# block-max pruning under a script
# ---------------------------------------------------------------------------

def skewed_feat_searchers():
    """High-tf ``alpha`` docs in the first eighth of the docids (the
    reference's tests/test_plan_prune.py skewed corpus) and a ``feat``
    column that is large only in the last eighth."""
    rng = np.random.default_rng(11)
    vocab = ["alpha", "beta", "gamma", "delta", "wolf", "fox", "dog"]
    mappings = {"properties": {"title": {"type": "text"},
                               "feat": {"type": "double"}}}
    jm, pm = MapperService(mappings=mappings), DocumentMapper(mappings)
    jw, pw = JaxWriter(), SegmentWriter()
    n = 1600
    for i in range(n):
        if i < n // 8:
            title = " ".join(["alpha"] * int(rng.integers(6, 12))
                             + list(rng.choice(vocab, 3)))
        else:
            title = " ".join(rng.choice(vocab, int(rng.integers(4, 9))))
        doc = {"title": title,
               "feat": float(rng.random() * (10 if i >= n - n // 8 else 1))}
        jw.add(jm.parse(str(i), doc))
        pw.add(pm.parse(str(i), doc))
    return (JaxSearcher([jw.build("s0")], jm, JaxSegmentCache()),
            ShardSearcher([pw.build("s0")], pm, DeviceSegmentCache("cpu")))


def test_pruning_under_a_script(monkeypatch):
    """The reference prunes a scripted plan by BM25 bounds alone and so
    loses the hits the script lifts (its pruned and exact answers
    differ); the port does not prune a scripted plan, and its answer to
    the thresholded ask is the reference's exact one."""
    monkeypatch.setattr(jplan, "FILTER_CACHE_MIN_BLOCKS", 1)
    monkeypatch.setattr(jplan, "PRUNE_MIN_BLOCKS", 4)
    monkeypatch.setattr(tplan, "PRUNE_MIN_BLOCKS", 4)
    ref, port = skewed_feat_searchers()
    body = script_body("doc['feat'].value * 100 + _score", "alpha")
    k = 10
    r_exact = ref.query_phase(jax_parse(body), k + 1, track_total_hits=True)
    r_pruned = ref.query_phase(jax_parse(body), k, track_total_hits=10)
    assert r_pruned.total_lower_bound
    assert [d.docid for d in r_pruned.docs] != \
        [d.docid for d in r_exact.docs[:k]]
    p = port.query_phase(parse_query(body), k, track_total_hits=10)
    assert not p.total_lower_bound
    p_exact = port.query_phase(parse_query(body), k, track_total_hits=True)
    assert p.total_hits == p_exact.total_hits == r_exact.total_hits
    assert_same_hits(as_hits(p, port.segments),
                     as_hits(r_exact, ref.segments), k, rtol=PLAN_RTOL)
    # the same plan without its script still prunes on both sides
    bare = {"match": {"title": "alpha"}}
    assert port.query_phase(parse_query(bare), k,
                            track_total_hits=10).total_lower_bound
    assert ref.query_phase(jax_parse(bare), k,
                           track_total_hits=10).total_lower_bound


# ---------------------------------------------------------------------------
# _search on both nodes
# ---------------------------------------------------------------------------

RESCORE_DOCS = [
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


def rest_pair(tmp_path_factory, name, docs, mappings=None):
    """The reference node and the port's (over HTTP) with ``docs``
    indexed through ``_bulk`` into index ``name``."""
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("jax")))
    c = jax_node.rest_controller
    create = {"mappings": mappings} if mappings else {}
    c.dispatch("PUT", f"/{name}", {}, create)
    c.dispatch("POST", f"/{name}/_bulk", {"refresh": "true"},
               bulk_body(docs, 0, len(docs)))
    node = Node(device="cpu")
    port = node.start(0)
    assert http(port, "PUT", f"/{name}", create)[0] == 200
    st, r = http(port, "POST", f"/{name}/_bulk", bulk_body(docs, 0,
                                                           len(docs)),
                 ndjson=True)
    assert st == 200 and not r["errors"]
    assert http(port, "POST", f"/{name}/_refresh")[0] == 200
    return jax_node, node, port


@pytest.fixture(scope="module")
def rescore_nodes(tmp_path_factory):
    jax_node, node, port = rest_pair(tmp_path_factory, "idx", RESCORE_DOCS)
    yield jax_node, port
    node.close()
    jax_node.close()


def ask_both(pair, body, index="idx"):
    jax_node, port = pair
    st, got = http(port, "POST", f"/{index}/_search", body)
    jst, ref = jax_node.rest_controller.dispatch(
        "POST", f"/{index}/_search", {}, body)
    return (st, got), (jst, ref)


def assert_same_page(got, ref, rtol=RTOL):
    """Equal totals and scores within ``rtol``; the same ids in each
    group of scores that agree within it (the reference's plan path
    ranks float32 sums that drift, so its true ties come out in either
    order), the page's last group only when the page holds every hit."""
    assert got["hits"]["total"] == ref["hits"]["total"]
    gh, rh = got["hits"]["hits"], ref["hits"]["hits"]
    assert len(gh) == len(rh)
    rs = np.array([h["_score"] for h in rh])
    np.testing.assert_allclose([h["_score"] for h in gh], rs, rtol=rtol,
                               atol=0)
    i = 0
    while i < len(rh):
        j = i + 1
        while j < len(rh) and abs(rs[j] - rs[i]) <= rtol * abs(rs[i]):
            j += 1
        if j < len(rh) or len(rh) == got["hits"]["total"]["value"]:
            assert {h["_id"] for h in gh[i:j]} == \
                {h["_id"] for h in rh[i:j]}, (i, j)
        i = j
    if ref["hits"]["max_score"] is None:
        assert got["hits"]["max_score"] is None
    else:
        assert got["hits"]["max_score"] == pytest.approx(
            ref["hits"]["max_score"], rel=rtol)


RESCORE_BODIES = [
    # the reference's test_rescore_reorders_top_window
    {"query": {"match": {"title": "quick"}},
     "rescore": {"window_size": 10, "query": {
         "rescore_query": {"term": {"group": "c"}},
         "rescore_query_weight": 100.0}}},
    *[{"query": {"match": {"title": "quick brown"}}, "size": 3,
       "rescore": {"window_size": 4, "query": {
           "rescore_query": {"match": {"body": "the fox"}},
           "query_weight": 0.7, "rescore_query_weight": 1.3,
           "score_mode": mode}}}
      for mode in ("total", "multiply", "avg", "max", "min")],
    {"query": {"match": {"body": "the quick"}}, "from": 1, "size": 2,
     "rescore": [
         {"window_size": 3, "query": {"rescore_query": {
             "script_score": {"query": {"match_all": {}},
                              "script": {"source": "doc['rank'].value"}}},
             "score_mode": "multiply"}},
         {"window_size": 2, "query": {"rescore_query": {
             "match": {"title": "fox"}}, "query_weight": 2.0}}]},
]


@pytest.mark.parametrize("bi", range(len(RESCORE_BODIES)))
def test_rescore_matches_reference_node(rescore_nodes, bi):
    (st, got), (jst, ref) = ask_both(rescore_nodes, RESCORE_BODIES[bi])
    assert st == jst == 200, (got, ref)
    assert_same_page(got, ref)
    if bi == 0:
        assert got["hits"]["hits"][0]["_id"] == "4"


@pytest.mark.parametrize("body,etype", [
    ({"query": {"match_all": {}}, "sort": [{"rank": "asc"}],
      "rescore": {"query": {"rescore_query": {"match_all": {}}}}},
     "illegal_argument_exception"),
    ({"query": {"match": {"title": "quick"}},
      "rescore": {"query": {"rescore_query": {"match_all": {}},
                            "score_mode": "median"}}},
     "illegal_argument_exception"),
    ({"query": {"script_score": {"query": {"match_all": {}},
                                 "script": {"source": "params.nope + 1"}}}},
     "script_exception"),
    ({"query": {"script_score": {"query": {"match_all": {}},
                                 "script": {"source": "foo("}}}},
     "script_exception"),
])
def test_refusals_match_reference_node(rescore_nodes, body, etype):
    (st, got), (jst, ref) = ask_both(rescore_nodes, body)
    assert st == 400 and got["error"]["type"] == etype, got
    assert jst == 400


@pytest.mark.parametrize("body,path", [
    ({"query": {"script_score": {"query": {"match_all": {}},
                                 "script": {"id": "my-script"}}}},
     "/idx/_search"),
    ({"query": {"match_all": {}}, "script_fields": {
        "x": {"script": {"id": "my-script"}}}},
     "/idx/_search"),
    ({"script": {"lang": "painless", "source": "_score"}},
     "/_scripts/my-script"),
])
def test_later_slice_script_surfaces_are_typed_400s(rescore_nodes, body,
                                                    path):
    """The stored-script surfaces, served since the search-context
    slice: ``PUT /_scripts/{id}`` acknowledges on both nodes, and a
    search naming a script the port's node does not hold is a 400
    ``parsing_exception`` (``unable to find script``); the same script
    given inline answers as the reference."""
    jax_node, port = rescore_nodes
    method = "PUT" if path.startswith("/_scripts") else "POST"
    st, r = http(port, method, path, body)
    if method == "PUT":
        jst, ref = jax_node.rest_controller.dispatch(method, path, {}, body)
        assert st == jst == 200 and r == ref == {"acknowledged": True}
        st, r = http(port, "DELETE", path)
        assert st == 200, r
        return
    assert st == 400 and r["error"]["type"] == "parsing_exception", r
    assert "unable to find script [my-script]" in r["error"]["reason"]


def test_statement_script_cap_answers_400(rescore_nodes, monkeypatch):
    """Over the interpreter's budget a statement script is a 400
    script_exception on both nodes (the cap lowered to 8 docs here: the
    segments hold 1024 padded slots)."""
    monkeypatch.setattr(jscript, "SCRIPT_INTERP_MAX_DOCS", 8)
    monkeypatch.setattr(tscript, "SCRIPT_INTERP_MAX_DOCS", 8)
    body = {"query": {"script_score": {
        "query": {"match": {"title": "quick"}},
        "script": {"source": "if (doc['rank'].value > 2) { return 1; } "
                             "return 2;"}}}}
    (st, got), (jst, ref) = ask_both(rescore_nodes, body)
    assert st == jst == 400
    assert got["error"]["type"] == "script_exception"
    assert "interpreter budget" in got["error"]["reason"]


# BASELINE config 3 on the same _bulk-indexed documents
C3_MAPPINGS = {"properties": {
    "title": {"type": "text"}, "feat": {"type": "double"},
    "views": {"type": "long"},
    "vec": {"type": "dense_vector", "dims": 8, "similarity": "cosine"}}}
C3_VOCAB = [f"w{i}" for i in range(40)]


def c3_docs(n=600, seed=31):
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, len(C3_VOCAB) + 1) ** 1.05
    zipf /= zipf.sum()
    docs = []
    for _ in range(n):
        v = rng.standard_normal(8)
        docs.append({"title": " ".join(rng.choice(
            C3_VOCAB, int(rng.integers(2, 30)), p=zipf)),
            "feat": float(rng.random()), "views": int(rng.integers(0, 500)),
            "vec": (v / np.linalg.norm(v)).round(5).tolist()})
    return docs


@pytest.fixture(scope="module")
def c3_nodes(tmp_path_factory):
    jax_node, node, port = rest_pair(tmp_path_factory, "c3", c3_docs(),
                                     C3_MAPPINGS)
    yield jax_node, port
    node.close()
    jax_node.close()


def c3_bodies():
    rng = np.random.default_rng(32)
    texts = [" ".join(rng.choice(C3_VOCAB[:30], int(rng.integers(1, 4)),
                                 replace=False)) for _ in range(6)]
    qv = rng.standard_normal(8)
    qv = (qv / np.linalg.norm(qv)).round(4).tolist()
    plan = [{"query": {"script_score": {
        "query": {"match": {"title": t}},
        "script": {"source": "doc['feat'].value * 0.5 + _score"}}},
        "size": 100, "_source": False} for t in texts]
    dense = [
        {"query": {"script_score": {
            "query": {"match": {"title": texts[0]}},
            "script": {"source": "cosineSimilarity(params.qv, 'vec') + 1.0 "
                                 "+ _score", "params": {"qv": qv}}}},
         "size": 50, "_source": False},
        {"query": {"function_score": {
            "query": {"match": {"title": texts[1]}},
            "functions": [{"script_score": {"script": {
                "source": "doc['feat'].value"}}, "weight": 2.0},
                {"weight": 0.5}],
            "score_mode": "sum", "boost_mode": "multiply"}}, "size": 30},
        {"query": {"script_score": {
            "query": {"match": {"title": texts[2]}},
            "script": {"source": "doc['feat'].value * 10 + _score"},
            "min_score": 8.0}}, "size": 40},
        {"query": {"script_score": {
            "query": {"match": {"title": texts[3]}},
            "script": {"source": "double s = _score; "
                                 "if (doc['views'].value > 250) { s += 1; } "
                                 "return s;"}}}, "size": 20},
        {"query": {"match": {"title": texts[4]}}, "size": 10,
         "rescore": {"window_size": 100, "query": {"rescore_query": {
             "script_score": {"query": {"match_all": {}}, "script": {
                 "source": "doc['feat'].value * 3"}}},
             "score_mode": "total"}}},
    ]
    return plan, dense


@pytest.mark.parametrize("bi", range(11))
def test_config3_bodies_match_reference_node(c3_nodes, bi):
    plan, dense = c3_bodies()
    bodies = plan + dense
    body = bodies[bi]
    (st, got), (jst, ref) = ask_both(c3_nodes, body, "c3")
    assert st == jst == 200, (got, ref)
    assert got["hits"]["total"]["relation"] == "eq"
    assert got["hits"]["hits"]
    if bi < len(plan):
        size = body["size"]
        jst, ref = c3_nodes[0].rest_controller.dispatch(
            "POST", "/c3/_search", {}, dict(body, size=size + 1))
        assert_same_hits(got, ref, size, rtol=PLAN_RTOL)
    else:
        assert_same_page(got, ref)


@pytest.mark.parametrize("src", ["doc['feat'].value.zero_()",
                                 "doc['feat'].empty.fill_(True)"])
@pytest.mark.parametrize("min_score", [None, 0.0])
def test_in_place_methods_leave_the_index_as_it_was(c3_nodes, src,
                                                    min_score):
    """A body that would write a resident column (on the plan path and,
    with ``min_score``, on the dense executor) is a 400 script_exception
    on both nodes, and the next config 3 bodies answer as before."""
    plan, dense = c3_bodies()
    inner = plan[0]["query"]["script_score"]["query"]
    body = {"query": {"script_score": {"query": inner,
                                       "script": {"source": src}}}}
    if min_score is not None:
        body["query"]["script_score"]["min_score"] = min_score
    (st, got), (jst, ref) = ask_both(c3_nodes, body, "c3")
    assert st == jst == 400, (got, ref)
    assert got["error"]["type"] == "script_exception"
    for body in (plan[0], dense[2]):
        (st, got), (jst, ref) = ask_both(c3_nodes, body, "c3")
        assert st == jst == 200, (got, ref)
        assert_same_page(got, ref, rtol=PLAN_RTOL)


def test_config3_plan_bodies_ride_the_plan_launch(c3_nodes):
    """The bench's body takes the plan path's batcher; the vector form
    does not (it needs the slab)."""
    plan, dense = c3_bodies()
    _, port = c3_nodes
    before = dict(READBACKS)
    for body in plan[:2] + dense[:1]:
        assert http(port, "POST", "/c3/_search", body)[0] == 200
    grew = {k: READBACKS[k] - before.get(k, 0) for k in READBACKS}
    assert grew.get("search.batching.plan_cohort", 0) == 2
    assert grew.get("search.searcher.dense_topk", 0) == 1
    assert json.dumps(plan[0])   # the bodies stay JSON


def test_bench_feat_is_the_reference_bench_column():
    """corpus.py bench_feat draws the reference bench's ``feat`` column
    (bench.py, its script_score row's doc values): one default_rng(99)
    whose category draw comes first."""
    from elasticsearch_tpu_torch.corpus import bench_feat
    n = 5000
    rng2 = np.random.default_rng(99)
    np.minimum((rng2.random(n) ** 2 * 500), 499).astype(np.int32)
    feat = rng2.random(n).astype(np.float64)
    got = bench_feat(n)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, feat)
