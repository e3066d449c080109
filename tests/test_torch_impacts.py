"""The port's block-max metadata (elasticsearch_tpu_torch/index/segment.py
``block_max_tf`` / ``block_min_len``) and its impact helpers
(ops/plan.py ``build_term_impacts``, ``select_blocks_impact``,
``select_blocks_prefix``, ``impact_safe_termination``) against the
reference's on the same inputs.

- The metadata of a segment built from the same docs, by both
  SegmentWriters, by both merges and through ``segment_from_numpy``
  (computed, and carried from the reference's arrays): equal.
- The helpers on the corpus of tests/test_impact_serving.py (a bursty
  corpus in 16-wide blocks) and on a port segment: the impact arrays
  and the selections equal, miss bounds within 1e-12 (both sum the same
  float64 bounds in the same order), and the safe-termination check
  equal on a grid of (kth, next, miss).
"""

import itertools

import numpy as np
import pytest

from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.index.segment import SegmentWriter as JaxWriter
from elasticsearch_tpu.index.segment import merge_segments as jax_merge
from elasticsearch_tpu.ops import plan as jplan
from elasticsearch_tpu_torch.corpus import build_corpus, segment_from_corpus
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.index.segment import \
    merge_segments as port_merge
from elasticsearch_tpu_torch.index.segment import segment_from_numpy
from elasticsearch_tpu_torch.ops import plan as tplan

K1, B = 1.2, 0.75
MAPPINGS = {"properties": {"title": {"type": "text"},
                           "body": {"type": "text"},
                           "tag": {"type": "keyword"}}}
WORDS = ["alpha", "beta", "gamma", "delta", "wolf", "fox", "dog", "cat"]
META = ("block_max_tf", "block_min_len")


def docs(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        d = {"title": " ".join(rng.choice(WORDS, int(rng.integers(1, 9)))),
             "tag": str(rng.choice(["red", "blue"]))}
        if rng.random() < 0.7:          # some docs lack the body field
            d["body"] = " ".join(rng.choice(WORDS, int(rng.integers(2, 40))))
        out.append(d)
    return out


def build_both(ds, name, offset=0):
    jm, pm = MapperService(mappings=MAPPINGS), DocumentMapper(MAPPINGS)
    jw, pw = JaxWriter(), SegmentWriter()
    for i, d in enumerate(ds):
        jw.add(jm.parse(str(i + offset), d))
        pw.add(pm.parse(str(i + offset), d))
    return jw.build(name), pw.build(name)


def assert_same_meta(js, ps):
    for f, pf in ps.postings.items():
        jf = js.postings[f]
        for a in META:
            got, ref = getattr(pf, a), np.asarray(getattr(jf, a))
            assert got.dtype == ref.dtype == np.float32, (f, a)
            np.testing.assert_array_equal(got, ref, err_msg=f"{f}.{a}")


@pytest.mark.parametrize("seed,n", [(0, 50), (1, 700)])
def test_writer_block_meta_matches_reference(seed, n):
    js, ps = build_both(docs(seed, n), "_0")
    assert_same_meta(js, ps)


def test_merge_block_meta_matches_reference():
    ja, pa = build_both(docs(2, 300), "_a")
    jb, pb = build_both(docs(3, 200), "_b", offset=300)
    for d in (0, 9, 299):
        ja.delete(d)
        pa.delete(d)
    jb.delete(17)
    pb.delete(17)
    assert_same_meta(jax_merge("_m", [ja, jb]), port_merge("_m", [pa, pb]))


@pytest.mark.parametrize("carry", [False, True])
def test_segment_from_numpy_block_meta(carry):
    """Computed from the blocks when absent, carried when given: either
    way the reference's values."""
    js, _ = build_both(docs(4, 500), "_n")
    jf = js.postings["body"]
    arrays = {a: np.asarray(getattr(jf, a)) for a in (
        "doc_freq", "total_term_freq", "term_block_start",
        "term_block_count", "block_docids", "block_tfs", "field_lengths")}
    arrays["terms"] = list(jf.terms)
    if carry:
        arrays.update({a: np.asarray(getattr(jf, a)) for a in META})
    ps = segment_from_numpy(arrays, name="_n", field="body")
    for a in META:
        np.testing.assert_array_equal(getattr(ps.postings["body"], a),
                                      np.asarray(getattr(jf, a)))


def test_corpus_segment_block_meta():
    """The generated corpus's segment: the metadata bounds every posting
    of its block (max tf >= tf, min length <= length), and is tight."""
    c = build_corpus(np.random.default_rng(1), n_docs=3000, vocab=300)
    pf = segment_from_corpus(c).postings["title"]
    tf, d = pf.block_tfs, pf.block_docids
    real = tf > 0
    np.testing.assert_array_equal(pf.block_max_tf, tf.max(axis=1))
    lens = np.where(real, pf.field_lengths[d], np.inf).min(axis=1)
    np.testing.assert_array_equal(pf.block_min_len, lens)
    assert (pf.block_min_len > 0).all()


# ------------------------------------------------------------- helpers
BLOCK = 16
ND = 4096
QUERIES = [(0, 1), (2, 3, 4), (1, 5, 6), (0, 7, 8, 9), (3, 6), (2, 9),
           (4,), (8,)]


@pytest.fixture(scope="module")
def bursty():
    """tests/test_impact_serving.py's corpus: ten terms of 12-40 blocks
    of 16 postings, heavy-tailed integer tfs."""
    rng = np.random.default_rng(42)
    n_terms = 10
    lens = np.clip(rng.lognormal(np.log(40), 0.4, ND), 5, 200)
    dfs = rng.integers(12 * BLOCK, 40 * BLOCK, n_terms)
    bd, bt = [], []
    starts = np.zeros(n_terms, np.int64)
    counts = np.zeros(n_terms, np.int64)
    for t in range(n_terms):
        df = int(dfs[t])
        d = np.sort(rng.choice(ND, df, replace=False)).astype(np.int32)
        tf = (1.0 + rng.pareto(1.5, df) * 2.0).round()
        starts[t], counts[t] = len(bd), -(-df // BLOCK)
        for bi in range(int(counts[t])):
            lo, hi = bi * BLOCK, min((bi + 1) * BLOCK, df)
            bd.append(np.pad(d[lo:hi], (0, BLOCK - (hi - lo))))
            bt.append(np.pad(tf[lo:hi], (0, BLOCK - (hi - lo))))
    bd, bt = np.stack(bd), np.stack(bt)
    idf = np.log1p((ND - dfs + 0.5) / (dfs + 0.5))
    max_tf = bt.max(axis=1)
    ml = np.where(bt > 0, lens[bd], np.inf).min(axis=1)
    min_len = np.where(np.isfinite(ml), ml, 0.0)
    return dict(starts=starts, counts=counts, max_tf=max_tf,
                min_len=min_len, idf=idf, avg=float(lens.mean()))


def segment_inputs():
    """A port segment's postings (the corpus generator at 3000 docs)."""
    c = build_corpus(np.random.default_rng(2), n_docs=3000, vocab=200)
    pf = segment_from_corpus(c).postings["title"]
    idf = np.log1p((3000 - pf.doc_freq + 0.5) / (pf.doc_freq + 0.5))
    return dict(starts=pf.term_block_start, counts=pf.term_block_count,
                max_tf=pf.block_max_tf, min_len=pf.block_min_len, idf=idf,
                avg=pf.avg_field_length)


def both_impacts(x):
    args = (x["starts"], x["counts"], x["max_tf"], x["min_len"], x["idf"],
            x["avg"], K1, B)
    return jplan.build_term_impacts(*args), tplan.build_term_impacts(*args)


def assert_same_impacts(ji, ti):
    for a in ("ub", "order", "ub_desc"):
        got, ref = getattr(ti, a), np.asarray(getattr(ji, a))
        assert got.dtype == ref.dtype, a
        np.testing.assert_array_equal(got, ref, err_msg=a)


def test_term_impacts_match_reference(bursty):
    assert_same_impacts(*both_impacts(bursty))


def test_term_impacts_on_a_segment_match_reference():
    assert_same_impacts(*both_impacts(segment_inputs()))


def test_layout_gap_is_refused(bursty):
    counts = bursty["counts"].copy()
    counts[0] -= 1
    for mod in (jplan, tplan):
        with pytest.raises(ValueError, match="packed block layout"):
            mod.build_term_impacts(bursty["starts"], counts,
                                   bursty["max_tf"], bursty["min_len"],
                                   bursty["idf"], bursty["avg"], K1, B)


@pytest.mark.parametrize("frac", [0.15, 0.4, 0.75, 1.0])
def test_selections_match_reference(bursty, frac):
    ji, ti = both_impacts(bursty)
    s, c = bursty["starts"], bursty["counts"]
    for q in QUERIES:
        budget = max(len(q), int(sum(c[t] for t in q) * frac))
        jp, jmiss = jplan.select_blocks_impact(q, budget, s, c, ji)
        tp, tmiss = tplan.select_blocks_impact(q, budget, s, c, ti)
        assert len(jp) == len(tp)
        for a, b in zip(tp, jp):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, np.asarray(b))
        assert abs(tmiss - jmiss) <= 1e-12
        assert (tmiss == 0.0) == (frac == 1.0)
        for a, b in zip(tplan.select_blocks_prefix(q, budget, s, c),
                        jplan.select_blocks_prefix(q, budget, s, c)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_selections_on_a_segment_match_reference():
    x = segment_inputs()
    ji, ti = both_impacts(x)
    nb = x["counts"]
    big = [int(t) for t in np.argsort(-nb)[:6]]
    for q in ([big[0]], big[:2], big[1:5]):
        budget = max(1, int(nb[q].sum()) // 3)
        jp, jmiss = jplan.select_blocks_impact(q, budget, x["starts"], nb, ji)
        tp, tmiss = tplan.select_blocks_impact(q, budget, x["starts"], nb, ti)
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert abs(tmiss - jmiss) <= 1e-12 and tmiss > 0.0


def test_safe_termination_matches_reference_on_a_grid():
    vals = [-np.inf, 0.0, 0.3, 1.0, 2.5, np.inf, np.nan]
    for kth, nxt, miss in itertools.product(vals, vals, [0.0, -1.0, 0.5,
                                                          1.2, 3.0]):
        assert (tplan.impact_safe_termination(kth, nxt, miss)
                == jplan.impact_safe_termination(kth, nxt, miss)), \
            (kth, nxt, miss)
