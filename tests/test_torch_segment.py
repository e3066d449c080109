"""The port's own copies of the standard analyzer, the text mapper and the
segment builder (elasticsearch_tpu_torch/analysis, index/) against the
reference's: the same docs give the same tokens, the same PostingsField
arrays from both SegmentWriters, and the same merged segment."""

import json

import numpy as np
import pytest

from elasticsearch_tpu.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.index.segment import SegmentWriter as JaxWriter
from elasticsearch_tpu.index.segment import merge_segments as jax_merge
from elasticsearch_tpu_torch.analysis.analyzers import StandardAnalyzer
from elasticsearch_tpu_torch.index.mapper import (DocumentMapper,
                                                  MapperParsingException)
from elasticsearch_tpu_torch.index.segment import BLOCK_SIZE, SegmentWriter
from elasticsearch_tpu_torch.index.segment import \
    merge_segments as port_merge

MAPPINGS = {"properties": {"title": {"type": "text"},
                           "body": {"type": "text"}}}
WORDS = ["Quick", "brown", "FOX", "jumps", "über", "naïve", "café", "x1",
         "2024", "e-mail", "don't", "日本語", "straße", "ΑΒΓ", "a_b", "z"]

TEXTS = [
    "The Quick brown fox, jumped over 2 lazy dogs!",
    "e-mail me at foo@bar.com -- or don't.",
    "Ünïcödé wörds: naïve café Straße ΑΒΓ δ",
    "日本語のテキスト and 中文 mixed 123abc",
    "tabs\tand\nnewlines   and nbsp",
    "a" * 300 + " short",
    "combining é marks and ẍy",
    "",
]


def jax_standard():
    return AnalysisRegistry().get("standard")


@pytest.mark.parametrize("text", TEXTS)
def test_standard_analyzer_tokens_match(text):
    ref = [(t.term, t.position, t.start_offset, t.end_offset)
           for t in jax_standard().analyze(text)]
    got = [(t.term, t.position, t.start_offset, t.end_offset)
           for t in StandardAnalyzer().analyze(text)]
    assert got == ref


def make_docs(seed, n):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        doc = {"title": " ".join(rng.choice(WORDS, rng.integers(1, 6)))}
        if rng.random() < 0.7:      # some docs lack the body field
            doc["body"] = [" ".join(rng.choice(WORDS, rng.integers(1, 30)))
                           for _ in range(int(rng.integers(1, 3)))]
        docs.append(doc)
    return docs


def build_both(docs, name, offset=0):
    jm, pm = MapperService(mappings=MAPPINGS), DocumentMapper(MAPPINGS)
    jw, pw = JaxWriter(), SegmentWriter()
    for i, d in enumerate(docs):
        jw.add(jm.parse(str(i + offset), d))
        pw.add(pm.parse(str(i + offset), d))
    return jw.build(name), pw.build(name)


ARRAYS = ("doc_freq", "total_term_freq", "term_block_start",
          "term_block_count", "block_docids", "block_tfs", "field_lengths")
SCALARS = ("sum_total_term_freq", "sum_doc_freq", "doc_count")


def assert_same_segment(js, ps):
    assert ps.n_docs == js.n_docs
    assert sorted(ps.postings) == sorted(f for f in js.postings
                                         if f in MAPPINGS["properties"])
    for f, pf in ps.postings.items():
        jf = js.postings[f]
        assert pf.terms == list(jf.terms)
        for a in ARRAYS:
            got, ref = getattr(pf, a), np.asarray(getattr(jf, a))
            assert got.dtype == ref.dtype, a
            np.testing.assert_array_equal(got, ref, err_msg=a)
        for s in SCALARS:
            assert getattr(pf, s) == getattr(jf, s), s
    assert ps.stored.ids == list(js.stored.ids)
    for d in range(ps.n_docs):
        assert json.loads(ps.stored.source(d)) == \
            json.loads(js.stored.source(d))
    np.testing.assert_array_equal(ps.live, js.live)


@pytest.mark.parametrize("seed,n", [(0, 40), (1, 300)])
def test_segment_writer_arrays_match(seed, n):
    js, ps = build_both(make_docs(seed, n), "_0")
    assert BLOCK_SIZE == 128
    assert_same_segment(js, ps)


def test_merge_segments_match():
    a_docs, b_docs = make_docs(2, 150), make_docs(3, 90)
    ja, pa = build_both(a_docs, "_a")
    jb, pb = build_both(b_docs, "_b", offset=150)
    for d in (0, 7, 149):
        ja.delete(d)
        pa.delete(d)
    for d in (5, 88):
        jb.delete(d)
        pb.delete(d)
    assert_same_segment(jax_merge("_m", [ja, jb]), port_merge("_m", [pa, pb]))


def test_mapper_refuses_other_field_types():
    with pytest.raises(MapperParsingException):
        DocumentMapper({"properties": {"n": {"type": "long"}}})
    with pytest.raises(MapperParsingException):
        DocumentMapper({"properties": {"t": {"type": "text",
                                             "analyzer": "english"}}})
