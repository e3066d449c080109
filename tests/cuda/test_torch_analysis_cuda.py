"""Analyzed indices on the card against the CPU.

An index of corpus.py's analysis mapping (``title`` standard, ``body``
english with a synonym search analyzer, ``body.exact`` a custom chain of
char filters, the pattern tokenizer and five token filters, ``tags``
whitespace), of 2 shards, on a ``Node(device="cuda")`` and a
``Node(device="cpu")``:
its dense BM25 scoring (bodies with ``min_score``, which the dense
executor serves) launches the contribution kernel once a scoring
(``bm25_dense_scores_sorted``), and the card's answers equal the CPU's
(ids, order, totals; scores rtol 1e-6). The plan path's answers equal
the CPU's too. On a started node the front registers only the index
whose one text field is the builtin standard analyzer's, that index's
fast bodies launch the merge kernel, and a body on an english field
launches none.
"""

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.corpus import (ANALYSIS_MAPPINGS,
                                            ANALYSIS_SETTINGS, english_docs)
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.ops.merge import merge_sorted_slots
from elasticsearch_tpu_torch.telemetry.engine import TRACKER

pytestmark = pytest.mark.cuda

DOCS = english_docs(2000, np.random.default_rng(17))


def _load(node, index, mappings, settings, docs):
    rest = node.rest_controller
    st, r = rest.dispatch("PUT", f"/{index}", {}, {
        "settings": settings, "mappings": mappings})
    assert st == 200, r
    for lo in range(0, len(docs), 1000):
        lines = "".join(json.dumps(x) + "\n" for i in range(lo, min(
            lo + 1000, len(docs))) for x in ({"index": {"_id": str(i)}},
                                            docs[i]))
        st, r = rest.dispatch("POST", f"/{index}/_bulk", {}, lines)
        assert st == 200 and not r["errors"]
    rest.dispatch("POST", f"/{index}/_refresh", {}, None)


BODIES = [
    {"query": {"match": {"body": "running walks"}}, "size": 100},
    {"query": {"match": {"body": "jog fast"}}, "size": 100},
    {"query": {"match": {"body.exact": "PowerShot real-time café"}},
     "size": 100},
    {"query": {"match": {"tags": "PowerPoint jumpation"}}, "size": 100},
    {"query": {"bool": {"must": [{"match": {"body": "run"}}],
                        "should": [{"match": {"body.exact": "runs"}}]}},
     "size": 100},
    {"query": {"match": {"title": "Running dogs"}}, "size": 100},
]


def _same(g, c):
    assert g["hits"]["total"] == c["hits"]["total"]
    gh, ch = g["hits"]["hits"], c["hits"]["hits"]
    assert [h["_id"] for h in gh] == [h["_id"] for h in ch]
    np.testing.assert_allclose([h["_score"] for h in gh],
                               [h["_score"] for h in ch], rtol=1e-6)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of csrc/ run only on "
                    "the card")
    gpu = Node(device="cuda", data_path=str(tmp_path_factory.mktemp("g")))
    cpu = Node(device="cpu", data_path=str(tmp_path_factory.mktemp("c")))
    for n in (gpu, cpu):
        _load(n, "an", ANALYSIS_MAPPINGS,
              {"index": dict(ANALYSIS_SETTINGS["index"],
                             number_of_shards=2)}, DOCS)
    yield gpu, cpu
    gpu.close()
    cpu.close()


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_dense_scoring_launches_the_kernel_and_equals_the_cpu(pair, i):
    gpu, cpu = pair
    body = dict(BODIES[i], min_score=1e-9)
    launches0 = gather_bm25_contrib.launches
    scorings0 = TRACKER.calls("bm25_dense_scores_sorted")
    st, g = gpu.rest_controller.dispatch("POST", "/an/_search", {}, body)
    launches = gather_bm25_contrib.launches - launches0
    scorings = TRACKER.calls("bm25_dense_scores_sorted") - scorings0
    st2, c = cpu.rest_controller.dispatch("POST", "/an/_search", {}, body)
    assert st == st2 == 200
    assert launches == scorings > 0
    _same(g, c)


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_plan_path_equals_the_cpu(pair, i):
    gpu, cpu = pair
    st, g = gpu.rest_controller.dispatch("POST", "/an/_search", {},
                                         BODIES[i])
    st2, c = cpu.rest_controller.dispatch("POST", "/an/_search", {},
                                          BODIES[i])
    assert st == st2 == 200
    _same(g, c)


def test_front_registers_only_the_standard_field(cuda_device, tmp_path):
    node = Node(device="cuda", data_path=str(tmp_path / "f"))
    try:
        node.start(0)
        one_shard = {"index": dict(ANALYSIS_SETTINGS["index"],
                                   number_of_shards=1)}
        _load(node, "an", ANALYSIS_MAPPINGS, one_shard, DOCS)
        node.rest_controller.dispatch("POST", "/an/_forcemerge", {}, None)
        node.refresh_front()
        assert node.fastpath.front_registration() is None
        _load(node, "an_std", {"properties": {"title": {"type": "text"}}},
              {"index": {"number_of_shards": 1}},
              [{"title": d["title"]} for d in DOCS])
        node.refresh_front()
        assert node.fastpath.front_registration()["index"] == "an_std"
        before = merge_sorted_slots.launches
        st, r = node.rest_controller.dispatch(
            "POST", "/an_std/_search", {},
            {"query": {"match": {"title": DOCS[0]["title"]}}, "size": 100})
        assert st == 200 and r["hits"]["total"]["value"] > 0
        assert merge_sorted_slots.launches > before
        # a body on an english field never takes a fast lane
        before = merge_sorted_slots.launches
        st, r = node.rest_controller.dispatch(
            "POST", "/an/_search", {},
            {"query": {"match": {"body": DOCS[1]["body"]}}, "size": 100})
        assert st == 200 and r["hits"]["total"]["value"] > 0
        assert merge_sorted_slots.launches == before
    finally:
        node.close()
