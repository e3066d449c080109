"""Indices of several shards on the card against the same node on the CPU.

The same documents, made from a numpy seed, go into a 3-shard index of
a ``Node(device="cuda")`` and of a ``Node(device="cpu")``; each body of
the shard loop (match, bool, term, sorts, a keyword sort, collapse,
aggs, highlight, terminate_after, a track_total_hits threshold, kNN,
``dfs_query_then_fetch``, a multi-index expression) answers on the card
what it answers on the CPU: ids, order, totals, sort values and the
sections equal, scores within rtol 1e-6. Every answer on the card has
``_shards.failed == 0`` (the per-shard failure barrier would otherwise
hide a kernel's fault as a partial result), and the contribution kernel
launched once per dense BM25 scoring, the merge not at all.
"""

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.ops.merge import merge_sorted_slots
from elasticsearch_tpu_torch.telemetry.engine import TRACKER

pytestmark = pytest.mark.cuda

SHARDS = 3
VOCAB = [f"w{i}" for i in range(40)]
KEYWORDS = [f"k{i:02d}" for i in range(12)]
MAPPINGS = {"properties": {
    "t": {"type": "text"}, "k": {"type": "keyword"}, "n": {"type": "long"},
    "v": {"type": "dense_vector", "dims": 4, "similarity": "cosine"}}}
QV = [0.3, -0.2, 0.9, 0.1]
BODIES = [
    ("/s/_search", {}, {"query": {"match": {"t": "w1 w3"}}, "size": 20}),
    ("/s/_search", {}, {"query": {"bool": {
        "must": [{"match": {"t": "w2"}}],
        "filter": [{"terms": {"k": ["k01", "k03", "k05"]}}]}}, "size": 20}),
    ("/s/_search", {}, {"query": {"term": {"k": "k04"}},
                        "sort": [{"n": "asc"}], "size": 15}),
    ("/s/_search", {}, {"query": {"match": {"t": "w0 w7"}},
                        "sort": [{"k": "desc"}, {"n": "asc"}], "size": 25}),
    ("/s/_search", {}, {"query": {"range": {"n": {"gte": 100, "lt": 700}}},
                        "sort": [{"n": "desc"}], "size": 30}),
    ("/s/_search", {}, {"query": {"match": {"t": "w1"}},
                        "collapse": {"field": "k"}, "sort": [{"n": "asc"}],
                        "size": 6}),
    ("/s/_search", {}, {"query": {"match": {"t": "w2"}}, "size": 0,
                        "aggs": {"byk": {"terms": {"field": "k"}},
                                 "h": {"histogram": {"field": "n",
                                                     "interval": 250}}}}),
    ("/s/_search", {}, {"query": {"match": {"t": "w3"}}, "size": 8,
                        "sort": [{"n": "desc"}],
                        "highlight": {"fields": {"t": {}}}}),
    ("/s/_search", {}, {"query": {"match_all": {}}, "terminate_after": 20,
                        "size": 100, "sort": [{"n": "asc"}]}),
    ("/s/_search", {}, {"query": {"match": {"t": "w0"}}, "size": 5,
                        "track_total_hits": 10}),
    ("/s/_search", {}, {"knn": {"field": "v", "query_vector": QV, "k": 6,
                                "num_candidates": 30},
                        "_source": False, "size": 6}),
    ("/s/_search", {"search_type": "dfs_query_then_fetch"},
     {"query": {"match": {"t": "w1 w4"}}, "size": 12}),
    ("/s/_search", {"search_type": "dfs_query_then_fetch"},
     {"query": {"match": {"t": "w2"}}, "sort": [{"n": "asc"}], "size": 12}),
    ("/s,one/_search", {}, {"query": {"match": {"t": "w5"}}, "size": 30}),
]


def make_docs(n=300, seed=0):
    rng = np.random.default_rng(seed)
    ns = rng.choice(1000, n, replace=False)
    docs = []
    for i in range(n):
        d = {"t": " ".join(rng.choice(VOCAB, int(rng.integers(2, 14)))),
             "n": int(ns[i]), "v": rng.standard_normal(4).round(4).tolist()}
        if i % 9:
            d["k"] = str(rng.choice(KEYWORDS))
        docs.append(d)
    return docs


def _fill(node):
    c = node.rest_controller
    for name, shards in (("s", SHARDS), ("one", 1)):
        st, r = c.dispatch("PUT", f"/{name}", {}, {
            "settings": {"index": {"number_of_shards": shards}},
            "mappings": MAPPINGS})
        assert st == 200, r
        lines = "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                        + json.dumps(d) + "\n"
                        for i, d in enumerate(make_docs(seed=shards)))
        st, r = c.dispatch("POST", f"/{name}/_bulk", {"refresh": "true"},
                           lines)
        assert st == 200 and not r["errors"], r


@pytest.fixture(scope="module")
def answers():
    """Every body on the card (counting the kernels' launches and the
    dense BM25 scorings in that window alone), then on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of csrc/ run only on "
                    "the card")
    gpu, cpu = Node(device="cuda"), Node(device="cpu")
    try:
        _fill(gpu)
        _fill(cpu)
        launches0 = (gather_bm25_contrib.launches,
                     merge_sorted_slots.launches)
        scorings0 = TRACKER.calls("bm25_dense_scores_sorted")
        on_gpu = [gpu.rest_controller.dispatch("POST", p, dict(q), b)
                  for p, q, b in BODIES]
        torch.cuda.synchronize()
        counts = dict(
            contrib=gather_bm25_contrib.launches - launches0[0],
            merge=merge_sorted_slots.launches - launches0[1],
            scorings=TRACKER.calls("bm25_dense_scores_sorted") - scorings0)
        on_cpu = [cpu.rest_controller.dispatch("POST", p, dict(q), b)
                  for p, q, b in BODIES]
        yield on_gpu, on_cpu, counts
    finally:
        gpu.close()
        cpu.close()


@pytest.mark.parametrize("bi", range(len(BODIES)))
def test_the_card_answers_the_cpu(answers, bi):
    on_gpu, on_cpu, _ = answers
    (st, got), (cst, want) = on_gpu[bi], on_cpu[bi]
    assert st == cst == 200, (got, want)
    total = SHARDS + (1 if "one" in BODIES[bi][0] else 0)
    assert got["_shards"] == {"total": total, "successful": total,
                              "skipped": 0, "failed": 0}
    assert got["hits"].get("total") == want["hits"].get("total")
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    assert [(h["_index"], h["_id"]) for h in gh] == \
        [(h["_index"], h["_id"]) for h in wh]
    np.testing.assert_allclose(
        [h["_score"] for h in gh if h["_score"] is not None],
        [h["_score"] for h in wh if h["_score"] is not None],
        rtol=1e-6, atol=0)
    for g, w in zip(gh, wh):
        for key in ("sort", "highlight", "fields", "_source"):
            assert g.get(key) == w.get(key), key
    for key in ("aggregations", "terminated_early"):
        assert got.get(key) == want.get(key), key


def test_contribution_launches_equal_the_dense_scorings(answers):
    _, _, counts = answers
    assert counts["contrib"] == counts["scorings"] > 0
    assert counts["merge"] == 0
