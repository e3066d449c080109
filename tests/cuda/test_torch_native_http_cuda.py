"""The port's C++ front on the card: a Node on CUDA serves a seeded corpus
of one segment through ``Node.start``; each ``_source: false``
match body is parsed in C++ and answered by a fast lane whose kernels
launch on the card, with the float64 oracle's top k (ids in the served
order) and its exact total; a body beyond the largest bucket is bounced
to the plan path and still holds the oracle."""

import json
import urllib.request

import numpy as np
import pytest

from elasticsearch_tpu_torch.corpus import (build_corpus, exact_topk,
                                            segment_from_corpus, term_name)
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.rest import native_http

pytestmark = pytest.mark.cuda


def post(port, body):
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}/idx/_search",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=120) as resp:
        return json.loads(resp.read())


def test_native_front_on_card(cuda_device):
    c = build_corpus(np.random.default_rng(11), n_docs=100000, vocab=5000)
    df = c["df"]
    rng = np.random.default_rng(12)
    queries = [sorted(int(t) for t in rng.choice(np.nonzero(
        (df >= 50) & (df <= 3000))[0], n, replace=False))
        for n in (1, 2, 3, 5, 8)]
    node = Node(device=cuda_device)
    try:
        node.create_index("idx", {"properties": {"title": {"type": "text"}}})
        node.indices["idx"].engine.install_segments([segment_from_corpus(c)])
        port = node.start(0)
        assert isinstance(node._http, native_http.NativeHttpFront)
        assert node.fastpath.front_registration()["index"] == "idx"
        fast0 = node.http_stats()["fast"]
        launches0 = gather_bm25_contrib.launches
        for q in queries:
            for k in (10, 1000):
                r = post(port, {"query": {"match": {"title": " ".join(
                    term_name(t) for t in q)}}, "size": k,
                    "_source": False})
                ids, scores, total = exact_topk(c, q, k)
                order = ids[np.lexsort((ids, -scores.astype(np.float32)))]
                assert r["hits"]["total"] == {"value": total,
                                              "relation": "eq"}
                assert [int(h["_id"]) for h in r["hits"]["hits"]] == \
                    order.tolist()
                np.testing.assert_allclose(
                    [h["_score"] for h in r["hits"]["hits"]],
                    np.sort(scores)[::-1], rtol=1e-5)
        assert node.http_stats()["fast"] == fast0 + 2 * len(queries)
        assert node.http_stats()["bounced"] == 0
        assert gather_bm25_contrib.launches > launches0
        # the 16 terms of highest df: about 5200 blocks, beyond the
        # largest bucket
        big = [int(t) for t in np.argsort(-df)[:16]]
        r = post(port, {"query": {"match": {"title": " ".join(
            term_name(t) for t in big)}}, "size": 100, "_source": False})
        assert node.http_stats()["bounced"] == 1
        ids, scores, total = exact_topk(c, big, 100)
        assert r["hits"]["total"] == {"value": total, "relation": "eq"}
        got = [int(h["_id"]) for h in r["hits"]["hits"]]
        missing = ~np.isin(ids, got)
        assert np.all(np.abs(scores[missing] - scores[-1])
                      <= 1e-5 * scores[-1])
    finally:
        node.close()
