"""HEAD requests against the reference, on the CPU: a HEAD takes the GET
route and answers its status with no body (the existence checks of
Elasticsearch's clients: ``indices.exists``, ``exists``,
``exists_source``, ``exists_alias``, ``indices.exists_index_template``).

The seven requests of the probe, on a 2-shard index whose documents come
from a numpy seed, through both nodes' ``rest_controller.dispatch`` and
over HTTP (the port's C++ front and the reference's front). Statuses are
equal; the port's HEAD carries no body."""

import http.client
import json

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.node import Node

WORDS = ["alpha", "beta", "gamma", "delta", "omega", "sigma"]

HEADS = [
    ("/a", 200),
    ("/nope", 404),
    ("/a/_doc/1", 200),
    ("/a/_doc/999", 404),
    ("/a/_source/1", 200),
    ("/_alias/al", 200),
    ("/_index_template/none", 404),
]


def _docs(n=20, seed=7):
    rng = np.random.default_rng(seed)
    return [{"t": " ".join(rng.choice(WORDS, 4)), "n": int(rng.integers(100))}
            for _ in range(n)]


def _bulk(docs):
    return "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                   + json.dumps(d) + "\n" for i, d in enumerate(docs))


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    jax_node = JaxNode(data_path=str(tmp_path_factory.mktemp("head")))
    node = Node(device="cpu")
    for c in (jax_node.rest_controller, node.rest_controller):
        st, _ = c.dispatch("PUT", "/a", {}, {
            "mappings": {"properties": {"t": {"type": "text"},
                                        "n": {"type": "long"}}},
            "settings": {"index": {"number_of_shards": 2}}})
        assert st == 200
        st, r = c.dispatch("POST", "/a/_bulk", {"refresh": "true"},
                           _bulk(_docs()))
        assert st == 200 and not r["errors"], r
        st, _ = c.dispatch("PUT", "/a/_alias/al", {}, None)
        assert st == 200
    yield jax_node, node
    node.close()
    jax_node.close()


@pytest.mark.parametrize("path,status", HEADS)
def test_head_answers_the_get_status(nodes, path, status):
    jax_node, node = nodes
    jst, _ = jax_node.rest_controller.dispatch("HEAD", path, {}, None)
    st, body = node.rest_controller.dispatch("HEAD", path, {}, None)
    gst, _ = node.rest_controller.dispatch("GET", path, {}, None)
    assert jst == status
    assert st == jst == gst
    assert body is None


def _http_head(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("HEAD", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def ports(nodes):
    jax_node, node = nodes
    jport = jax_node.start(0)
    port = node.start(0)
    yield jport, port


@pytest.mark.parametrize("path,status", HEADS)
def test_head_over_http_answers_the_get_status(ports, path, status):
    jport, port = ports
    jst, _ = _http_head(jport, path)
    st, body = _http_head(port, path)
    assert st == jst == status
    assert body == b""
