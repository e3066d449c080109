"""Restarts against the reference: each package writes, flushes, writes
more (held by the translog only), closes, and a new node on the same
path answers every GET, ``_mget`` and ``_search`` as before the restart
and as the reference's restarted node does. The port also opens a data
path the reference's Node wrote (segments, commit points, translogs and
``_meta.json``) and carries its state across. Ids, order and totals
exact; scores rtol 1e-6 on the plan and dense rails (the fast path of a
one-shard, one-segment index, the dense executor's BM25 through the
contribution kernel's plain twin)."""

import json
import shutil

import numpy as np
import pytest

from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import plan as port_plan
from test_torch_shards import assert_same_hits

MAPPINGS = {"properties": {"t": {"type": "text"}, "k": {"type": "keyword"},
                           "n": {"type": "long"}}}
WORDS = ["amber", "dune", "cedar", "fjord", "mesa", "krill", "lagoon",
         "harbor", "granite", "ember"]
N_DOCS = 240

BODIES = {
    # one shard, one segment: the fast path's grammar
    "fast": {"query": {"match": {"t": "amber dune"}}, "size": 20},
    # the plan path
    "plan": {"query": {"bool": {"should": [{"match": {"t": "cedar"}},
                                           {"match": {"t": "fjord mesa"}}],
                                "filter": [{"term": {"k": "x"}}]}},
             "size": 20},
    # the dense executor: min_score takes it, BM25 through the
    # contribution kernel's twin
    "dense": {"query": {"match": {"t": "krill lagoon"}}, "min_score": 0.1,
              "size": 20},
    "sorted": {"query": {"match_all": {}}, "sort": [{"n": "desc"}],
               "size": 30, "version": True, "seq_no_primary_term": True},
}


def docs(rng, n, start=0):
    return [(str(start + i), {"t": " ".join(rng.choice(WORDS, 5)),
                              "k": str(rng.choice(["x", "y"])),
                              "n": int(start + i)})
            for i in range(n)]


def ndjson(*objs):
    return "".join(json.dumps(o) + "\n" for o in objs)


def ask(node, method, path, params=None, body=None, expect=200):
    st, r = node.rest_controller.dispatch(method, path, params or {}, body)
    assert st == expect, (method, path, st, r)
    if isinstance(r, dict):
        r.pop("took", None)
        r.pop("_headers", None)
    return r


def write_phase_one(node, shards, rng):
    ask(node, "PUT", "/d", body={
        "settings": {"index": {"number_of_shards": shards}},
        "mappings": MAPPINGS})
    items = docs(rng, N_DOCS)
    ask(node, "POST", "/d/_bulk", {"refresh": "true"},
        ndjson(*[x for i, d in items for x in ({"index": {"_id": i}}, d)]))
    ask(node, "POST", "/d/_forcemerge")
    ask(node, "POST", "/d/_flush")


def write_phase_two(node, rng):
    """Ops only the translog holds: updates, deletes, new docs, a CAS
    and a scripted update."""
    lines = []
    for i in rng.choice(N_DOCS, 30, replace=False):
        lines += [{"update": {"_id": str(i)}},
                  {"doc": {"t": " ".join(rng.choice(WORDS, 3))}}]
    for i in rng.choice(N_DOCS, 20, replace=False):
        lines.append({"delete": {"_id": str(i)}})
    for i, d in docs(rng, 25, start=N_DOCS):
        lines += [{"index": {"_id": i}}, d]
    ask(node, "POST", "/d/_bulk", {}, ndjson(*lines))
    st, r = node.rest_controller.dispatch("GET", "/d/_doc/1", {}, None)
    if st == 200:
        ask(node, "PUT", "/d/_doc/1",
            {"if_seq_no": str(r["_seq_no"]),
             "if_primary_term": str(r["_primary_term"])}, {"t": "cas won"})
    ask(node, "POST", "/d/_update/2", {}, {"script": {
        "source": "ctx._source.n += 1000"}, "upsert": {"n": 1}})


def snapshot(node):
    """Every id's GET (through _mget) and every body's answer after a
    refresh and a force merge."""
    ids = [str(i) for i in range(N_DOCS + 25)]
    gets = ask(node, "POST", "/d/_mget", {}, {"ids": ids})
    ask(node, "POST", "/d/_refresh")
    ask(node, "POST", "/d/_forcemerge")
    # one hit past the page: the tie-aware compare sees whether the
    # page cuts a group of equal scores
    return gets, {k: ask(node, "POST", "/d/_search", {},
                         dict(b, size=b["size"] + 1))
                  for k, b in BODIES.items()}


def assert_same_answer(got, want, key):
    """The page of ``BODIES[key]`` (``got``/``want`` hold one hit more):
    exact ids, order and totals with scores rtol 1e-6, or, where the
    reference splits a true tie, the tie-aware compare at rtol 1e-4;
    each hit's metadata and source equal."""
    size = BODIES[key]["size"]
    got = {"hits": dict(got["hits"], hits=got["hits"]["hits"][:size])}
    gh, wh = got["hits"]["hits"], want["hits"]["hits"][:size]
    gs = np.array([np.nan if h["_score"] is None else h["_score"]
                   for h in gh])
    ws = np.array([np.nan if h["_score"] is None else h["_score"]
                   for h in wh])
    if not ([h["_id"] for h in gh] == [h["_id"] for h in wh]
            and got["hits"]["total"] == want["hits"]["total"]
            and np.allclose(gs, ws, rtol=1e-6, atol=0, equal_nan=True)):
        tied = any(abs(a - b) <= 1e-4 * abs(a) for a, b in zip(ws, ws[1:]))
        assert tied, (key, gh, wh)
        assert_same_hits(got, want, size)
    by_id = {h["_id"]: h for h in wh}
    for g in gh:
        w = by_id.get(g["_id"])
        if w is None:       # the other side of a tie the page cuts
            continue
        for meta in ("_version", "_seq_no", "_primary_term", "_source",
                     "sort"):
            assert g.get(meta) == w.get(meta), (key, meta, g, w)


def restart_port(path, **kw):
    return Node(device="cpu", data_path=path, **kw)


@pytest.mark.parametrize("shards", [1, 2])
def test_restart_answers_as_before_and_as_the_reference(tmp_path, shards):
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    answers = {}
    for name, make in (("jax", lambda p: JaxNode(Settings.EMPTY,
                                                 data_path=p)),
                       ("port", restart_port)):
        path = jpath if name == "jax" else ppath
        rng = np.random.default_rng(11)
        node = make(path)
        write_phase_one(node, shards, rng)
        write_phase_two(node, rng)
        node.close()
        node = make(path)
        try:
            answers[name] = snapshot(node)
        finally:
            node.close()
    (jgets, jsearch), (pgets, psearch) = answers["jax"], answers["port"]
    assert pgets == jgets
    for key in BODIES:
        assert_same_answer(psearch[key], jsearch[key], key)


def test_restart_keeps_answers_and_serves_the_fast_path(tmp_path,
                                                        monkeypatch):
    """A one-shard index answers the same GETs and searches before and
    after the restart, bit for bit; the restarted node serves the fast
    body through the fast path and the dense body through the
    contribution kernel (its plain twin here)."""
    path = str(tmp_path / "p")
    rng = np.random.default_rng(3)
    node = restart_port(path)
    write_phase_one(node, 1, rng)
    write_phase_two(node, rng)
    before = snapshot(node)
    node.close()
    calls = []
    real = port_plan.gather_bm25_contrib

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(port_plan, "gather_bm25_contrib", counted)
    node = restart_port(path)
    try:
        after = snapshot(node)
        assert after[0] == before[0]
        for key in BODIES:
            assert after[1][key] == before[1][key], key
        fp = node.fastpath
        n_fast = sum(fp.serving_stats()["dispatch"].values())
        dense0 = len(calls)
        ask(node, "POST", "/d/_search", {}, BODIES["fast"])
        assert sum(fp.serving_stats()["dispatch"].values()) == n_fast + 1
        ask(node, "POST", "/d/_search", {}, BODIES["dense"])
        assert len(calls) > dense0
    finally:
        node.close()


def test_port_opens_a_reference_data_path(tmp_path):
    """The reference's Node writes and closes; the port opens a copy of
    its data path and answers every GET and search as the reference
    reopened on the original does, then goes on writing with the
    reference's versions and seq_nos."""
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "copy")
    rng = np.random.default_rng(21)
    jax_node = JaxNode(Settings.EMPTY, data_path=jpath)
    write_phase_one(jax_node, 2, rng)
    write_phase_two(jax_node, rng)
    jax_node.close()
    shutil.copytree(jpath, ppath)
    jax_node = JaxNode(Settings.EMPTY, data_path=jpath)
    node = restart_port(ppath)
    try:
        assert sorted(node.indices) == ["d"]
        jgets, jsearch = snapshot(jax_node)
        pgets, psearch = snapshot(node)
        assert pgets == jgets
        for key in BODIES:
            assert_same_answer(psearch[key], jsearch[key], key)
        for n in (jax_node, node):
            ask(n, "PUT", "/d/_doc/3", {}, {"t": "after the move"})
        assert ask(node, "GET", "/d/_doc/3") == \
            ask(jax_node, "GET", "/d/_doc/3")
    finally:
        node.close()
        jax_node.close()


def _metadata_state(node):
    """Write, through REST, the metadata a data path carries: aliases
    (one filtered), an index template, a data stream rolled over once, a
    closed index and a stored script."""
    ask(node, "PUT", "/ev", body={"mappings": {"properties": {
        "team": {"type": "keyword"}, "n": {"type": "long"},
        "t": {"type": "text"}}}})
    ask(node, "POST", "/ev/_bulk", {"refresh": "true"}, ndjson(*[
        x for i in range(12) for x in (
            {"index": {"_id": str(i)}},
            {"team": "red" if i % 3 else "blue", "n": i,
             "t": f"amber dune {WORDS[i % len(WORDS)]}"})]))
    ask(node, "POST", "/_aliases", body={"actions": [
        {"add": {"index": "ev", "alias": "all_ev"}},
        {"add": {"index": "ev", "alias": "red_ev",
                 "filter": {"term": {"team": "red"}}}}]})
    ask(node, "PUT", "/_index_template/metrics", body={
        "index_patterns": ["metrics-*"], "data_stream": {}, "priority": 5,
        "template": {"mappings": {"properties": {
            "value": {"type": "double"}}}}})
    ask(node, "PUT", "/_data_stream/metrics-cpu")
    # (the reference's ``_bulk?refresh`` on a data stream refreshes the
    # stream's name, not its write index, and answers 404: refresh apart)
    ask(node, "POST", "/metrics-cpu/_bulk", {}, ndjson(
        {"create": {"_id": "1"}}, {"@timestamp": "2026-01-01T00:00:00Z",
                                   "value": 0.5}))
    ask(node, "POST", "/metrics-cpu/_refresh")
    ask(node, "POST", "/metrics-cpu/_rollover")
    ask(node, "POST", "/metrics-cpu/_bulk", {}, ndjson(
        {"create": {"_id": "2"}}, {"@timestamp": "2026-01-02T00:00:00Z",
                                   "value": 0.7}))
    ask(node, "POST", "/metrics-cpu/_refresh")
    ask(node, "PUT", "/shut/_doc/1", {"refresh": "true"}, {"v": 1},
        expect=201)
    ask(node, "POST", "/shut/_close")
    ask(node, "PUT", "/_scripts/boost", body={"script": {
        "lang": "painless", "source": "doc['n'].value + _score"}})
    for name in ("ev", "metrics-cpu"):
        ask(node, "POST", f"/{name}/_flush")


def test_port_opens_reference_metadata_and_scripts(tmp_path):
    """The reference's Node writes aliases, a template, a rolled-over
    data stream, a closed index and a stored script, and closes; the
    port opens a copy of its data path and answers ``GET /_alias``,
    ``GET /_data_stream``, searches through both aliases and the
    stream, the closed index's error and a ``script_score`` by id as
    the reference reopened on the original does."""
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "copy")
    jax_node = JaxNode(Settings.EMPTY, data_path=jpath)
    _metadata_state(jax_node)
    jax_node.close()
    shutil.copytree(jpath, ppath)
    jax_node = JaxNode(Settings.EMPTY, data_path=jpath)
    node = restart_port(ppath)
    try:
        def both(method, path, params=None, body=None):
            out = []
            for n in (jax_node, node):
                st, r = n.rest_controller.dispatch(method, path,
                                                   dict(params or {}), body)
                if isinstance(r, dict):
                    r.pop("took", None)
                    r.pop("_headers", None)
                out.append((st, r))
            return out

        for path in ("/_alias", "/_alias/red_ev", "/ev/_alias",
                     "/_data_stream", "/_index_template/metrics",
                     "/_scripts/boost"):
            (jst, ref), (st, got) = both("GET", path)
            assert (st, got) == (jst, ref), path
        bodies = [
            ("/red_ev/_search", {"sort": [{"n": "asc"}], "size": 20}),
            ("/all_ev/_search", {"query": {"match": {"t": "amber"}},
                                 "size": 20}),
            ("/red_ev/_count", {}),
            ("/metrics-cpu/_search", {"sort": [{"value": "asc"}]}),
            ("/ev/_search", {"query": {"script_score": {
                "query": {"match": {"t": "dune"}},
                "script": {"id": "boost"}}}, "size": 20}),
            ("/shut/_search", {}),
        ]
        for path, body in bodies:
            (jst, ref), (st, got) = both("POST", path, {}, body)
            assert st == jst, (path, got, ref)
            if "hits" not in got:
                assert got == ref, path
                continue
            # the tie-aware compare: the plan path may order a true
            # tie apart
            assert_same_hits(got, ref, len(ref["hits"]["hits"]))
        (jst, ref), (st, got) = both("GET", "/shut/_doc/1")
        assert (st, got) == (jst, ref) and st == 400
        (jst, ref), (st, got) = both("POST", "/metrics-cpu/_doc", {},
                                     {"@timestamp": "2026-01-03T00:00:00Z"})
        assert st == jst == 201
        assert got["_index"] == ref["_index"] == "metrics-cpu"
    finally:
        node.close()
        jax_node.close()


def test_own_temporary_data_path_is_removed_at_close():
    node = Node(device="cpu")
    path = node.data_path
    ask(node, "PUT", "/t/_doc/1", {}, {"t": "x"}, expect=201)
    import os
    assert os.path.isdir(os.path.join(path, "t", "0", "translog"))
    node.close()
    assert not os.path.exists(path)


def test_a_strict_mapping_survives_the_restart(tmp_path):
    """``dynamic: strict`` and the dynamic fields a write added are
    persisted in ``_meta.json`` and hold after the restart."""
    path = str(tmp_path / "p")
    node = restart_port(path)
    ask(node, "PUT", "/s", body={"mappings": {
        "dynamic": "strict", "properties": {"t": {"type": "text"}}}})
    ask(node, "PUT", "/g/_doc/1", {}, {"t": "x", "added": 5}, expect=201)
    node.close()
    node = restart_port(path)
    try:
        st, r = node.rest_controller.dispatch("PUT", "/s/_doc/1", {},
                                              {"other": 1})
        assert st == 400
        assert r["error"]["type"] == "strict_dynamic_mapping_exception"
        assert ask(node, "GET", "/g/_mapping")["g"]["mappings"][
            "properties"]["added"] == {"type": "long"}
    finally:
        node.close()


@pytest.mark.parametrize("shards", [1, 3])
def test_acknowledged_writes_are_in_the_translog_files(tmp_path, shards):
    """Once a ``_bulk`` or a single-doc request is answered, its ops are
    in the shards' translog files (no ``_flush``, the node still open):
    a reader of the files alone finds every acknowledged op."""
    import os
    from elasticsearch_tpu_torch.index.translog import Translog
    path = str(tmp_path / "p")
    node = restart_port(path)
    try:
        ask(node, "PUT", "/w", body={"settings": {"index": {
            "number_of_shards": shards}}})
        rng = np.random.default_rng(7)
        lines = []
        for i, src in docs(rng, 40):
            lines += [{"index": {"_id": i}}, src]
        r = ask(node, "POST", "/w/_bulk", {}, ndjson(*lines))
        acked = {it["index"]["_id"] for it in r["items"]
                 if it["index"]["status"] == 201}
        r = ask(node, "PUT", "/w/_doc/solo", {}, {"t": "x"}, expect=201)
        r2 = ask(node, "DELETE", "/w/_doc/3")
        seen = []
        for shard in range(shards):
            log = Translog(os.path.join(path, "w", str(shard), "translog"))
            seen += [(shard, op.op_type, op.doc_id) for op in log.read_ops()]
            log.close()
        assert sorted(d for _s, kind, d in seen if kind == "index") == \
            sorted([str(i) for i in range(40)] + ["solo"])
        assert [d for _s, kind, d in seen if kind == "delete"] == ["3"]
        assert len(acked) == 40 and r["result"] == "created"
        assert r2["result"] == "deleted"
    finally:
        node.close()
