"""The search contexts' device code on the card against the CPU.

The scroll cursor's masks (search/searcher.py ``_after_key_mask``: the
float key's three segment cases and the keyword cursor through
``_keyword_after_masks``) and the sliced scroll's mask (search/queries.py
``SliceQuery``) run on three segments built from a numpy seed, once on
the card and once on the CPU, from the same key columns: the masks are
equal bit for bit. Then whole scrolls (by score, by a number, by a
keyword, sliced) through a ``Node(device="cuda")`` and a
``Node(device="cpu")`` answer the same pages: ids, order, totals and
sort values equal, scores within rtol 1e-6, and the contribution kernel
launched once a dense scoring of the card's pages.
"""

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.queries import SliceQuery, parse_query
from elasticsearch_tpu_torch.search.searcher import (ShardSearcher,
                                                     _parse_sort,
                                                     _primary_sort_key)

pytestmark = pytest.mark.cuda

MAPPINGS = {"properties": {"t": {"type": "text"}, "k": {"type": "keyword"},
                           "n": {"type": "long"}}}
VOCAB = [f"w{i}" for i in range(20)]


def _docs(n, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = {"t": " ".join(rng.choice(VOCAB, 5)),
             "n": int(rng.integers(0, 50))}
        if i % 9:
            d["k"] = f"k{int(rng.integers(0, 15)):02d}"
        out.append(d)
    return out


def _segments(mapper, docs):
    segs = []
    for s, lo in enumerate(range(0, len(docs), 400)):
        w = SegmentWriter()
        for i in range(lo, min(lo + 400, len(docs))):
            w.add(mapper.parse(str(i), docs[i]))
        segs.append(w.build(f"ctx_{s}"))
    return segs


@pytest.mark.parametrize("sort", [None, [{"n": "desc"}], [{"n": "asc"}],
                                  [{"k": "asc"}], [{"k": "desc"}]])
def test_cursor_masks_bit_for_bit(cuda_device, sort):
    mapper = DocumentMapper(MAPPINGS)
    segs = _segments(mapper, _docs(1200))
    spec = _parse_sort(sort)
    query = parse_query({"match": {"t": "w1 w2 w3"}})
    cpu = ShardSearcher(segs, mapper, DeviceSegmentCache("cpu"))
    gpu = ShardSearcher(segs, mapper, DeviceSegmentCache(cuda_device))
    cctx, gctx = cpu._contexts(), gpu._contexts()
    keys = []
    for c in cctx:
        scores, _ = query.execute(c)
        keys.append(_primary_sort_key(c, scores, spec))
    rng = np.random.default_rng(3)
    for trial in range(12):
        cseg = int(rng.integers(0, len(segs)))
        cdoc = int(rng.integers(0, segs[cseg].n_docs))
        ck = float(keys[cseg][cdoc])
        term = None
        if sort and sort[0].get("k"):
            vals = segs[cseg].keywords["k"].get(cdoc)
            term = vals[0] if vals else None
        cursor = (ck, cseg, cdoc, term)
        for seg_idx in range(len(segs)):
            want = cpu._after_key_mask(cctx[seg_idx], seg_idx, keys[seg_idx],
                                       spec, cursor)
            got = gpu._after_key_mask(gctx[seg_idx], seg_idx,
                                      keys[seg_idx].to(cuda_device), spec,
                                      cursor)
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), want), (trial, seg_idx)


@pytest.mark.parametrize("slice_max", [2, 3, 7])
def test_slice_mask_bit_for_bit(cuda_device, slice_max):
    mapper = DocumentMapper(MAPPINGS)
    segs = _segments(mapper, _docs(1000, seed=11))
    cpu = ShardSearcher(segs, mapper, DeviceSegmentCache("cpu"))
    gpu = ShardSearcher(segs, mapper, DeviceSegmentCache(cuda_device))
    inner = parse_query({"match_all": {}})
    for sid in range(slice_max):
        q = SliceQuery(sid, slice_max, inner)
        for c, g in zip(cpu._contexts(), gpu._contexts()):
            _, want = q.execute(c)
            _, got = q.execute(g)
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), want)


def _load(node, docs):
    rest = node.rest_controller
    st, _ = rest.dispatch("PUT", "/c", {}, {
        "settings": {"index": {"number_of_shards": 2}},
        "mappings": MAPPINGS})
    assert st == 200
    for lo in range(0, len(docs), 300):
        lines = "".join(json.dumps(x) + "\n" for i in range(lo, min(
            lo + 300, len(docs))) for x in ({"index": {"_id": str(i)}},
                                           docs[i]))
        st, r = rest.dispatch("POST", "/c/_bulk", {"refresh": "true"},
                              lines)
        assert st == 200 and not r["errors"]


def _drain(node, body):
    rest = node.rest_controller
    st, r = rest.dispatch("POST", "/c/_search", {"scroll": "1m"},
                          dict(body))
    assert st == 200
    pages = [r]
    while pages[-1]["hits"]["hits"]:
        st, r = rest.dispatch("POST", "/_search/scroll", {},
                              {"scroll_id": pages[0]["_scroll_id"]})
        assert st == 200 and r["_shards"]["failed"] == 0
        pages.append(r)
    return pages


@pytest.mark.parametrize("body", [
    {"query": {"match": {"t": "w1 w4"}}, "size": 50},
    {"query": {"match": {"t": "w2"}}, "sort": [{"n": "desc"}], "size": 40},
    {"sort": [{"k": "asc"}], "size": 70},
    {"query": {"match": {"t": "w3"}}, "slice": {"id": 1, "max": 3},
     "size": 30},
])
def test_scroll_pages_on_the_card_equal_the_cpu(cuda_device, tmp_path,
                                                body):
    docs = _docs(1500, seed=5)
    gpu = Node(device="cuda", data_path=str(tmp_path / "g"))
    cpu = Node(device="cpu", data_path=str(tmp_path / "c"))
    try:
        _load(gpu, docs)
        _load(cpu, docs)
        before = gather_bm25_contrib.launches
        got = _drain(gpu, body)
        launches = gather_bm25_contrib.launches - before
        want = _drain(cpu, body)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["hits"]["total"] == w["hits"]["total"]
            gh, wh = g["hits"]["hits"], w["hits"]["hits"]
            assert [(h["_id"], h.get("sort")) for h in gh] == \
                [(h["_id"], h.get("sort")) for h in wh]
            np.testing.assert_allclose([h["_score"] or 0 for h in gh],
                                       [h["_score"] or 0 for h in wh],
                                       rtol=1e-6)
        if "query" in body:
            # one dense scoring a segment of each shard, each page
            segs = sum(len(e.segments) for e in gpu.indices["c"].shards)
            assert launches == segs * len(got)
    finally:
        gpu.close()
        cpu.close()
