"""The aggregation collectors (ops/aggs.py) on the card against the same
ops on CPU tensors and a float64 oracle, and one aggs body served by a
CUDA node.

Counts, keys, min and max equal the CPU run exactly; the card's float32
sums are atomic adds in no fixed order, so sums and sums of squares are
held to the float64 oracle within rtol 1e-4 (and to the CPU run within
the same)."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.corpus import bench_cat
from elasticsearch_tpu_torch.index.segment import segment_from_numpy
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import aggs as agg_ops
from elasticsearch_tpu_torch.ops.device import DeviceSegment
from elasticsearch_tpu_torch.telemetry.engine import TRACKER

pytestmark = pytest.mark.cuda

RTOL = 1e-4
N = 300_000


@pytest.fixture(scope="module")
def columns():
    rng = np.random.default_rng(31)
    values = np.round(rng.lognormal(8.0, 1.2, N)).astype(np.float32)
    missing = rng.random(N) < 0.02
    values[missing] = 0.0
    mask = rng.random(N) < 0.6
    return values, missing, mask


def test_terms_counts_on_the_card(cuda_device):
    ords, terms = bench_cat(N)
    seg = segment_from_numpy({"keywords": {"cat": {"terms": terms,
                                                   "ords": ords}}})
    mask = np.zeros(DeviceSegment(seg, "cpu").n_docs_padded, bool)
    mask[:N] = np.random.default_rng(5).random(N) < 0.3
    out = []
    for dev in (cuda_device, "cpu"):
        perm, starts = DeviceSegment(seg, dev).keyword_ord_major("cat")
        out.append(agg_ops.terms_counts_per_term(
            perm, starts, torch.from_numpy(mask).to(dev)))
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_array_equal(
        out[0], np.bincount(ords[mask[:N]], minlength=len(terms)))


def test_metric_stats_on_the_card(cuda_device, columns):
    values, missing, mask = columns
    gpu = agg_ops.masked_metric_stats(*(torch.from_numpy(a).to(cuda_device)
                                        for a in columns))
    cpu = agg_ops.masked_metric_stats(*map(torch.from_numpy, columns))
    sel = mask & ~missing
    v = values[sel].astype(np.float64)
    assert gpu[0] == cpu[0] == int(sel.sum())
    assert gpu[2] == cpu[2] == float(v.min())
    assert gpu[3] == cpu[3] == float(v.max())
    np.testing.assert_allclose([gpu[1], gpu[4]], [v.sum(), (v * v).sum()],
                               rtol=RTOL)
    np.testing.assert_allclose([gpu[1], gpu[4]], [cpu[1], cpu[4]],
                               rtol=RTOL)


@pytest.mark.parametrize("nb", [48, 4096])
def test_bucket_collectors_on_the_card(cuda_device, columns, nb):
    values, missing, mask = columns
    ids = np.random.default_rng(nb).integers(0, nb, N).astype(np.int32)
    args = (ids, mask, values, missing)
    gpu = [agg_ops.bucket_counts(torch.from_numpy(ids).to(cuda_device),
                                 torch.from_numpy(mask).to(cuda_device), nb),
           agg_ops.bucket_metric_columns(
               *(torch.from_numpy(a).to(cuda_device) for a in args), nb)]
    cpu = [agg_ops.bucket_counts(torch.from_numpy(ids),
                                 torch.from_numpy(mask), nb),
           agg_ops.bucket_metric_columns(*map(torch.from_numpy, args), nb)]
    np.testing.assert_array_equal(gpu[0], cpu[0])
    np.testing.assert_array_equal(gpu[0], np.bincount(ids[mask],
                                                      minlength=nb))
    sel = mask & ~missing
    v = values.astype(np.float64)
    want_s = np.bincount(ids[sel], v[sel], minlength=nb)
    want_ss = np.bincount(ids[sel], v[sel] ** 2, minlength=nb)
    cnt, s, mn, mx, ss = gpu[1]
    np.testing.assert_array_equal(cnt, cpu[1][0])
    np.testing.assert_array_equal(mn, cpu[1][2])
    np.testing.assert_array_equal(mx, cpu[1][3])
    np.testing.assert_allclose(s, want_s, rtol=RTOL)
    np.testing.assert_allclose(ss, want_ss, rtol=RTOL)


def test_an_aggs_body_through_a_cuda_node(cuda_device):
    """The bench's match+terms-agg body shape on a CUDA node and on a CPU
    node over the same segment: equal aggregations, and every collector
    of the body launched on the card."""
    rng = np.random.default_rng(9)
    n = 250_000      # above DEVICE_AGG_MIN_DOCS: the device collectors
    ords, terms = bench_cat(n)
    word = rng.random(n) < 0.4
    docids = np.nonzero(word)[0].astype(np.int32)
    nb = (len(docids) + 127) // 128
    block_docids = np.zeros(nb * 128, np.int32)
    block_tfs = np.zeros(nb * 128, np.float32)
    block_docids[:len(docids)] = docids
    block_tfs[:len(docids)] = 1.0
    price = np.round(rng.random(n) * 100, 2)
    arrays = {"fields": {"title": dict(
        terms=["w"], doc_freq=np.array([len(docids)], np.int32),
        term_block_start=np.array([0]), term_block_count=np.array([nb]),
        block_docids=block_docids.reshape(nb, 128),
        block_tfs=block_tfs.reshape(nb, 128),
        field_lengths=np.ones(n, np.float32))},
        "keywords": {"cat": {"terms": terms, "ords": ords}},
        "numerics": {"price": {"values": price}}}
    body = {"query": {"match": {"title": "w"}}, "size": 0,
            "aggs": {"cats": {"terms": {"field": "cat"},
                              "aggs": {"p": {"avg": {"field": "price"}}}},
                     "st": {"stats": {"field": "price"}},
                     "h": {"histogram": {"field": "price", "interval": 5},
                           "aggs": {"s": {"sum": {"field": "price"}}}}}}
    answers = []
    kernels = [getattr(agg_ops, f).kernel_name for f in (
        "terms_counts_per_term", "masked_metric_stats", "bucket_counts",
        "bucket_metric_columns")]
    before = {name: TRACKER.calls(name) for name in kernels}
    for dev in (cuda_device, "cpu"):
        node = Node(device=dev)
        try:
            node.create_index("t", {"properties": {
                "title": {"type": "text"}, "cat": {"type": "keyword"},
                "price": {"type": "double"}}})
            node.indices["t"].engine.install_segments(
                [segment_from_numpy(arrays, name="t0")])
            st, r = node.rest_controller.dispatch("POST", "/t/_search", {},
                                                  body)
            assert st == 200, r
            answers.append(r)
        finally:
            node.close()
        if dev is cuda_device:
            for f, b in before.items():
                assert TRACKER.calls(f) > b, f
    gpu, cpu = answers
    assert gpu["hits"]["total"] == cpu["hits"]["total"]
    ga, ca = gpu["aggregations"], cpu["aggregations"]
    assert [(b["key"], b["doc_count"]) for b in ga["cats"]["buckets"]] == \
        [(b["key"], b["doc_count"]) for b in ca["cats"]["buckets"]]
    assert ga["cats"]["buckets"][0]["key"] == "c000"
    for g, c in zip(ga["cats"]["buckets"], ca["cats"]["buckets"]):
        assert g["p"]["value"] == pytest.approx(c["p"]["value"], rel=RTOL)
    assert (ga["st"]["count"], ga["st"]["min"], ga["st"]["max"]) == \
        (ca["st"]["count"], ca["st"]["min"], ca["st"]["max"])
    assert ga["st"]["sum"] == pytest.approx(
        float(price[word].astype(np.float32).astype(np.float64).sum()),
        rel=RTOL)
    assert [(b["key"], b["doc_count"]) for b in ga["h"]["buckets"]] == \
        [(b["key"], b["doc_count"]) for b in ca["h"]["buckets"]]
    for g, c in zip(ga["h"]["buckets"], ca["h"]["buckets"]):
        assert g["s"]["value"] == pytest.approx(c["s"]["value"], rel=RTOL)
