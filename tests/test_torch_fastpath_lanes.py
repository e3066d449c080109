"""The port's v1 and v2 cohort launches (elasticsearch_tpu_torch/ops/
fastpath.py ``bm25_topk_total_batch``, ``bm25_candidates_rerank_batch``)
against the reference's functions of the same names on the same cohort
(Q = 4, NB = 64, 16 slots): at float32 the packed rows agree, ids,
totals and the certificate exactly and values within rtol 1e-6, on
tie-heavy cohorts and mask rows with dead docs too. At float64 v1 agrees
with a numpy float64 oracle. Also ``stable_topk(bound_slot=True)``, the
filter masks, and the serving front's mask rows, cohort chunking and lane
routing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.index.segment import SegmentWriter as JaxWriter
from elasticsearch_tpu.ops import fastpath as jfp
from elasticsearch_tpu.ops.device import DeviceSegment as JaxDeviceSegment
from elasticsearch_tpu_torch.corpus import build_corpus
from elasticsearch_tpu_torch.index.segment import segment_from_numpy
from elasticsearch_tpu_torch.ops import fastpath as tfp
from elasticsearch_tpu_torch.ops.device import DeviceSegment
from elasticsearch_tpu_torch.ops.plan import unpack_ids
from elasticsearch_tpu_torch.ops.topk import stable_topk
from elasticsearch_tpu_torch.search import fastpath as srv
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache

Q, NB, N_SLOTS, K = 4, 64, 16, 50
K1, B = 1.2, 0.75
BLOCK = 128


def cohort(seed, n_docs=3000, equal_lens=False, slotted=True,
           shape="random"):
    """A seeded corpus in block layout (+ the reserved zero block), a
    cohort's block selection (slotted: each term instance on a slot
    boundary; else back to back), v2's term-instance table, and a mask
    stack whose row 1 has dead docs (queries 1 and 3 read it).

    ``shape``: "random" (up to 6 terms that fit), "duplicate" (a term
    twice, six terms, one term, a term twice) or "wide" (four terms of 8
    to 16 blocks each: a union of more than CAND_V2 docs, so the v2
    certificate has a finite bound)."""
    rng = np.random.default_rng(seed)
    c = build_corpus(rng, n_docs=n_docs, vocab=400)
    lens = c["lens"]
    if equal_lens:      # scores then depend on tf and idf only: ties
        lens = np.full_like(lens, 12.0)
    # the reserved zero block at index tb, then zero blocks up to a
    # multiple of 1024: equal shapes across seeds, so the reference
    # compiles its launch once
    tb = c["block_docids"].shape[0]
    zeros = -(-(tb + 1) // 1024) * 1024 - tb
    bd = np.concatenate([c["block_docids"],
                         np.zeros((zeros, BLOCK), np.int32)])
    bt = np.concatenate([c["block_tfs"], np.zeros((zeros, BLOCK),
                                                  np.float32)])
    df, nb, starts = c["df"], c["nb"], c["tbs"]
    idf = np.log1p((n_docs - df + 0.5) / (df + 0.5))
    slot = NB // N_SLOTS
    if shape == "duplicate":
        s = [int(t) for t in np.nonzero((nb > 0) & (nb <= slot))[0][:10]]
        queries = [[s[0], s[0], s[1]], s[2:8], [s[8]], [s[9], s[9]]]
    elif shape == "wide":
        mid = np.nonzero((nb >= 8) & (nb <= 16))[0]
        queries = [sorted(int(t) for t in rng.choice(mid, 4, replace=False))
                   for _ in range(Q)]
    else:
        queries = []
        for _ in range(Q):
            pos, terms = 0, []
            for t in rng.permutation(np.nonzero(nb > 0)[0]):
                need = -(-int(nb[t]) // slot) * slot
                if pos + need > NB or len(terms) == 6:
                    continue
                pos += need
                terms.append(int(t))
            queries.append(terms)
    sel = np.full((Q, NB), tb, np.int32)
    ws = np.zeros((Q, NB), np.float64)
    ts = np.zeros((Q, tfp.MAX_T), np.int32)
    tl = np.zeros((Q, tfp.MAX_T), np.int32)
    ti = np.zeros((Q, tfp.MAX_T), np.float64)
    for qi, terms in enumerate(queries):
        pos = 0
        for i, t in enumerate(terms):
            sel[qi, pos:pos + nb[t]] = np.arange(starts[t], starts[t] + nb[t])
            ws[qi, pos:pos + nb[t]] = idf[t]
            ts[qi, i], tl[qi, i], ti[qi, i] = starts[t] * BLOCK, df[t], idf[t]
            pos += -(-int(nb[t]) // slot) * slot if slotted else int(nb[t])
    masks = np.ones((tfp.F_SLOTS, n_docs), bool)
    masks[1] = rng.random(n_docs) < 0.8
    mids = np.array([0, 1, 0, 1], np.int32)
    return dict(bd=bd, bt=bt, sel=sel, ws=ws, ts=ts, tl=tl, ti=ti,
                lens=lens.astype(np.float32), masks=masks, mids=mids,
                queries=queries, corpus=c, idf=idf)


def mass_tie_cohort():
    """One term in every one of 8192 docs, tf 1, equal lengths: every
    match scores the same, a tie class wider than CAND_V2."""
    n = 8192
    nblk = n // BLOCK
    bd = np.concatenate([np.arange(n, dtype=np.int32).reshape(nblk, BLOCK),
                         np.zeros((1, BLOCK), np.int32)])
    bt = np.concatenate([np.ones((nblk, BLOCK), np.float32),
                         np.zeros((1, BLOCK), np.float32)])
    sel = np.full((Q, NB), nblk, np.int32)
    sel[0] = np.arange(nblk)
    ws = np.zeros((Q, NB))
    ws[0] = 0.5
    ts = np.zeros((Q, tfp.MAX_T), np.int32)
    tl = np.zeros((Q, tfp.MAX_T), np.int32)
    ti = np.zeros((Q, tfp.MAX_T))
    tl[0, 0], ti[0, 0] = n, 0.5
    return dict(bd=bd, bt=bt, sel=sel, ws=ws, ts=ts, tl=tl, ti=ti,
                lens=np.full(n, 10.0, np.float32),
                masks=np.ones((tfp.F_SLOTS, n), bool),
                mids=np.zeros(Q, np.int32))


def f32_avg(d):
    return float(np.float32(d["lens"].mean()))


def ref_v1(d, avg):
    return np.asarray(jfp.bm25_topk_total_batch(
        jnp.asarray(d["bd"]), jnp.asarray(d["bt"]), jnp.asarray(d["sel"]),
        jnp.asarray(d["ws"].astype(np.float32)), jnp.asarray(d["lens"]),
        jnp.asarray(d["masks"]), jnp.asarray(d["mids"]), np.float32(avg),
        K1, B, K))


def port_v1(d, avg, dtype):
    t = torch.from_numpy
    return tfp.bm25_topk_total_batch(
        t(d["bd"]), t(d["bt"]), t(d["sel"]), t(d["ws"]).to(dtype),
        t(d["lens"]), t(d["masks"]), t(d["mids"]), avg, K1, B, K,
        score_dtype=dtype).numpy()


def ref_v2(d, avg):
    return np.asarray(jfp.bm25_candidates_rerank_batch(
        jnp.asarray(d["bd"]), jnp.asarray(d["bt"]),
        jnp.asarray(d["bd"].reshape(-1)), jnp.asarray(d["bt"].reshape(-1)),
        jnp.asarray(d["sel"]), jnp.asarray(d["ws"].astype(np.float32)),
        jnp.asarray(d["lens"]), jnp.asarray(d["masks"]),
        jnp.asarray(d["mids"]), jnp.asarray(d["ts"]), jnp.asarray(d["tl"]),
        jnp.asarray(d["ti"].astype(np.float32)), np.float32(avg), N_SLOTS,
        K1, B, K))


def port_v2(d, avg, dtype):
    t = torch.from_numpy
    return tfp.bm25_candidates_rerank_batch(
        t(d["bd"]), t(d["bt"]), t(d["bd"]).view(-1), t(d["bt"]).view(-1),
        t(d["sel"]), t(d["ws"]).to(torch.float32), t(d["lens"]),
        t(d["masks"]), t(d["mids"]), t(d["ts"]), t(d["tl"]),
        t(d["ti"]).to(dtype), avg, N_SLOTS, K1, B, K,
        score_dtype=dtype).numpy()


def assert_rows_equal(got, ref, n_exact):
    """ids, totals (and ok) exact; values within rtol 1e-6."""
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, K:K + n_exact],
                                  ref[:, K:K + n_exact])
    np.testing.assert_allclose(got[:, :K], ref[:, :K], rtol=1e-6, atol=0)


LANE_CASES = [(0, False), (1, False), (2, True), (3, True)]


@pytest.mark.parametrize("seed,equal_lens", LANE_CASES)
def test_v1_matches_reference_f32(seed, equal_lens):
    d = cohort(seed, equal_lens=equal_lens, slotted=False)
    assert not d["masks"][1].all()          # queries 1, 3: dead docs
    avg = f32_avg(d)
    got, ref = port_v1(d, avg, torch.float32), ref_v1(d, avg)
    assert_rows_equal(got, ref, K + 1)
    if equal_lens:      # the inputs really are tie-heavy at the cut
        assert any(len(np.unique(v[np.isfinite(v)])) < K // 2
                   for v in got[:, :K])


def oracle(d, qi, avg):
    """float64 per-doc BM25 over the query's terms, live docs of its mask
    row only: (ids by (score desc, docid asc) [:K], scores, total)."""
    c = d["corpus"]
    lens = d["lens"].astype(np.float64)
    scores = np.zeros(len(lens))
    for t in d["queries"][qi]:
        lo, hi = c["group_start"][t], c["group_start"][t + 1]
        docs, tf = c["doc_ids"][lo:hi], c["tf"][lo:hi].astype(np.float64)
        scores[docs] += d["idf"][t] * tf / (
            tf + K1 * (1 - B + B * lens[docs] / avg))
    scores[~d["masks"][d["mids"][qi]]] = 0.0
    matched = np.nonzero(scores > 0)[0]
    top = matched[np.lexsort((matched, -scores[matched]))][:K]
    return top, scores[top], len(matched)


@pytest.mark.parametrize("seed", [4, 5])
def test_v1_f64_rail_matches_numpy_oracle(seed):
    d = cohort(seed, slotted=False)
    avg = float(d["lens"].astype(np.float64).mean())
    got = port_v1(d, avg, torch.float64)
    for qi in range(Q):
        ids, scores, total = oracle(d, qi, avg)
        n = len(ids)
        assert int(got[qi, 2 * K]) == total
        np.testing.assert_array_equal(unpack_ids(got[qi, K:K + n]), ids)
        np.testing.assert_allclose(got[qi, :n], scores.astype(np.float32),
                                   rtol=1e-7, atol=0)
        assert np.isneginf(got[qi, n:K]).all()


@pytest.mark.parametrize("case", ["seed0", "seed1", "ties2", "ties3",
                                  "duplicate_terms", "wide", "mass_ties"])
def test_v2_matches_reference_f32(case):
    if case == "mass_ties":
        d = mass_tie_cohort()
    elif case == "duplicate_terms":
        d = cohort(6, shape="duplicate")
    elif case == "wide":
        d = cohort(8, n_docs=12000, shape="wide")
    else:
        d = cohort(int(case[-1]), equal_lens=case.startswith("ties"))
    avg = f32_avg(d)
    got, ref = port_v2(d, avg, torch.float32), ref_v2(d, avg)
    assert_rows_equal(got, ref, K + 2)
    ok = got[:, 2 * K + 1]
    if case == "mass_ties":
        assert ok[0] == 0           # not certified on either side
    else:
        assert ok.all()
    if case == "wide":      # rows whose certificate had a finite bound
        assert (got[:, 2 * K] > tfp.CAND_V2).any()


@pytest.mark.parametrize("shape", ["random", "duplicate"])
def test_v2_f64_rail_certified_rows_match_v1(shape):
    """At float64 each certified v2 row holds the v1 lane's hits, in
    (reported score desc, docid asc) order."""
    d = cohort(7, shape=shape)
    avg = float(d["lens"].astype(np.float64).mean())
    v2 = port_v2(d, avg, torch.float64)
    v1 = port_v1(cohort(7, slotted=False, shape=shape), avg, torch.float64)
    for qi in range(Q):
        assert v2[qi, 2 * K + 1] == 1
        assert v2[qi, 2 * K] == v1[qi, 2 * K]
        vals, ids = v1[qi, :K], v1[qi, K:2 * K]
        order = np.lexsort((ids, -vals))
        np.testing.assert_array_equal(v2[qi, K:2 * K], ids[order])
        np.testing.assert_array_equal(v2[qi, :K], vals[order])


@pytest.mark.parametrize("seed,k,p", [(0, 5, 40), (1, 16, 16), (2, 7, 200)])
def test_stable_topk_bound_slot_matches_reference(seed, k, p):
    rng = np.random.default_rng(seed)
    cand = rng.integers(0, 6, (3, p)).astype(np.float32)
    cand[cand == 0] = -np.inf
    keys = np.sort(rng.choice(10 * p, (3, p)), axis=1).astype(np.int32)
    vals, ids, bound = stable_topk(torch.from_numpy(cand),
                                   torch.from_numpy(keys), k,
                                   bound_slot=True)
    for r in range(3):
        if k + 1 > p:       # the port pads a short row; the bound is -inf
            assert np.isneginf(bound[r].item())
            continue
        rv, ri, rb = jfp._stable_topk(jnp.asarray(cand[r]),
                                      jnp.asarray(keys[r]), k,
                                      bound_slot=True)
        np.testing.assert_array_equal(vals[r].numpy(), np.asarray(rv))
        np.testing.assert_array_equal(ids[r].numpy(), np.asarray(ri))
        assert bound[r].item() == float(rb)


MAPPINGS = {"properties": {"body": {"type": "text"}}}


@pytest.fixture(scope="module")
def segments():
    """A reference segment and the port's copy of it
    (``segment_from_numpy``)."""
    rng = np.random.default_rng(3)
    vocab = [f"w{i}" for i in range(40)]
    jm = MapperService(mappings=MAPPINGS)
    jw = JaxWriter()
    for i in range(700):
        jw.add(jm.parse(str(i), {"body": " ".join(
            rng.choice(vocab, int(rng.integers(1, 12))))}))
    jseg = jw.build("_f")
    jf = jseg.postings["body"]
    arrays = {a: np.asarray(getattr(jf, a)) for a in (
        "doc_freq", "total_term_freq", "term_block_start",
        "term_block_count", "block_docids", "block_tfs", "field_lengths")}
    arrays.update(terms=list(jf.terms), ids=list(jseg.stored.ids))
    return jseg, segment_from_numpy(arrays, name="_f", field="body")


@pytest.mark.parametrize("conv", [
    [("body", ("w1",), False)],
    [("body", ("w1",), False), ("body", ("w2",), False)],
    [("body", ("w3", "w4"), False), ("body", ("w0",), True)],
    [("body", ("nosuch",), False)],
    [("body", ("w5",), False), ("body", ("w6",), False),
     ("body", ("w7",), False), ("body", ("w8",), False)]])
def test_composed_filter_mask_matches_reference(segments, conv):
    jseg, seg = segments
    jdev, dev = JaxDeviceSegment(jseg), DeviceSegment(seg, "cpu")
    jmask, jhost = jdev.composed_filter_mask(conv)
    mask, host = dev.composed_filter_mask(conv)
    np.testing.assert_array_equal(host, jhost)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    # a second ask is a cache hit, the same objects
    assert dev.composed_filter_mask(list(reversed(conv)))[0] is mask
    assert dev.filter_mask_hits >= 1


def test_filter_mask_cache_is_bounded(segments):
    _, seg = segments
    dev = DeviceSegment(seg, "cpu")
    for i in range(40):
        dev.composed_filter_mask([("body", (f"w{i}",), False)])
    # each ask caches the term's mask and the composed one
    assert len(dev._filter_masks) == 64
    assert dev.filter_mask_evictions == 80 - 64


@pytest.fixture
def server(segments):
    _, seg = segments
    fp = srv.FastPathServer("cpu", DeviceSegmentCache("cpu"))
    return fp, fp.register("idx", seg, "body", K1, B)


def test_resolve_mask_rows_keeps_the_cohorts_rows(server):
    fp, reg = server
    pf = reg["dp"].host
    tid = [pf.term_id(f"w{i}") for i in range(40)]
    live = reg["dev"].live
    # fill every filter row, then resolve a cohort that reuses two sets
    # and brings new ones: no row it resolved is taken by another set
    first = fp._resolve_mask_rows(reg, {(t,) for t in tid[:srv.F_SLOTS - 1]})
    assert sorted(first.values()) == list(range(1, srv.F_SLOTS))
    keep = {(tid[0],), (tid[1],)}
    filts = keep | {(t,) for t in tid[31:38]} | {(tid[2], -1)}
    rows = fp._resolve_mask_rows(reg, filts)
    assert rows[(tid[2], -1)] is None       # unknown term: no hits
    got = [r for r in rows.values() if r is not None]
    assert len(set(got)) == len(got) == len(filts) - 1
    assert all(rows[f] == first[f] for f in keep)
    for f, r in rows.items():
        if r is None:
            continue
        col = live & reg["dev"].composed_filter_mask(
            [("body", (pf.terms[f[0]],), False)])[0]
        assert torch.equal(reg["masks"][r], col)
        assert reg["stack_map"][f] == r
    assert torch.equal(reg["masks"][0], live)


def test_chunk_by_slots_limits(server):
    fp, reg = server
    items = [srv._Pending(reg, [0], ((i % 40),) if i % 3 else (), 10,
                          "v2m", 1024) for i in range(100)]
    chunks = list(fp._chunk_by_slots(items))
    assert sum(len(c) for c in chunks) == 100
    for c in chunks:
        assert len(c) <= srv.Q_BATCH
        assert len({p.filt for p in c if p.filt}) <= srv.F_SLOTS - 1
    many = [srv._Pending(reg, [0], (i,), 10, "v2m", 1024)
            for i in range(40)]
    assert [len(c) for c in fp._chunk_by_slots(many)] == [31, 9]


def _routing_reg():
    nb = np.zeros(60, np.int64)
    nb[:4] = 10                     # four small terms: bucket 1024
    nb[4] = 300                     # five slots of 64: still 1024
    nb[5:21] = 300                  # 16 x 300: no slot layout fits
    nb[21] = 5000                   # beyond the largest bucket
    nb[22:39] = 1                   # 17 terms: more than MAX_TERMS
    return {"nb": nb}


@pytest.mark.parametrize("term_ids, want", [
    ([0, 1, 2, 3], ("v2m", 1024)),
    ([4, -1], ("v2m", 1024)),
    # 5 x 300 blocks: the slot layout fits 2048
    (list(range(5, 10)), ("v2m", 2048)),
    # a misfit (13 x 300 blocks) rides v1 at the largest bucket
    (list(range(5, 18)), ("v1", 4096)),
    (list(range(5, 21)), None),     # 4800 blocks
    ([21], None),
    (list(range(22, 39)), None),
    ([-1, -1], ("empty", None)),
])
def test_routing(term_ids, want):
    fp = srv.FastPathServer("cpu", DeviceSegmentCache("cpu"))
    reg = _routing_reg()
    assert fp.route(reg, term_ids) == want
    assert fp.fits(reg, term_ids, 1000) == (want is not None)


def test_fits_bounds_size():
    fp = srv.FastPathServer("cpu", DeviceSegmentCache("cpu"))
    reg = _routing_reg()
    assert fp.fits(reg, [0], 1000) and not fp.fits(reg, [0], 1001)
    assert not fp.fits(reg, [21], 10)


def test_merge_up_folds_small_groups():
    g = {1024: list(range(3)), 2048: list(range(20)), 4096: list(range(2))}
    m = srv.FastPathServer._merge_up(g)
    assert {b: len(v) for b, v in m.items()} == {2048: 23, 4096: 2}
    assert srv.FastPathServer._merge_up({1024: [1]}) == {1024: [1]}
