"""The host half of the fast path as array ops
(elasticsearch_tpu_torch/search/fastpath.py): ``route_rows`` / ``route`` /
``_v2_bucket``, ``assemble_cohort`` (slotted for v2m, back to back for v1)
and ``assemble_essential``, each bit-equal on seeded cohorts to a copy of
the per-term loops they replaced, which stays here as the oracle. The
cohorts hold unknown terms (-1), empty rows, doubled terms, 16-term
queries, slot misfits and queries beyond the largest bucket."""

from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import pytest

from elasticsearch_tpu_torch.search import fastpath as srv
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache

N_TERMS = 400
ZERO_BLOCK = 99_999


# ------------------------------------------------- the loops, as they were
def loop_v2_bucket(reg, term_ids) -> Optional[int]:
    nbs = reg["nb"]
    cnts = [int(nbs[t]) for t in term_ids if t >= 0]
    if not cnts or len(cnts) > srv.N_SLOTS:
        return None
    for bucket in srv.NB_BUCKETS:
        slot = bucket // srv.N_SLOTS
        if slot == 0:
            continue
        if sum(-(-c // slot) for c in cnts) <= srv.N_SLOTS:
            return bucket
    return None


def loop_route(reg, term_ids: List[int]):
    known = [t for t in term_ids if t >= 0]
    if not known:
        return ("empty", None)
    if len(known) > srv.MAX_TERMS:
        return None
    need = int(reg["nb"][known].sum())
    if need > srv.NB_BUCKETS[-1]:
        return None
    b2 = loop_v2_bucket(reg, known)
    if b2 is not None:
        return ("v2m", b2)
    return ("v1", srv.NB_BUCKETS[-1])


def loop_assemble_cohort(reg, bucket, queries, slotted=True):
    dp = reg["dp"]
    slot = bucket // srv.N_SLOTS
    sel = np.full((srv.Q_BATCH, bucket), dp.zero_block, np.int32)
    ws = np.zeros((srv.Q_BATCH, bucket), np.float64)
    starts, nbs, idf = reg["starts"], reg["nb"], reg["idf"]
    for qi, term_ids in enumerate(queries):
        pos = 0
        for t in term_ids:
            if t < 0:
                continue
            cnt = int(nbs[t])
            s = int(starts[t])
            sel[qi, pos:pos + cnt] = np.arange(s, s + cnt, dtype=np.int32)
            ws[qi, pos:pos + cnt] = idf[t]
            pos += -(-cnt // slot) * slot if slotted else cnt
    return sel, ws


def loop_assemble_essential(reg, bucket, splits):
    sel, ws = loop_assemble_cohort(reg, bucket, [s[1] for s in splits],
                                   slotted=False)
    ne_row = np.full((srv.Q_BATCH, srv.NE_SLOTS), -1, np.int32)
    ne_idf = np.zeros((srv.Q_BATCH, srv.NE_SLOTS), np.float64)
    ne_bound = np.zeros(srv.Q_BATCH, np.float64)
    rows = reg["dense_rows"]
    for qi, (_b, _ess, ne, bound, _theta, _total) in enumerate(splits):
        for i, t in enumerate(ne):
            ne_row[qi, i] = rows[t]
            ne_idf[qi, i] = reg["idf"][t]
        ne_bound[qi] = bound
    return sel, ws, ne_row, ne_idf, ne_bound


# ------------------------------------------------------------- the inputs
def registration(seed):
    """A registration's host vectors: block counts from 0 to 700 (a few
    large enough that 16 of them misfit every slot layout), contiguous
    block ranges, float64 idf, and hot-term rows for every fifth term."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, 60, N_TERMS)
    nb[rng.choice(N_TERMS, 40, replace=False)] = rng.integers(200, 700, 40)
    starts = np.r_[0, np.cumsum(nb)[:-1]].astype(np.int64)
    dense_rows = {int(t): r for r, t in enumerate(range(0, N_TERMS, 5))}
    return {"dp": SimpleNamespace(zero_block=ZERO_BLOCK),
            "nb": nb.astype(np.int64), "starts": starts,
            "idf": rng.random(N_TERMS) * 8.0,
            "dense_rows": dense_rows,
            "dense_row_of": srv._row_of(dense_rows, N_TERMS)}


def cohort(seed, n=srv.Q_BATCH):
    """``n`` queries of 0 to 16 term instances (unknown terms, doubled
    terms), some of exactly 16 known terms, some of 17 and more."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 8
        if kind == 0:
            q = []                                        # empty row
        elif kind == 1:
            q = rng.integers(0, N_TERMS, 16).tolist()     # 16 terms
        elif kind == 2:
            q = [-1, -1]                                  # all unknown
        elif kind == 3:
            t = int(rng.integers(0, N_TERMS))
            q = [t, -1, t]                                # doubled term
        elif kind == 4:
            q = rng.integers(0, N_TERMS, 18).tolist()     # > MAX_TERMS
        else:
            m = int(rng.integers(1, 9))
            q = rng.integers(0, N_TERMS, m).tolist()
            q[int(rng.integers(0, m))] = -1               # an unknown one
        out.append(q)
    return out


def server():
    return srv.FastPathServer("cpu", DeviceSegmentCache("cpu"))


def same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("seed", range(6))
def test_route_rows_equal_the_loop(seed):
    reg = registration(seed)
    fp = server()
    queries = cohort(100 + seed, n=200)
    lanes, buckets = fp.route_rows(reg, srv._term_rows(queries))
    seen = set()
    for q, lane, bucket in zip(queries, lanes.tolist(), buckets.tolist()):
        want = loop_route(reg, q)
        assert fp.route(reg, q) == want
        assert fp._v2_bucket(reg, q) == loop_v2_bucket(reg, q)
        if want is None:
            assert (lane, bucket) == (srv.LANE_NONE, 0)
        elif want[0] == "empty":
            assert (lane, bucket) == (srv.LANE_EMPTY, 0)
        else:
            assert (srv._LANES[lane], bucket) == want
        seen.add(None if want is None else want[0])
    # the cohorts reach every lane
    assert seen == {None, "empty", "v2m", "v1"}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("slotted", [True, False], ids=["v2m", "v1"])
def test_assemble_cohort_equals_the_loop(seed, slotted):
    reg = registration(seed)
    fp = server()
    queries = cohort(200 + seed, n=400)
    routes = [loop_route(reg, q) for q in queries]
    # a lane's cohorts: v2m at each query's own bucket, v1 (back to back)
    # at the largest bucket for every query a fast lane serves
    groups = {}
    for q, r in zip(queries, routes):
        if r is None or r[0] == "empty":
            continue
        if slotted and r[0] == "v2m":
            groups.setdefault(r[1], []).append(q)
        elif not slotted:
            groups.setdefault(srv.NB_BUCKETS[-1], []).append(q)
    # empty and all-unknown rows ride along as padding rows would
    groups.setdefault(srv.NB_BUCKETS[0], []).extend([[], [-1, -1]])
    assert len(groups) >= (3 if slotted else 1)
    for bucket, qs in groups.items():
        for lo in range(0, len(qs), srv.Q_BATCH):
            chunk = qs[lo:lo + srv.Q_BATCH]
            want = loop_assemble_cohort(reg, bucket, chunk, slotted)
            same(fp.assemble_cohort(reg, bucket, chunk, slotted), want)
            # the same cohort as rows padded with -1
            same(fp.assemble_cohort(reg, bucket, srv._term_rows(chunk),
                                    slotted), want)


@pytest.mark.parametrize("seed", range(4))
def test_assemble_essential_equals_the_loop(seed):
    reg = registration(seed)
    fp = server()
    rng = np.random.default_rng(300 + seed)
    hot = sorted(reg["dense_rows"])
    for bucket in srv.ESS_BUCKETS:
        splits = []
        for i in range(srv.Q_BATCH - seed):
            n_ne = 1 + i % srv.NE_SLOTS
            ne = [int(t) for t in rng.choice(hot, n_ne)]
            ess = []
            while sum(int(reg["nb"][t]) for t in ess) < bucket // 4:
                ess.append(int(rng.integers(0, N_TERMS)))
            if sum(int(reg["nb"][t]) for t in ess) > bucket:
                ess = ess[:1]
            if reg["nb"][ess].sum() > bucket:
                continue
            splits.append((bucket, ess, ne, float(rng.random()), 1.0, 10))
        assert splits
        same(fp.assemble_essential(reg, bucket, splits),
             loop_assemble_essential(reg, bucket, splits))
