"""Device accounting of the port against the reference, on the same
documents, both on the CPU: the HBM slab classes of a DeviceSegment
(``hbm_bytes_by_class``), the node cache's rollup and peak, the
filter-mask LRU and its byte accounting, the bound-plan counters, the
``hbm`` breaker's admission (LRU eviction before a trip, recency, the
trip and its release, filter-mask admission, wiring after warm-up), the
429 ``circuit_breaking_exception`` over REST, ``GET /_nodes/stats``'s
engine section and the shape discipline of ``GET /_kernels``. The single-
node cases of tests/test_engine_stats.py and the HBM cases of
tests/test_backpressure.py; the cluster, tracer and metrics-registry
cases wait for the port's telemetry.

Where the two keep the same arrays the byte counts are equal. They
differ where the port keeps other arrays, and the tests pin how:
- ``postings``: the reference keeps its block-max metadata on the device
  (two float32 [TB + 1] columns a field), the port on the host;
- ``live_mask``: the port keeps two more bool columns beside the live
  mask (the real docs [ND], and the all-true [1, ND] row the dense
  scorer hands the contribution kernel);
- ``ordinals``: both count a built ord-major permutation, but only the
  port charges it to the breaker (a fact of the reference: its breaker
  falls behind its own ``hbm_stats`` once an aggs body built one).
"""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

import elasticsearch_tpu.ops.device as jax_device_mod
import elasticsearch_tpu_torch.ops.device as device_mod
from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu.index.segment import SegmentWriter as JaxWriter
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.ops.device import DeviceSegment as JaxDeviceSegment
from elasticsearch_tpu.search.context import \
    DeviceSegmentCache as JaxDeviceSegmentCache
from elasticsearch_tpu.search.queries import parse_query as jax_parse
from elasticsearch_tpu.search.searcher import ShardSearcher as JaxSearcher
from elasticsearch_tpu.utils.breaker import \
    HierarchyCircuitBreakerService as JaxBreakers
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops.device import (HBM_SLAB_CLASSES,
                                                DevicePostings,
                                                DeviceSegment, DeviceVectors)
from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
from elasticsearch_tpu_torch.search.plan import BoundPlan
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.search.searcher import ShardSearcher
from elasticsearch_tpu_torch.telemetry.engine import TRACKER
from elasticsearch_tpu_torch.utils.breaker import (
    CircuitBreaker, HierarchyCircuitBreakerService, build_breaker_service)

MAPPINGS = {"properties": {
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "n": {"type": "long"},
    "v": {"type": "dense_vector", "dims": 8, "similarity": "cosine"}}}
WORDS = ["alpha", "beta", "gamma", "delta", "fox", "dog", "wolf",
         "lake", "hill", "tree"]


def make_docs(n_docs, seed):
    rng = np.random.default_rng(seed)
    return [{"body": " ".join(rng.choice(WORDS, 6)),
             "tag": str(rng.choice(["red", "green", "blue"])),
             "n": int(i),
             "v": rng.standard_normal(8).round(4).tolist()}
            for i in range(n_docs)]


def build_both(n_docs=60, name="seg0", seed=3):
    """(reference segment, port segment) of the same documents."""
    jm, pm = MapperService(mappings=MAPPINGS), DocumentMapper(MAPPINGS)
    jw, pw = JaxWriter(), SegmentWriter()
    for i, d in enumerate(make_docs(n_docs, seed)):
        jw.add(jm.parse(str(i), d))
        pw.add(pm.parse(str(i), d))
    return jw.build(name), pw.build(name)


def port_dev(seg):
    return DeviceSegment(seg, "cpu", vector_dtype=torch.bfloat16)


def pinned(jdev, pdev):
    """The reference's classes moved to what the port keeps (module
    docstring)."""
    want = dict(jdev.hbm_bytes_by_class())
    for dp in pdev.postings.values():
        want["postings"] -= 2 * 4 * (dp.zero_block + 1)
    want["live_mask"] *= 3
    return want


# ---------------------------------------------------------------------------
# slab classes
# ---------------------------------------------------------------------------

def test_hbm_by_class_sums_to_total_and_matches_the_reference():
    jseg, pseg = build_both()
    jdev, pdev = JaxDeviceSegment(jseg), port_dev(pseg)
    by_class = pdev.hbm_bytes_by_class()
    assert HBM_SLAB_CLASSES == jax_device_mod.HBM_SLAB_CLASSES
    assert set(by_class) == set(HBM_SLAB_CLASSES)
    assert pdev.hbm_bytes() == sum(by_class.values())
    assert by_class["postings"] > 0 and by_class["norms"] > 0
    assert by_class["vectors"] > 0 and by_class["doc_values"] > 0
    assert by_class["live_mask"] == 3 * pdev.n_docs_padded
    assert by_class == pinned(jdev, pdev)


def _tensors_held(obj, seen=None, out=None):
    """Every torch tensor reachable from a DeviceSegment through its own
    containers (not through the host Segment, functions or numpy)."""
    seen = set() if seen is None else seen
    out = {} if out is None else out
    if id(obj) in seen:
        return out
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        out[obj.data_ptr()] = int(obj.nbytes)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors_held(v, seen, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors_held(v, seen, out)
    elif isinstance(obj, (DeviceSegment, DevicePostings, DeviceVectors,
                          BoundPlan)):
        for k, v in vars(obj).items():
            if k not in ("segment", "host", "hbm_sink"):
                _tensors_held(v, seen, out)
    return out


def test_the_classes_cover_every_tensor_the_segment_holds():
    """A walk of the segment finds exactly the bytes the classes count,
    after every lazy build: masks (composed too), an ord-major
    permutation, a device table derived from the postings, a cached
    bound plan with a dense factor."""
    _, pseg = build_both(90, "walk0", seed=5)
    cache = DeviceSegmentCache("cpu")
    dev = cache.get(pseg)
    searcher = ShardSearcher([pseg], DocumentMapper(MAPPINGS), cache)
    dev.filter_mask("body", ("fox",))
    dev.composed_filter_mask([("body", ("dog",), False),
                              ("tag", ("red",), True)])
    dev.keyword_ord_major("tag")
    dev.postings["body"].derived(
        "test.table", lambda: (torch.ones(3, 40), {"rows": 3}))
    q = parse_query({"bool": {"must": [{"match": {"body": "fox"}}],
                              "filter": [{"range": {"n": {"gte": 10}}}]}})
    searcher.query_phase(q, 5, cache_key="walk")
    assert len(dev._bound_plans) == 1
    held = _tensors_held(dev)
    assert sum(held.values()) == dev.hbm_bytes()
    by_class = dev.hbm_bytes_by_class()
    assert by_class["ordinals"] > 0 and by_class["filter_masks"] > 0
    assert cache.breaker is None
    assert cache.hbm_stats()["total_bytes"] == dev.hbm_bytes()


def test_cache_rollup_equals_sum_over_live_segments():
    """The acceptance invariant (reference :59) on both packages."""
    for pkg in ("jax", "torch"):
        cache = (JaxDeviceSegmentCache() if pkg == "jax"
                 else DeviceSegmentCache("cpu"))
        segs = [build_both(40, f"hbm{i}", seed=i)[0 if pkg == "jax" else 1]
                for i in range(3)]
        devs = [cache.get(s) for s in segs]
        stats = cache.hbm_stats()
        assert stats["segments"] == 3
        assert stats["total_bytes"] == sum(d.hbm_bytes() for d in devs)
        assert stats["peak_bytes"] >= stats["total_bytes"]
        cache.evict([segs[0].name])
        stats2 = cache.hbm_stats()
        assert stats2["total_bytes"] == sum(d.hbm_bytes() for d in devs[1:])
        assert stats2["total_bytes"] < stats["total_bytes"]
        assert stats2["peak_bytes"] >= stats["total_bytes"]


def test_evict_except_releases_what_it_drops_as_the_reference():
    seen = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            svc = JaxBreakers(total_limit_bytes=1 << 30,
                              hbm_limit_bytes=1 << 30)
            cache = JaxDeviceSegmentCache()
        else:
            svc = HierarchyCircuitBreakerService(total_limit_bytes=1 << 30,
                                                 hbm_limit_bytes=1 << 30)
            cache = DeviceSegmentCache("cpu")
        br = svc.get_breaker(CircuitBreaker.HBM)
        cache.set_breaker(br)
        segs = [build_both(30, f"keep{i}", seed=30 + i)[pkg == "torch"]
                for i in range(3)]
        devs = [cache.get(s) for s in segs]
        cache.evict_except({"keep1"})
        seen.append(list(cache._cache))
        assert br.used == devs[1].hbm_bytes()
    assert seen[1] == seen[0] == ["keep1"]


def test_filter_mask_bytes_show_up_in_accounting():
    jseg, pseg = build_both()
    for dev in (JaxDeviceSegment(jseg), port_dev(pseg)):
        before = dev.hbm_bytes_by_class()["filter_masks"]
        dev.filter_mask("body", ("fox",))
        after = dev.hbm_bytes_by_class()["filter_masks"]
        assert before == 0 and after == dev.n_docs_padded


def test_filter_mask_lru_eviction_counts_as_the_reference(monkeypatch):
    jseg, pseg = build_both()
    jdev, pdev = JaxDeviceSegment(jseg), port_dev(pseg)
    for mod in (jax_device_mod, device_mod):
        monkeypatch.setattr(mod, "FILTER_MASK_CACHE_MAX", 4)
    seen = []
    for dev in (jdev, pdev):
        for word in WORDS[:6]:
            dev.filter_mask("body", (word,))
        at_cap = dev.cache_stats()["filter_mask"]
        seen.append(at_cap)
    assert seen[1] == seen[0]
    assert seen[1]["misses"] == 6 and seen[1]["evictions"] == 2 \
        and seen[1]["entries"] == 4
    for mod in (jax_device_mod, device_mod):
        monkeypatch.setattr(mod, "FILTER_MASK_CACHE_MAX", 2)
    seen = []
    for dev in (jdev, pdev):
        dev.filter_mask("body", ("lake", "hill"))
        m1 = dev.filter_mask("body", (WORDS[0],))
        m2 = dev.filter_mask("body", (WORDS[0],))
        assert m1[0] is m2[0]
        seen.append(dev.cache_stats()["filter_mask"])
    assert seen[1] == seen[0]
    assert seen[1]["entries"] == 2 and seen[1]["evictions"] == 6


def test_bound_plan_counters_as_the_reference():
    jseg, pseg = build_both(80, "cmp0", seed=11)
    jm, pm = MapperService(mappings=MAPPINGS), DocumentMapper(MAPPINGS)
    js = JaxSearcher([jseg], jm, JaxDeviceSegmentCache())
    ps = ShardSearcher([pseg], pm, DeviceSegmentCache("cpu"))
    out = []
    for searcher, parse in ((js, jax_parse), (ps, parse_query)):
        q = parse({"match": {"body": "dog"}})
        searcher.query_phase(q, 10, cache_key="ck1")
        searcher.query_phase(q, 10, cache_key="ck1")
        out.append(searcher.cache.cache_stats()["bound_plan"])
    assert out[1] == out[0]
    assert out[1]["misses"] == 1 and out[1]["hits"] == 1 \
        and out[1]["entries"] == 1


# ---------------------------------------------------------------------------
# the hbm breaker: admission, eviction, trips (test_backpressure.py)
# ---------------------------------------------------------------------------

def _hbm_caches(limit_of):
    """(reference cache, its breaker), (port cache, its breaker), each
    with the hbm limit ``limit_of(one segment's bytes in that
    package)``."""
    out = []
    for pkg in ("jax", "torch"):
        one = _one[pkg]
        if pkg == "jax":
            svc = JaxBreakers(total_limit_bytes=1 << 30,
                              hbm_limit_bytes=limit_of(one))
            cache = JaxDeviceSegmentCache()
        else:
            svc = HierarchyCircuitBreakerService(
                total_limit_bytes=1 << 30, hbm_limit_bytes=limit_of(one))
            cache = DeviceSegmentCache("cpu")
        br = svc.get_breaker(CircuitBreaker.HBM)
        cache.set_breaker(br)
        out.append((cache, br))
    return out


_one = {}


def _segs(n, prefix, seed0, n_docs=40):
    pairs = [build_both(n_docs, f"{prefix}{i}", seed=seed0 + i)
             for i in range(n)]
    _one["jax"] = JaxDeviceSegment(pairs[0][0]).hbm_bytes()
    _one["torch"] = port_dev(pairs[0][1]).hbm_bytes()
    return [p[0] for p in pairs], [p[1] for p in pairs]


def test_hbm_admission_evicts_lru_before_tripping():
    jsegs, psegs = _segs(3, "bp", 0)
    seen = []
    for (cache, br), segs in zip(_hbm_caches(lambda one: int(one * 2.5)),
                                 (jsegs, psegs)):
        cache.get(segs[0])
        cache.get(segs[1])
        assert br.used > 0
        cache.get(segs[2])
        seen.append((cache.hbm_breaker_evictions, br.trip_count,
                     cache.hbm_stats()["segments"], list(cache._cache),
                     br.used == cache.hbm_stats()["total_bytes"]))
    assert seen[1] == seen[0] == (1, 0, 2, ["bp1", "bp2"], True)


def test_hbm_admission_respects_recency():
    jsegs, psegs = _segs(3, "lru", 10)
    seen = []
    for (cache, _br), segs in zip(_hbm_caches(lambda one: int(one * 2.5)),
                                  (jsegs, psegs)):
        cache.get(segs[0])
        cache.get(segs[1])
        cache.get(segs[0])          # touch: segs[1] is now least-recent
        cache.get(segs[2])
        seen.append(list(cache._cache))
    assert seen[1] == seen[0] == ["lru0", "lru2"]


def test_hbm_trips_only_when_eviction_cannot_free_enough():
    jsegs, psegs = _segs(1, "big", 42, n_docs=60)
    seen = []
    for (cache, br), segs in zip(_hbm_caches(lambda one: one // 2),
                                 (jsegs, psegs)):
        with pytest.raises(Exception) as e:
            cache.get(segs[0])
        assert type(e.value).__name__ == "CircuitBreakingException"
        seen.append((br.trip_count, br.used,
                     cache.hbm_stats()["segments"],
                     e.value.bytes_wanted == dev_bytes(segs[0])))
    assert seen[1] == seen[0] == (1, 0, 0, True)


def dev_bytes(seg):
    if type(seg).__module__.startswith("elasticsearch_tpu_torch"):
        return port_dev(seg).hbm_bytes()
    return JaxDeviceSegment(seg).hbm_bytes()


def test_hbm_filter_mask_admission_accounted_and_released():
    jsegs, psegs = _segs(1, "fm", 7)
    for (cache, br), segs in zip(_hbm_caches(lambda one: one + 8192),
                                 (jsegs, psegs)):
        dev = cache.get(segs[0])
        base = br.used
        dev.filter_mask("body", ("fox",))
        assert br.used == base + dev.n_docs_padded
        cache.evict([segs[0].name])
        assert br.used == 0


def test_hbm_filter_mask_trips_when_no_headroom():
    jsegs, psegs = _segs(1, "fm1", 8)
    for (cache, br), segs in zip(_hbm_caches(lambda one: one + 10),
                                 (jsegs, psegs)):
        dev = cache.get(segs[0])
        with pytest.raises(Exception) as e:
            dev.filter_mask("body", ("fox",))
        assert type(e.value).__name__ == "CircuitBreakingException"
        assert dev.cache_stats()["filter_mask"]["entries"] == 0
        cache.evict([segs[0].name])
        assert br.used == 0


def test_set_breaker_after_warmup_charges_residents_fully():
    jseg, pseg = build_both(40, "warm0", seed=9)
    for cache, seg, svc in (
            (JaxDeviceSegmentCache(), jseg,
             JaxBreakers(total_limit_bytes=1 << 30,
                         hbm_limit_bytes=1 << 30)),
            (DeviceSegmentCache("cpu"), pseg,
             HierarchyCircuitBreakerService(total_limit_bytes=1 << 30,
                                            hbm_limit_bytes=1 << 30))):
        dev = cache.get(seg)
        dev.filter_mask("body", ("fox",))
        br = svc.get_breaker(CircuitBreaker.HBM)
        cache.set_breaker(br)
        assert br.used == dev.hbm_bytes()
        dev.filter_mask("body", ("dog",))
        assert br.used == dev.hbm_bytes()
        cache.evict([seg.name])
        assert br.used == 0


def test_ord_major_is_charged_by_the_port_only():
    """The pinned difference: after an ord-major permutation is built,
    the port's breaker holds its bytes, the reference's does not."""
    jseg, pseg = build_both(60, "ord0", seed=4)
    used = {}
    for pkg, cache, seg, svc in (
            ("jax", JaxDeviceSegmentCache(), jseg,
             JaxBreakers(total_limit_bytes=1 << 30,
                         hbm_limit_bytes=1 << 30)),
            ("torch", DeviceSegmentCache("cpu"), pseg,
             HierarchyCircuitBreakerService(total_limit_bytes=1 << 30,
                                            hbm_limit_bytes=1 << 30))):
        br = svc.get_breaker(CircuitBreaker.HBM)
        cache.set_breaker(br)
        dev = cache.get(seg)
        dev.keyword_ord_major("tag")
        total = cache.hbm_stats()["total_bytes"]
        ordinals = cache.hbm_stats()["by_class"]["ordinals"]
        assert ordinals == 4 * len(seg.keywords["tag"].all_ords)
        used[pkg] = (br.used, total, ordinals)
    j_used, j_total, j_ord = used["jax"]
    p_used, p_total, p_ord = used["torch"]
    assert p_ord == j_ord
    assert p_used == p_total
    assert j_used == j_total - j_ord


def test_a_new_segment_under_a_known_name_releases_the_old_charge():
    _, pa = build_both(40, "same", seed=1)
    _, pb = build_both(50, "same", seed=2)
    svc = HierarchyCircuitBreakerService(total_limit_bytes=1 << 30,
                                         hbm_limit_bytes=1 << 30)
    br = svc.get_breaker(CircuitBreaker.HBM)
    cache = DeviceSegmentCache("cpu", breaker=br)
    a = cache.get(pa)
    a.filter_mask("body", ("fox",))
    b = cache.get(pb)
    assert b is not a and b.segment is pb
    assert br.used == b.hbm_bytes() == cache.hbm_stats()["total_bytes"]
    # the replaced segment is no longer accounted
    a.filter_mask("body", ("dog",))
    assert br.used == b.hbm_bytes()


def test_evicted_segments_reach_the_listeners():
    jsegs, psegs = _segs(3, "lis", 20)
    (_, _), (cache, _br) = _hbm_caches(lambda one: int(one * 2.5))
    heard = []
    cache.add_evict_listener(heard.append)
    for s in psegs:
        cache.get(s)
    assert cache.wait_evictions_heard(timeout=60)
    assert heard == [["lis0"]]
    cache.evict(["lis1"])               # a retirement is not an eviction
    assert cache.wait_evictions_heard(timeout=60)
    assert heard == [["lis0"]]


def test_concurrent_mask_builds_and_stats_reads_do_not_deadlock():
    """Mask builds take the segment's lock, then the cache's; the stats
    read the segments outside the cache's lock. A hammer of both, with
    a short switch interval, ends and balances."""
    _, pseg = build_both(200, "ham0", seed=6)
    svc = HierarchyCircuitBreakerService(total_limit_bytes=1 << 30,
                                         hbm_limit_bytes=1 << 30)
    br = svc.get_breaker(CircuitBreaker.HBM)
    cache = DeviceSegmentCache("cpu", breaker=br)
    dev = cache.get(pseg)
    errors = []

    def build(i):
        try:
            for j in range(60):
                w = WORDS[(i + j) % len(WORDS)]
                dev.filter_mask("body", (w, WORDS[j % 3]))
                dev.composed_filter_mask([("body", (w,), bool(j % 2))])
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(e)

    def read():
        try:
            for _ in range(200):
                cache.hbm_stats()
                cache.cache_stats()
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=build, args=(i,))
                   for i in range(6)]
        threads += [threading.Thread(target=read) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "deadlock"
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert br.used == dev.hbm_bytes() == cache.hbm_stats()["total_bytes"]


def test_registrations_and_derived_builds_under_evictions_do_not_deadlock():
    """The fast path registers under its locks and builds postings
    tables there (``dp.derived``); the plan path builds tables and masks
    under the segment's locks; each charge may evict, and the fast
    path's eviction listener takes its locks. A hammer of all of them on
    the same segments, under a limit that evicts, ends; afterwards no
    registration holds a segment the cache evicted."""
    from elasticsearch_tpu_torch.common.errors import \
        CircuitBreakingException
    from elasticsearch_tpu_torch.search.fastpath import FastPathServer
    psegs = [build_both(80, f"reg{i}", seed=20 + i)[1] for i in range(4)]
    one = port_dev(psegs[0]).hbm_bytes()
    svc = HierarchyCircuitBreakerService(total_limit_bytes=1 << 30,
                                         hbm_limit_bytes=int(2.5 * one))
    br = svc.get_breaker(CircuitBreaker.HBM)
    cache = DeviceSegmentCache("cpu", breaker=br)
    fp = FastPathServer("cpu", cache)
    errors = []

    def guarded(fn):
        def run(i):
            try:
                for j in range(40):
                    try:
                        fn(i, j)
                    except CircuitBreakingException:
                        pass        # a refused charge is an answer
            except Exception as e:      # noqa: BLE001 — reported below
                errors.append(e)
        return run

    @guarded
    def register(i, j):
        seg = psegs[(i + j) % 4]
        fp.register(seg.name, seg, "body", 1.2, 0.75)

    @guarded
    def plan_builds(i, j):
        dev = cache.get(psegs[(i * 3 + j) % 4])
        dp = dev.postings["body"]
        dp.block_bounds()
        dp.derived(("table", i, j), lambda: torch.zeros(64 + j))
        dev.filter_mask("body", (WORDS[(i + j) % len(WORDS)],))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        # daemons: a deadlocked hammer fails here, not at exit
        threads = [threading.Thread(target=register, args=(i,),
                                    daemon=True) for i in range(3)]
        threads += [threading.Thread(target=plan_builds, args=(i,),
                                     daemon=True) for i in range(3)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        assert not any(t.is_alive() for t in threads), "deadlock"
        assert cache.wait_evictions_heard(timeout=10), "deadlock"
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert cache.hbm_breaker_evictions > 0
    for name, reg in fp._regs.items():
        assert cache.resident(name) is reg["dev"], name
    assert br.used == cache.hbm_stats()["total_bytes"]


# ---------------------------------------------------------------------------
# REST: breaker settings, the 429, _nodes/stats, _kernels
# ---------------------------------------------------------------------------

def _bulk(docs):
    return "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                   + json.dumps(d) + "\n" for i, d in enumerate(docs))


def _seed(c, index, docs):
    st, _ = c.dispatch("PUT", f"/{index}", {}, {
        "mappings": MAPPINGS,
        "settings": {"index": {"number_of_shards": 1}}})
    assert st == 200
    st, r = c.dispatch("POST", f"/{index}/_bulk", {"refresh": "true"},
                       _bulk(docs))
    assert st == 200 and not r["errors"], r


def test_breaker_settings_parse_as_the_reference():
    from elasticsearch_tpu.utils.breaker import \
        build_breaker_service as jax_build
    settings = {"indices.breaker.total.limit": "1gb",
                "indices.breaker.hbm.limit": "2.5gb"}
    assert build_breaker_service(settings.get).stats() == \
        jax_build(settings.get).stats()
    assert build_breaker_service({}.get).stats() == \
        jax_build({}.get).stats()
    node = Node(device="cpu",
                settings={"indices": {"breaker": {"hbm": {"limit": "1mb"}}}})
    st, stats = node.rest_controller.dispatch("GET", "/_nodes/stats")
    assert stats["nodes"]["node-0"]["breakers"]["hbm"][
        "limit_size_in_bytes"] == 1 << 20
    node.close()


@pytest.mark.parametrize("child", ["request", "fielddata",
                                   "in_flight_requests"])
def test_host_breaker_limits_are_a_typed_400(child):
    """The host children's limit settings are served now: the dense path
    charges ``request`` (its host readbacks, test_torch_traces.py), and
    ``fielddata`` and ``in_flight_requests``, which nothing on a single
    node charges, are accepted as the reference accepts them. No limit
    is a typed 400 any more; ``_nodes/stats`` reports the breakers as the
    reference's service does (the reference reads no
    ``in_flight_requests`` limit: that child keeps the total)."""
    from elasticsearch_tpu.utils.breaker import \
        build_breaker_service as jax_build
    key = f"indices.breaker.{child}.limit"
    node = Node(device="cpu", settings={key: "1mb"})
    try:
        st, stats = node.rest_controller.dispatch("GET", "/_nodes/stats")
        got = stats["nodes"]["node-0"]["breakers"]
        assert got == jax_build({key: "1mb"}.get).stats()
        if child != "in_flight_requests":
            assert got[child]["limit_size_in_bytes"] == 1 << 20
    finally:
        node.close()


def test_a_limit_below_one_segment_answers_429_as_the_reference(tmp_path):
    from elasticsearch_tpu.common.settings import Settings
    docs = make_docs(3000, 12)         # about 260 KB on either package
    small = make_docs(5, 13)           # about 56 KB
    answers = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            node = JaxNode(Settings.from_dict(
                {"indices.breaker.hbm.limit": "100kb"}),
                data_path=str(tmp_path / "n"))
        else:
            node = Node(device="cpu",
                        settings={"indices.breaker.hbm.limit": "100kb"})
        try:
            c = node.rest_controller
            _seed(c, "big", docs)
            _seed(c, "small", small)
            st, r = c.dispatch("POST", "/big/_search", {},
                               {"query": {"match": {"body": "fox"}}})
            st_small, r_small = c.dispatch(
                "POST", "/small/_search", {},
                {"query": {"match": {"body": "fox"}}})
            answers.append((st, r, st_small, r_small, node))
            if pkg == "torch":
                seg = node.indices["big"].engine.segments[0]
                err = r["error"]
                assert err["bytes_wanted"] == port_dev(seg).hbm_bytes()
                assert err["bytes_limit"] == 100 * 1024
                assert err["root_cause"][0]["bytes_wanted"] == \
                    err["bytes_wanted"]
        finally:
            if pkg == "jax":
                node.close()
    (jst, jr, jsst, jsr, _), (st, r, sst, sr, node) = answers
    try:
        assert jst == st == 429
        assert r["error"]["type"] == jr["error"]["type"] \
            == "circuit_breaking_exception"
        assert set(r["error"]) == set(jr["error"])
        assert jsst == sst == 200
        assert sr["hits"]["total"] == jsr["hits"]["total"]
        trips = node.breaker_service.get_breaker(CircuitBreaker.HBM)
        assert trips.trip_count >= 1
    finally:
        node.close()


@pytest.fixture()
def nodes(tmp_path):
    jax_node = JaxNode(data_path=str(tmp_path / "node"))
    node = Node(device="cpu")
    yield jax_node, node
    node.close()
    jax_node.close()


def test_nodes_stats_engine_hbm_equals_live_device_segments(nodes):
    jax_node, node = nodes
    docs = make_docs(8, 1)
    engines = []
    for n in (jax_node, node):
        c = n.rest_controller
        _seed(c, "obs", docs)
        st, _ = c.dispatch("POST", "/obs/_search", {},
                           {"query": {"match": {"body": "fox"}},
                            "sort": [{"n": "desc"}]})
        assert st == 200
        st, stats = c.dispatch("GET", "/_nodes/stats", {}, None)
        assert st == 200
        engines.append(next(iter(stats["nodes"].values()))["engine"])
    jeng, eng = engines
    expected = sum(dev.hbm_bytes()
                   for _v, dev in node.device_cache._cache.values())
    assert eng["hbm"]["total_bytes"] == expected > 0
    assert eng["hbm"]["total_bytes"] == sum(eng["hbm"]["by_class"].values())
    assert eng["hbm"]["peak_bytes"] >= eng["hbm"]["total_bytes"]
    assert node.breaker_service.get_breaker("hbm").used == expected
    assert set(eng) == {"compile", "hbm", "caches"}
    assert set(eng["hbm"]) == set(jeng["hbm"])
    assert set(eng["caches"]) >= {"filter_mask", "bound_plan"}
    # the reference's node keeps numeric metadata columns beside the
    # mapped ones (doc_values), which the port's does not write
    for cls in ("norms", "vectors", "ordinals", "filter_masks"):
        assert eng["hbm"]["by_class"][cls] == jeng["hbm"]["by_class"][cls]
    assert eng["compile"]["count"] >= 0


def test_kernels_endpoint_stable_count_until_new_shape_bucket(nodes):
    _, node = nodes
    _seed(node.rest_controller, "obs", make_docs(8, 2))
    d = node.rest_controller.dispatch
    body = {"query": {"match": {"body": "fox"}}, "sort": [{"n": "desc"}],
            "size": 5}
    d("POST", "/obs/_search", {}, body)          # warmup
    st, k1 = d("GET", "/_kernels", {}, None)
    assert st == 200
    for _ in range(3):
        d("POST", "/obs/_search", {}, body)
    st, k2 = d("GET", "/_kernels", {}, None)
    assert k2["totals"]["count"] == k1["totals"]["count"], (
        "repeated same-shape searches must not add a shape key")
    assert k2["totals"]["calls"] > k1["totals"]["calls"]
    d("POST", "/obs/_search", {}, {**body, "size": 347})
    st, k3 = d("GET", "/_kernels", {}, None)
    assert k3["totals"]["count"] > k2["totals"]["count"]
    assert "masked_topk" in k3["kernels"]
    entry = k3["kernels"]["masked_topk"]
    assert entry["last_compile"]["trigger"] not in (None, "cold")
    assert set(k3["persistent_cache"]) == {"path", "builds", "loads"}
    assert "serving" not in k3          # the fast path was not started


def test_bucket_busting_keys_grow_and_fixed_shapes_stay_flat():
    _, pseg = build_both(80, "cmp1", seed=11)
    searcher = ShardSearcher([pseg], DocumentMapper(MAPPINGS),
                             DeviceSegmentCache("cpu"))
    q = parse_query({"match": {"body": "fox"}})
    sort = [{"n": "desc"}]
    searcher.query_phase(q, 23, sort=sort)
    warm = TRACKER.total_compiles()
    for _ in range(4):
        searcher.query_phase(q, 23, sort=sort)
    assert TRACKER.total_compiles() == warm
    before = TRACKER.total_compiles()
    for k in (311, 313, 317, 331):
        searcher.query_phase(q, k, sort=sort)
    assert TRACKER.total_compiles() - before >= 4
    entry = TRACKER.to_dict()["masked_topk"]
    keys = [sh["key"] for sh in entry["shapes"]]
    assert any("k=331" in key and "scores[1024]float32" in key
               for key in keys)


def test_a_front_index_past_the_limit_is_left_to_the_fallback():
    """The front's index alone passes the hbm limit: the node starts
    without a fast index (not trying it again), and its fallback answers
    the index's 429."""
    import urllib.error
    import urllib.request
    node = Node(device="cpu",
                settings={"indices.breaker.hbm.limit": "20kb"})
    try:
        _seed(node.rest_controller, "big", make_docs(300, 3))
        port = node.start(0)
        assert node.fastpath.front_registration() is None
        assert node._front_refused is node.indices["big"].engine.segments[0]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/big/_search",
            json.dumps({"query": {"match": {"body": "fox"}},
                        "_source": False}).encode(),
            {"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 429
        body = json.load(e.value)
        assert body["error"]["type"] == "circuit_breaking_exception"
        trips = node.breaker_service.get_breaker("hbm").trip_count
        node.refresh_front()            # the drain's refresh: not retried
        assert node.breaker_service.get_breaker("hbm").trip_count == trips
    finally:
        node.close()


def test_an_evicted_front_index_is_unregistered_and_not_pinned():
    """The cache evicts the segment the C++ front serves: the front's
    registration goes with it (its requests go to the fallback), nothing
    keeps the evicted DeviceSegment, and the drain's refresh does not
    re-admit it; a request through the fallback does, and the next
    refresh registers it with the front again."""
    import gc
    import urllib.request
    import weakref
    node = Node(device="cpu")
    try:
        c = node.rest_controller
        _seed(c, "big", make_docs(400, 30))
        _seed(c, "a", make_docs(120, 31))
        _seed(c, "b", make_docs(120, 32))
        port = node.start(0)
        cache, fp = node.device_cache, node.fastpath
        big = node.indices["big"].engine.segments[0]
        assert fp.front_registration()["segment"] is big
        body = {"query": {"match": {"body": "fox"}}, "size": 5}
        st, _ = c.dispatch("POST", "/a/_search", {}, body)
        assert st == 200
        br = node.breaker_service.get_breaker("hbm")
        one_b = DeviceSegment(node.indices["b"].engine.segments[0],
                              "cpu").hbm_bytes()
        # room for what is resident, not for b too: b evicts big (LRU)
        br.limit = br.used + one_b - 1
        dev = weakref.ref(cache.resident(big.name))
        adm0 = cache.churn_counters()[0]
        st, _ = c.dispatch("POST", "/b/_search", {}, body)
        assert st == 200
        assert cache.wait_evictions_heard(timeout=60)
        assert cache.resident(big.name) is None
        assert fp.front_registration() is None
        gc.collect()
        assert dev() is None, gc.get_referrers(dev())
        node.refresh_front()            # the drain's refresh: no admission
        assert cache.churn_counters()[0] == adm0 + 1
        assert fp.front_registration() is None
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/big/_search",
            json.dumps({**body, "_source": False}).encode(),
            {"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200 and json.load(r)["hits"]["hits"]
        assert cache.resident(big.name) is not None
        node.refresh_front()
        assert fp.front_registration()["segment"] is big
        assert cache.wait_evictions_heard(timeout=60)
        assert br.used == cache.hbm_stats()["total_bytes"]
    finally:
        node.close()
