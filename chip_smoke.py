#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py                  # full size: 2M docs, 256 queries
    python3 chip_smoke.py --docs 200000    # a quicker rehearsal

Phases (any failure exits non-zero; no exception is swallowed):
  1. build    every hand-written CUDA kernel from elasticsearch_tpu_torch/csrc
  2. kernels  each kernel against its plain PyTorch twin at main-path shapes
              (a 32-query cohort at NB=4096, 16 slots, on the corpus), timed;
              the merge also at NB=1024 and 2048 and on a tie-heavy cohort
  3. rest     a port Node on CUDA indexes ~2,000 generated docs through
              _bulk, refreshes, force-merges and answers 20 match queries over
              HTTP on the v2m lane; ids, order and totals equal the float64
              oracle. Then the plan path over HTTP on an index of two
              segments with a keyword field: the reference's plan test
              bodies (bool, term, terms, constant_score, multi_match,
              dis_max, match options), a post_filter, a from > 0 and a size
              above 1000, each equal to the port's own CPU execution on the
              same segments; the bodies with a range clause are typed 400s
  4. scale    the seeded 2M-doc corpus installed as the index's one segment;
              concurrent size:1000 match queries over HTTP, each served by
              the v2m lane when its slot layout fits and by the plan path
              otherwise (no query is refused); totals exact against a
              float64 oracle, recall@1000 = 1.0 on the v2m lane, and on the
              plan path every oracle top-k doc that is missing ties the kth
              score within float32 rounding (rtol 1e-5); the plan answers
              equal the port's CPU execution; the launch counters of both
              kernels grow during this phase. Then: the v2m-served queries
              alone, and all of them again under torch.profiler with each
              lane's cohort launches named (each lane's device seconds in
              the mixed load); the plan-served queries all at once (the
              cohorts they form, the lanes and memory in flight); and the
              cohorts the PlanBatcher forms from them, traced one by one
  5. report   the scale, plan-trace and kernels JSON lines,
              the card's name and power limit, and the last line
              {"ok": true, "device": {...}}

Needs one CUDA card, and the repository around it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
# non-tensor-core peaks of the H100 SXM data sheet, for the operations
# bound: 67 TFLOP/s float32, 34 TFLOP/s float64; int32 is taken at the
# float32 issue rate halved (one integer pipe per two float lanes)
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12, "int32": 33.5e12}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def check(cond, what: str):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int, warmup: int = 2):
    """(device ms per call, host ms per call) of ``fn()`` over ``iters``
    calls. The card first spins on a sleep kernel while the host queues
    every call behind it, so the CUDA events time the device work alone
    and not the host's launch gaps; if the card finished its sleep before
    the host finished queueing, the sleep doubles and the run repeats."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 50_000_000
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = time.perf_counter() - t0
        ahead = not start.query()
        stop.record()
        torch.cuda.synchronize()
        if ahead:
            break
        cycles *= 2
    else:
        log(f"[time] the host could not queue {iters} calls ahead of the "
            f"card; the time includes host gaps")
    return start.elapsed_time(stop) / iters, host * 1e3 / iters


def bound_ms(n_bytes: float, n_ops: float, op_type: str):
    """(least ms for this work on the card, "bytes" | "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def http(port: int, method: str, path: str, body=None, ndjson=False):
    data = None
    headers = {}
    if body is not None:
        data = body.encode() if ndjson else json.dumps(body).encode()
        headers["Content-Type"] = ("application/x-ndjson" if ndjson
                                   else "application/json")
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data,
                                 headers, method=method)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


# ---------------------------------------------------------------- phase 2
def tie_heavy_keys(q, n_slots, length, dev, seed):
    """[q, n_slots, length] int32 slots of keys drawn from 64 values,
    ascending, each filled to a random length and padded with the
    sentinel; every fifth slot from the fourth on is all sentinel."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randint(0, 64, (q, n_slots, length), generator=g,
                         device=dev, dtype=torch.int32).sort(dim=2).values
    fill = torch.randint(0, length + 1, (q, n_slots, 1), generator=g,
                         device=dev)
    fill[:, 3::5] = 0
    pos = torch.arange(length, device=dev)
    return torch.where(pos < fill, keys, torch.full_like(keys, 0x7FFFFFFF))


def merge_case(keys, n_slots, iters):
    """The merge kernel on ``keys`` ([q, p] or [q, n_slots, L] int32,
    each slot ascending) with the lane payload, held bit for bit against
    its twin and against one ``torch.sort(stable=True)``, and timed."""
    import torch

    from elasticsearch_tpu_torch.ops.merge import (merge_sorted_slots,
                                                   merge_sorted_slots_plain)
    q = keys.shape[0]
    p = keys.numel() // q
    flat = keys.reshape(q, p)
    skeys = flat.view(q, n_slots, p // n_slots)
    lane = torch.arange(p, dtype=torch.int32, device=keys.device) \
        .repeat(q, 1).view(q, n_slots, p // n_slots)
    mk, mv = merge_sorted_slots(skeys, lane)
    pk, pv = merge_sorted_slots_plain(skeys, lane)
    lk, lv = torch.sort(flat, dim=1, stable=True)
    torch.cuda.synchronize()
    check(torch.equal(mk, pk) and torch.equal(mv, pv),
          f"merge kernel keys and payload bit-equal to the stable sort "
          f"over [{q}, {p}]")
    check(torch.equal(lk, pk) and torch.equal(lv.to(torch.int32), pv),
          "torch.sort agrees with the twin")
    # each (key, payload) pair read once and written once; a merge of
    # n_slots runs needs at least log2(n_slots) comparisons per element
    n_bytes = q * p * 16
    b, by = bound_ms(n_bytes, (n_slots.bit_length() - 1) * q * p, "int32")
    ms, host = cuda_ms(lambda: merge_sorted_slots(skeys, lane), iters)
    return dict(
        q=q, p=p,
        max_abs_err=float((mk.long() - pk.long()).abs().max()
                          + (mv.long() - pv.long()).abs().max()),
        ms=ms, host_ms=host,
        plain_ms=cuda_ms(lambda: merge_sorted_slots_plain(skeys, lane),
                         iters)[0],
        library_ms=cuda_ms(lambda: torch.sort(flat, dim=1, stable=True),
                           iters)[0],
        bound_ms=b, bound_by=by, bytes=n_bytes)


def phase_kernels(node, seg, queries, iters):
    import torch

    from elasticsearch_tpu_torch.ops.bm25_contrib import (
        gather_bm25_contrib, gather_bm25_contrib_plain)
    from elasticsearch_tpu_torch.search.fastpath import (MAX_K, N_SLOTS,
                                                         NB_BUCKETS, Q_BATCH)
    fp = node.serving_lane()
    reg = fp.register("bench", seg, "title", 1.2, 0.75)
    bucket = NB_BUCKETS[-1]
    cohort = [q for q in queries if fp._v2_bucket(reg, q) is not None]
    cohort = cohort[:Q_BATCH]
    check(len(cohort) == Q_BATCH, f"{Q_BATCH} fitting queries "
          f"for the kernel cohort (got {len(cohort)})")
    sel, ws, mids = fp.assemble_cohort(reg, bucket, cohort)
    dev = fp.device
    dp = reg["dp"]
    sel_t = torch.from_numpy(sel).to(dev)
    ws64 = torch.from_numpy(ws).to(dev)
    mids_t = torch.from_numpy(mids).to(dev)
    masks = reg["masks"]
    avg64 = float(np.float64(dp.avg_len))
    args64 = (dp.block_docids, dp.block_tfs, sel_t, ws64, dp.doc_lens,
              masks, mids_t, avg64, 1.2, 0.75)
    q, nb = sel.shape
    p = nb * 128
    out = {}

    # ---- kernel 1: gather + contribution, f64 rail (serving) and f32
    keys_k, con_k = gather_bm25_contrib(*args64)
    keys_p, con_p = gather_bm25_contrib_plain(*args64)
    torch.cuda.synchronize()
    check(torch.equal(keys_k, keys_p), "contrib kernel keys == twin keys")
    err64 = float((con_k - con_p).abs().max())
    rel64 = float(((con_k - con_p).abs()
                   / con_p.abs().clamp_min(1e-300)).max())
    check(rel64 <= 1e-12, f"contrib kernel f64 rtol {rel64} <= 1e-12")
    ws32 = ws64.to(torch.float32)
    avg32 = float(np.float32(dp.avg_len))
    args32 = args64[:3] + (ws32,) + args64[4:7] + (avg32, 1.2, 0.75)
    k32, c32 = gather_bm25_contrib(*args32)
    kp32, cp32 = gather_bm25_contrib_plain(*args32)
    torch.cuda.synchronize()
    rel32 = float(((c32 - cp32).abs() / cp32.abs().clamp_min(1e-30)).max())
    check(torch.equal(k32, kp32) and rel32 <= 2e-7,
          f"contrib kernel f32 rtol {rel32} <= 2e-7")
    n_valid = int((keys_k != 0x7FFFFFFF).sum())
    # bytes this cohort needs: docid + tf of every DISTINCT selected
    # block (the padding lanes all read the one zero block, and queries
    # share the blocks of common terms), the doc length and mask byte of
    # every real posting, the block id and weight of every selected
    # block, and both outputs written once per lane; operations: 7
    # float64 ones per real posting (2 divisions)
    n_blocks = len(np.unique(sel))
    bytes1 = (n_blocks * 128 * 8 + n_valid * 5 + q * nb * 12
              + p * q * (4 + 8))
    b1, by1 = bound_ms(bytes1, 7 * n_valid, "float64")
    ms1, host1 = cuda_ms(lambda: gather_bm25_contrib(*args64), iters)
    out["gather_bm25_contrib"] = dict(
        max_abs_err=err64, rtol_f64=rel64, rtol_f32=rel32, ms=ms1,
        host_ms=host1,
        plain_ms=cuda_ms(lambda: gather_bm25_contrib_plain(*args64),
                         iters)[0],
        library_ms=None, bound_ms=b1, bound_by=by1, bytes=bytes1,
        valid_lanes=n_valid, lanes=p * q, distinct_blocks=n_blocks)
    log(f"[kernels] contrib f64 max_abs_err={err64} rtol={rel64}; "
        f"f32 rtol={rel32}; {n_valid}/{p * q} real postings")

    # ---- kernel 2: merge of the 16 docid-sorted slots, lane payload, at
    # every bucket the lane launches (the corpus's keys, through kernel 1)
    # and on a tie-heavy cohort; the row keeps NB = 4096
    per_case = {}
    smallest = [fp._v2_bucket(reg, qq) for qq in queries]
    for b in NB_BUCKETS:
        if b == bucket:
            keys_b = keys_k
        else:
            fit = [qq for qq, sb in zip(queries, smallest)
                   if sb is not None and sb <= b][:Q_BATCH]
            check(fit, f"queries that fit bucket {b}")
            sel_b, ws_b, mids_b = fp.assemble_cohort(reg, b, fit)
            keys_b = gather_bm25_contrib(
                dp.block_docids, dp.block_tfs,
                torch.from_numpy(sel_b).to(dev),
                torch.from_numpy(ws_b).to(dev), dp.doc_lens, masks,
                torch.from_numpy(mids_b).to(dev), avg64, 1.2, 0.75)[0]
        per_case[f"nb{b}"] = merge_case(keys_b, N_SLOTS, iters)
    per_case["tie_heavy"] = merge_case(
        tie_heavy_keys(q, N_SLOTS, p // N_SLOTS, dev, seed=q), N_SLOTS,
        iters)
    main = per_case[f"nb{bucket}"]
    out["merge_sorted_slots"] = dict(
        main, max_abs_err=max(r["max_abs_err"] for r in per_case.values()),
        per_bucket=per_case)
    for case, r in per_case.items():
        log(f"[kernels] merge {case} [{r['q']}, {r['p']}] bit-equal to "
            f"the twin: kernel {r['ms']:.4f} ms, torch.sort "
            f"{r['library_ms']:.4f} ms, twin {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms")
    for name, r in out.items():
        log(f"[kernels] {name}: kernel {r['ms']:.4f} ms (host "
            f"{r['host_ms']:.4f} ms per call), twin {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms")

    # ---- one whole cohort launch, traced: device time by kernel
    from torch.profiler import ProfilerActivity, profile

    from elasticsearch_tpu_torch.ops.fastpath import \
        bm25_topk_total_merge_batch

    def cohort():
        return bm25_topk_total_merge_batch(
            dp.block_docids, dp.block_tfs, sel_t, ws64, dp.doc_lens, masks,
            mids_t, dp.avg_len, N_SLOTS, 1.2, 0.75, MAX_K)

    cohort_ms, _ = cuda_ms(cohort, 5)
    reps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            cohort()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = kernel_rows(events)
    total_us = sum(self_dev(e) for e in kernels)
    mine = {"gather_bm25_contrib": "gather_contrib_kernel",
            "merge_sorted_slots": "merge_path_round"}
    share = {n: sum(self_dev(e) for e in kernels if m in e.key)
             / max(total_us, 1) for n, m in mine.items()}
    log("[cohort] device time of one cohort launch by kernel "
        f"({reps} launches traced):")
    log(events.table(sort_by="self_cuda_time_total", row_limit=14))
    out["cohort"] = dict(ms=cohort_ms, traced_device_ms=total_us / reps / 1e3,
                         kernel_share=share)
    log(f"[cohort] {cohort_ms:.3f} ms per cohort launch (events); traced "
        f"{total_us / reps / 1e3:.3f} ms; shares {share}")
    return out


# ---------------------------------------------------------------- phase 3
def phase_rest_small(node, port, seed):
    from elasticsearch_tpu_torch.ops.bm25 import bm25_reference_scores
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    zipf = 1.0 / np.arange(1, len(vocab) + 1) ** 1.1
    zipf /= zipf.sum()
    n_docs = 2000
    docs = [list(rng.choice(len(vocab), size=int(rng.integers(3, 40)),
                            p=zipf)) for _ in range(n_docs)]
    st, _ = http(port, "PUT", "/small",
                 {"mappings": {"properties": {"body": {"type": "text"}}}})
    check(st == 200, f"PUT /small -> {st}")
    for lo in range(0, n_docs, 500):
        lines = []
        for i in range(lo, min(n_docs, lo + 500)):
            lines.append(json.dumps({"index": {"_id": str(i)}}))
            lines.append(json.dumps(
                {"body": " ".join(vocab[t] for t in docs[i])}))
        st, r = http(port, "POST", "/small/_bulk", "\n".join(lines) + "\n",
                     ndjson=True)
        check(st == 200 and not r["errors"], f"_bulk -> {st}")
        if lo == 1000:
            http(port, "POST", "/small/_refresh")
    st, _ = http(port, "POST", "/small/_refresh")
    check(st == 200, "_refresh")
    st, _ = http(port, "POST", "/small/_forcemerge?max_num_segments=1")
    check(st == 200, "_forcemerge")

    # independent oracle from the generated token lists
    lens = np.array([len(d) for d in docs], np.float64)
    avg = lens.sum() / n_docs
    post = {}
    for i, d in enumerate(docs):
        for t, c in zip(*np.unique(d, return_counts=True)):
            post.setdefault(int(t), ([], []))
            post[int(t)][0].append(i)
            post[int(t)][1].append(float(c))
    n_ok = 0
    for qi in range(20):
        terms = sorted({int(t) for t in rng.choice(
            len(vocab), size=int(rng.integers(1, 5)), p=zipf)})
        size = int(rng.choice([10, 50, 200]))
        st, r = http(port, "POST", "/small/_search", {
            "query": {"match": {"body": " ".join(vocab[t] for t in terms)}},
            "size": size})
        check(st == 200, f"small _search -> {st} {r}")
        pl = [post.get(t, ([], [])) for t in terms]
        idfs = [np.log(1 + (n_docs - len(p[0]) + 0.5) / (len(p[0]) + 0.5))
                for p in pl]
        scores = bm25_reference_scores(pl, idfs, lens, avg, 1.2, 0.75)
        matched = np.nonzero(scores > 0)[0]
        top = matched[np.lexsort((matched, -scores[matched]))][:size]
        # the served order is (reported float32 score desc, docid asc)
        top = top[np.lexsort((top, -scores[top].astype(np.float32)))]
        got = [int(h["_id"]) for h in r["hits"]["hits"]]
        check(r["hits"]["total"] == {"value": len(matched),
                                     "relation": "eq"},
              f"small query {qi} total {r['hits']['total']} vs "
              f"{len(matched)}")
        check(got == top.tolist(), f"small query {qi} ids/order")
        got_s = np.array([h["_score"] for h in r["hits"]["hits"]])
        check(np.allclose(got_s, scores[top], rtol=1e-6, atol=0),
              f"small query {qi} scores")
        n_ok += 1
    log(f"[rest-small] {n_docs} docs, {n_ok} queries equal to the oracle")
    return n_ok


def hits_match_cpu(r, res, segments, lo, what):
    """An HTTP answer ``r`` against the port's CPU execution ``res`` (a
    QueryResult of at least lo + len(hits) docs): ids, order and totals
    exact, scores within rtol 1e-6."""
    want = res.docs[lo:lo + len(r["hits"]["hits"])]
    check(r["hits"]["total"] == {"value": res.total_hits, "relation": "eq"},
          f"{what}: total {r['hits']['total']} vs CPU {res.total_hits}")
    check(len(r["hits"]["hits"]) == len(want), f"{what}: hit count")
    check([h["_id"] for h in r["hits"]["hits"]]
          == [segments[d.segment_idx].stored.ids[d.docid] for d in want],
          f"{what}: ids and order equal to the CPU execution")
    got_s = np.array([h["_score"] for h in r["hits"]["hits"]], np.float64)
    want_s = np.array([d.score for d in want], np.float64)
    check(np.allclose(got_s, want_s, rtol=1e-6, atol=0),
          f"{what}: scores within rtol 1e-6 of the CPU execution")


def phase_plan_small(node, port, seed):
    """The plan path over HTTP on a two-segment index (title, body text;
    tag keyword), each answer held against the port's CPU execution."""
    from elasticsearch_tpu_torch.corpus import (PLAN_CASES, PLAN_MAPPINGS,
                                                plan_doc)
    from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
    from elasticsearch_tpu_torch.search.queries import parse_query
    from elasticsearch_tpu_torch.search.searcher import ShardSearcher
    rng = np.random.default_rng(seed)
    st, _ = http(port, "PUT", "/plan", {"mappings": PLAN_MAPPINGS})
    check(st == 200, f"PUT /plan -> {st}")
    n_docs = 2400
    for lo in (0, n_docs // 2):          # two refreshes: two segments
        lines = []
        for i in range(lo, lo + n_docs // 2):
            lines.append(json.dumps({"index": {"_id": str(i)}}))
            lines.append(json.dumps(plan_doc(rng)))
        st, r = http(port, "POST", "/plan/_bulk", "\n".join(lines) + "\n",
                     ndjson=True)
        check(st == 200 and not r["errors"], f"_bulk -> {st}")
        check(http(port, "POST", "/plan/_refresh")[0] == 200, "_refresh")
    svc = node.indices["plan"]
    segments = svc.engine.segments
    check(len(segments) == 2, f"two segments (got {len(segments)})")
    cpu = ShardSearcher(segments, svc.mapper, DeviceSegmentCache("cpu"),
                        svc.k1, svc.b)
    batcher = node.search_service.plan_batcher
    launches0 = batcher.launches
    bodies = [{"query": c, "size": 50} for c in PLAN_CASES
              if "range" not in json.dumps(c)]
    bodies += [
        {"query": {"match": {"body": "wolf fox"}},
         "post_filter": {"term": {"tag": "red"}}, "size": 100},
        {"query": PLAN_CASES[12], "from": 7, "size": 20},
        {"query": PLAN_CASES[9], "size": 2000},
    ]
    for i, body in enumerate(bodies):
        st, r = http(port, "POST", "/plan/_search", body)
        check(st == 200, f"plan body {i} -> {st} {r}")
        lo = body.get("from", 0)
        pf = body.get("post_filter")
        res = cpu.query_phase(parse_query(body["query"]),
                              lo + body["size"],
                              None if pf is None else parse_query(pf))
        check(res.total_hits > 0, f"plan body {i} matches")
        hits_match_cpu(r, res, segments, lo, f"plan body {i}")
    n_typed = 0
    for c in PLAN_CASES:
        if "range" in json.dumps(c):
            st, r = http(port, "POST", "/plan/_search", {"query": c})
            check(st == 400 and r["error"]["type"]
                  == "unsupported_in_slice_exception",
                  f"a range clause is a typed 400 ({st})")
            n_typed += 1
    out = dict(docs=n_docs, segments=len(segments), bodies=len(bodies),
               typed_400=n_typed,
               plan_launches=batcher.launches - launches0)
    check(out["plan_launches"] >= len(bodies), "plan launches")
    log(f"[plan-small] {out}: every answer equal to the CPU execution")
    return out


# ---------------------------------------------------------------- phase 4
def drive(port, bodies, clients):
    """``bodies`` as _search requests to /bench from ``clients``
    threads: ([(status, response)], latency s of each, wall s)."""
    results = [None] * len(bodies)
    lat = [0.0] * len(bodies)
    nxt = [0]
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(bodies):
                return
            t0 = time.perf_counter()
            results[i] = http(port, "POST", "/bench/_search", bodies[i])
            lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "clients finished")
    return results, lat, wall


def p50_p99(lat_s):
    ms = np.asarray(lat_s) * 1e3
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def phase_rest_scale(node, port, corpus, queries, clients, k):
    from elasticsearch_tpu_torch.corpus import exact_topk, term_name
    svc = node.indices["bench"]
    seg = svc.engine.segments[0]
    fp = node.serving_lane()
    reg = fp.register("bench", seg, "title", svc.k1, svc.b)
    # the lane each query takes: the REST layer's own predicate
    lanes = ["v2m" if fp.fits(reg, q, k) else "plan" for q in queries]
    bodies = [{"query": {"match": {"title": " ".join(
        term_name(t) for t in q)}}, "size": k} for q in queries]
    results, lat, wall = drive(port, bodies, clients)
    misfits = sum(1 for st, r in results if st == 400)
    for i, (st, r) in enumerate(results):
        check(st == 200, f"scale query {i} ({lanes[i]}) -> {st} {r}")
    t_or = time.time()
    recall = {"v2m": [], "plan": []}
    for i, (_, r) in enumerate(results):
        truth, scores, total = exact_topk(corpus, queries[i], k)
        got = [int(h["_id"]) for h in r["hits"]["hits"]]
        check(r["hits"]["total"] == {"value": total, "relation": "eq"},
              f"scale query {i} total {r['hits']['total']} vs {total}")
        check(len(got) == len(truth), f"scale query {i} hit count")
        hit = np.isin(truth, got)
        recall[lanes[i]].append(float(hit.mean()) if len(truth) else 1.0)
        if lanes[i] == "plan" and not hit.all():
            # float32 ranking: a doc of the oracle's top k may be missing
            # only where it ties the kth score within float32 rounding
            kth = scores[-1]
            check(bool(np.all(np.abs(scores[~hit] - kth) <= 1e-5 * kth)),
                  f"scale query {i}: the missing oracle docs tie the kth "
                  f"score within rtol 1e-5")
    check(not recall["v2m"] or min(recall["v2m"]) == 1.0,
          f"recall@{k} = 1.0 on every v2m-served query")
    def pct(lane):
        sel = [lat[i] for i in range(len(queries))
               if lane in (None, lanes[i])]
        return p50_p99(sel) if sel else (None, None)

    res = dict(queries=len(queries), misfits=misfits,
               served_v2m=lanes.count("v2m"), served_plan=lanes.count("plan"),
               clients=clients, wall_s=wall, qps=len(queries) / wall,
               p50_ms=pct(None)[0], p99_ms=pct(None)[1],
               p50_ms_v2m=pct("v2m")[0], p99_ms_v2m=pct("v2m")[1],
               p50_ms_plan=pct("plan")[0], p99_ms_plan=pct("plan")[1],
               recall_min_v2m=min(recall["v2m"], default=None),
               recall_min_plan=min(recall["plan"], default=None),
               oracle_s=time.time() - t_or)
    log(f"[rest-scale] {res}")
    return res, lanes, bodies, results


def phase_plan_cpu(node, lanes, bodies, results, k):
    """The plan-served answers of the scale phase against the port's CPU
    execution of the same queries on the same segment."""
    from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
    from elasticsearch_tpu_torch.search.queries import parse_query
    from elasticsearch_tpu_torch.search.searcher import ShardSearcher
    svc = node.indices["bench"]
    segments = svc.engine.segments
    cpu = ShardSearcher(segments, svc.mapper, DeviceSegmentCache("cpu"),
                        svc.k1, svc.b)
    t0 = time.time()
    n = 0
    for i, lane in enumerate(lanes):
        if lane != "plan":
            continue
        res = cpu.query_phase(parse_query(bodies[i]["query"]), k)
        hits_match_cpu(results[i][1], res, segments, 0,
                       f"scale plan query {i}")
        n += 1
    log(f"[plan-cpu] {n} plan-served answers equal to the CPU execution "
        f"({time.time() - t0:.1f} s)")
    return n


def dev_total(e):
    """Device microseconds of a profiler row and of what ran under it."""
    return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))


def self_dev(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def kernel_rows(events):
    """The device rows (kernels) of ``key_averages()``; an operator row
    repeats the time of the kernels it launched."""
    import torch
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def all_threads():
    """The profiler option that records the operators of every thread
    (the HTTP and drain threads launch the cohorts), or None where this
    torch lacks it: the trace then records the main thread's alone."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def phase_scale_trace(node, port, lanes, bodies, clients):
    """What the plan cohorts cost the v2m lane on the card they share.
    (a) The scale phase's v2m-served queries alone, untraced: latency and
    the CUDA-event seconds of their cohorts. (b) All the queries again
    under torch.profiler, each v2m and each plan cohort launch inside a
    named range, so the trace gives each lane's device seconds in the
    mixed load."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from elasticsearch_tpu_torch.ops import plan as plan_ops
    from elasticsearch_tpu_torch.search import fastpath
    fp = node.fastpath
    v2m = [b for b, lane in zip(bodies, lanes) if lane == "v2m"]
    c0, busy0 = fp.stats["cohorts"], fp.timing["device_busy_s"]
    results, lat, wall = drive(port, v2m, clients)
    check(all(st == 200 for st, _ in results), "v2m-only run answered")
    p50, p99 = p50_p99(lat)
    alone = dict(queries=len(v2m), wall_s=wall, p50_ms=p50, p99_ms=p99,
                 cohorts=fp.stats["cohorts"] - c0,
                 device_busy_s=fp.timing["device_busy_s"] - busy0)

    orig = (fastpath.bm25_topk_total_merge_batch, plan_ops.plan_topk_batch)

    def named(name, fn):
        def wrapped(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapped

    fastpath.bm25_topk_total_merge_batch = named("v2m_cohort", orig[0])
    plan_ops.plan_topk_batch = named("plan_cohort", orig[1])
    c0, busy0 = fp.stats["cohorts"], fp.timing["device_busy_s"]
    config = all_threads()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     experimental_config=config) as prof:
            results, lat, wall = drive(port, bodies, clients)
            torch.cuda.synchronize()
    finally:
        fastpath.bm25_topk_total_merge_batch, plan_ops.plan_topk_batch = orig
    check(all(st == 200 for st, _ in results), "traced run answered")
    events = prof.key_averages()
    total_us = sum(self_dev(e) for e in kernel_rows(events))
    ranges = {n: [e for e in events if e.key == n
                  and e.device_type == torch.autograd.DeviceType.CPU]
              for n in ("v2m_cohort", "plan_cohort")}
    lane_lat = {lane: [t for t, ln in zip(lat, lanes) if ln == lane]
                for lane in ("v2m", "plan")}
    mixed = dict(
        queries=len(bodies), wall_s=wall,
        p50_ms_v2m=p50_p99(lane_lat["v2m"])[0],
        p50_ms_plan=p50_p99(lane_lat["plan"])[0],
        device_s=total_us / 1e6, idle_share=1.0 - total_us / 1e6 / wall,
        device_s_v2m=sum(dev_total(e) for e in ranges["v2m_cohort"]) / 1e6,
        device_s_handwritten=sum(
            self_dev(e) for e in kernel_rows(events)
            if "gather_contrib_kernel" in e.key
            or "merge_path_round" in e.key) / 1e6,
        device_s_plan=sum(dev_total(e) for e in ranges["plan_cohort"])
        / 1e6,
        v2m_launches=sum(e.count for e in ranges["v2m_cohort"]),
        plan_launches=sum(e.count for e in ranges["plan_cohort"]),
        v2m_cohorts=fp.stats["cohorts"] - c0,
        v2m_device_busy_s=fp.timing["device_busy_s"] - busy0,
        all_threads=config is not None)
    if config is not None:
        check(mixed["v2m_launches"] == mixed["v2m_cohorts"]
              and mixed["plan_launches"] > 0,
              f"every cohort launch of both lanes named in the trace: "
              f"{mixed}")
    out = dict(v2m_alone=alone, mixed_traced=mixed)
    log(f"[scale-trace] {out}")
    return out


def phase_plan_burst(node, port, lanes, bodies, results):
    """The scale phase's plan-served queries sent all at once: the
    cohorts the PlanBatcher forms from them, the lanes in flight at once
    against its admission limit, and the device memory they hold. Each
    answer equals the one the scale phase checked."""
    import torch

    from elasticsearch_tpu_torch.search import batching
    picked = [i for i, lane in enumerate(lanes) if lane == "plan"]
    check(picked, "plan-served queries for the burst")
    batcher = node.search_service.plan_batcher
    s0 = batcher.stats()
    batcher.peak_lanes_in_flight = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got, lat, wall = drive(port, [bodies[i] for i in picked], len(picked))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    for (st, r), i in zip(got, picked):
        want = results[i][1]["hits"]
        check(st == 200 and r["hits"]["total"] == want["total"]
              and [h["_id"] for h in r["hits"]["hits"]]
              == [h["_id"] for h in want["hits"]]
              and np.allclose([h["_score"] for h in r["hits"]["hits"]],
                              [h["_score"] for h in want["hits"]],
                              rtol=1e-6, atol=0),
              f"burst query {i}: ids, order and total equal to its "
              f"scale-phase answer, scores within rtol 1e-6")
    s1 = batcher.stats()
    hist = {q: n - s0["batch_hist"].get(q, 0)
            for q, n in s1["batch_hist"].items()
            if n > s0["batch_hist"].get(q, 0)}
    p50, p99 = p50_p99(lat)
    out = dict(queries=len(picked), wall_s=wall, p50_ms=p50, p99_ms=p99,
               cohorts=s1["launches"] - s0["launches"], q_bucket_hist=hist,
               peak_lanes_in_flight=s1["peak_lanes_in_flight"],
               max_lanes_in_flight=batching.MAX_LANES_IN_FLIGHT,
               admission_waits=s1["admission_waits"]
               - s0["admission_waits"],
               peak_extra_bytes=peak - base, resident_bytes=base)
    log(f"[plan-burst] {out}")
    return out


def phase_plan_trace(node, lanes, bodies, k, reps=3):
    """The cohorts the PlanBatcher forms from the scale phase's
    plan-served queries, each traced with torch.profiler: the largest
    group that shares a signature (one width tier), as one cohort when
    they arrive together (at most 32, the batch cap), and one member of it
    alone, the Q the scale phase's cohorts mostly reached. For each: device
    time, the top operator rows as shares of it, the NB tier and the peak
    device memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from elasticsearch_tpu_torch.search import batching
    from elasticsearch_tpu_torch.search.plan import bind_plan, compile_plan
    from elasticsearch_tpu_torch.search.queries import parse_query
    from elasticsearch_tpu_torch.search.searcher import ShardSearcher
    svc = node.indices["bench"]
    searcher = ShardSearcher(svc.engine.segments, svc.mapper,
                             node.device_cache, svc.k1, svc.b)
    ctx = searcher._contexts()[0]
    picked = [bodies[i] for i, lane in enumerate(lanes) if lane == "plan"]
    check(picked, "plan-served queries to trace")
    batcher = batching.PlanBatcher()
    groups = {}
    for b in picked:
        bp = bind_plan(compile_plan(parse_query(b["query"]), searcher), ctx)
        groups.setdefault(batcher._signature(bp, ctx, k, svc.k1, svc.b),
                          []).append(bp)
    largest = max(groups.values(), key=len)[:batching.MAX_BATCH]

    def trace(bps):
        widths = [int(bp.streams[0].sel_blocks.shape[0]) for bp in bps]

        def run():
            batcher._run([batching._Entry(bp) for bp in bps], ctx, k,
                         svc.k1, svc.b)

        run()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        events = prof.key_averages()
        total_us = sum(self_dev(e) for e in kernel_rows(events))
        ops = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CPU
                      and self_dev(e) > 0), key=self_dev, reverse=True)
        q_bucket = batching._q_bucket(len(bps))
        log(f"[plan-trace] a cohort of {len(bps)} (Q bucket {q_bucket}), "
            f"by operator:")
        log(events.table(sort_by="self_cuda_time_total", row_limit=16))
        return dict(
            cohort=len(bps), q_bucket=q_bucket, nb_width=max(widths),
            nb_tier=batching._nb_tier(max(widths)),
            nb_widths=sorted(set(widths)),
            lanes=batching.PlanBatcher._lanes(
                [batching._Entry(bp) for bp in bps]),
            device_ms=total_us / reps / 1e3, wall_ms=wall_ms,
            top_ops={e.key: self_dev(e) / max(total_us, 1) for e in ops[:10]},
            peak_bytes=peak, peak_extra_bytes=peak - base,
            resident_bytes=base)

    out = dict(
        signature_groups=sorted((len(g) for g in groups.values()),
                                reverse=True),
        cohorts=[trace(largest), trace(largest[:1])])
    log(f"[plan-trace] {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=2_000_000)
    ap.add_argument("--vocab", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is "
            "False); nothing was run")
        return 2
    try:
        from elasticsearch_tpu_torch.corpus import (build_corpus,
                                                    make_queries,
                                                    segment_from_corpus)
        from elasticsearch_tpu_torch.node import Node
        from elasticsearch_tpu_torch.ops import _build
        from elasticsearch_tpu_torch.ops.bm25_contrib import \
            gather_bm25_contrib
        from elasticsearch_tpu_torch.ops.merge import merge_sorted_slots
    except ImportError as e:
        log(f"chip_smoke: the elasticsearch_tpu_torch package is not "
            f"beside this script ({e})")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"gather_bm25_contrib": gather_bm25_contrib,
                "merge_sorted_slots": merge_sorted_slots}

    # ---- 1. build
    t0 = time.time()
    _build.build_all()
    log(f"[build] kernels built and loaded in {time.time() - t0:.2f} s "
        f"into {_build.build_dir()}")
    log(_build.build_log())

    # set-up: the seeded corpus and its query log
    t0 = time.time()
    rng = np.random.default_rng(args.seed)
    corpus = build_corpus(rng, n_docs=args.docs, vocab=args.vocab)
    queries = make_queries(rng, corpus["df"], n_docs=args.docs,
                           n_queries=args.queries)
    seg = segment_from_corpus(corpus)
    log(f"[setup] corpus {args.docs} docs, {corpus['block_docids'].shape[0]}"
        f" blocks, {len(queries)} queries in {time.time() - t0:.1f} s")

    node = Node(device="cuda")
    try:
        node.create_index("bench", {"properties": {"title":
                                                   {"type": "text"}}})
        node.indices["bench"].engine.install_segments([seg])
        port = node.start(0)
        st, info = http(port, "GET", "/")
        check(st == 200, "GET /")

        # ---- 2. kernels vs twins
        kern = phase_kernels(node, seg, queries, args.iters)

        # ---- 3. REST, small: the v2m lane, then the plan path
        for fn in counters.values():
            fn.launches = 0
        phase_rest_small(node, port, args.seed + 1)
        small = {n: fn.launches for n, fn in counters.items()}
        check(all(v > 0 for v in small.values()),
              f"both kernels launched in the small REST phase: {small}")
        plan_small = phase_plan_small(node, port, args.seed + 2)

        # ---- 4. REST, at scale (the main path)
        fp = node.fastpath
        batcher = node.search_service.plan_batcher
        c0, q0 = fp.stats["cohorts"], fp.stats["fast_queries"]
        p0 = batcher.stats()
        t_before = dict(fp.timing)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        scale, lanes, bodies, results = phase_rest_scale(
            node, port, corpus, queries, args.clients, 1000)
        launches = {n: fn.launches for n, fn in counters.items()}
        scale["peak_bytes"] = torch.cuda.max_memory_allocated()
        cohorts = fp.stats["cohorts"] - c0
        scale["cohorts"] = cohorts
        scale["mean_cohort_width"] = (fp.stats["fast_queries"] - q0) \
            / max(1, cohorts)
        p1 = batcher.stats()
        scale["plan_cohorts"] = p1["launches"] - p0["launches"]
        scale["plan_queries"] = p1["batched_queries"] - p0["batched_queries"]
        check(scale["plan_queries"] == scale["served_plan"],
              f"the plan-served queries went through the PlanBatcher "
              f"({scale['plan_queries']} vs {scale['served_plan']})")
        # where the drain thread's time went, and the device's idle
        # share: 1 - the v2m cohorts' device seconds (CUDA events around
        # each launch, so it is a lower bound on idle; plan cohorts are
        # not timed) / the phase's wall time
        scale["drain_s"] = {k: fp.timing[k] - t_before[k]
                            for k in fp.timing}
        scale["device_idle_share"] = \
            1.0 - scale["drain_s"]["device_busy_s"] / scale["wall_s"]
        check(all(v > 0 for v in launches.values()),
              f"both kernels launched on the main path: {launches}")
        log(f"[rest-scale] launches {launches} over {cohorts} cohorts, "
            f"mean cohort width {scale['mean_cohort_width']:.2f}")
        scale["plan_equal_to_cpu"] = phase_plan_cpu(node, lanes, bodies,
                                                    results, 1000)
        scale["trace"] = phase_scale_trace(node, port, lanes, bodies,
                                           args.clients)
        plan_burst = phase_plan_burst(node, port, lanes, bodies, results)
        plan_trace = phase_plan_trace(node, lanes, bodies, 1000)
    finally:
        node.close()

    # ---- 5. report
    meta = {
        "gather_bm25_contrib": dict(
            source="elasticsearch_tpu_torch/csrc/bm25_contrib.cu",
            replaces="elasticsearch_tpu/ops/pallas_bm25.py:36"),
        "merge_sorted_slots": dict(
            source="elasticsearch_tpu_torch/csrc/merge.cu",
            replaces="elasticsearch_tpu/ops/merge.py:65"),
    }
    rows = []
    for name, r in kern.items():
        if name == "cohort":
            continue
        rows.append(dict(
            name=name, route="cuda", **meta[name],
            launches=launches[name],
            launches_per_cohort=launches[name] / max(1, cohorts),
            max_abs_err=r["max_abs_err"], ms=r["ms"], kernel_ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            per_bucket=r.get("per_bucket")))
    print(json.dumps({"scale": scale}))
    print(json.dumps({"plan": dict(plan_trace, burst=plan_burst,
                                   small=plan_small)}))
    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    check(smi.returncode == 0, "nvidia-smi reads the card")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
