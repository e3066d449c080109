#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py                  # full size: 2M docs, 256 queries
    python3 chip_smoke.py --docs 200000    # a quicker rehearsal

Phases (any failure exits non-zero; no exception is swallowed):
  1. build    every hand-written CUDA kernel from elasticsearch_tpu_torch/csrc
  2. kernels  each kernel against its plain PyTorch twin at main-path shapes
              (a 32-query cohort at NB=4096, 16 slots, on the corpus), timed
  3. rest     a port Node on CUDA indexes ~2,000 generated docs through
              _bulk, refreshes, force-merges and answers 20 match queries over
              HTTP; ids, order and totals equal the float64 oracle
  4. scale    the seeded 2M-doc corpus installed as the index's one segment;
              concurrent size:1000 match queries over HTTP; recall@1000 = 1.0
              and exact totals against a float64 oracle; the launch counters
              of both kernels grow during this phase
  5. report   the kernels' JSON line, the card's name and power limit, and
              the last line {"ok": true, "device": {...}}

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
def phase_kernels(node, seg, queries, iters):
    import torch

    from elasticsearch_tpu_torch.ops.bm25_contrib import (
        gather_bm25_contrib, gather_bm25_contrib_plain)
    from elasticsearch_tpu_torch.ops.merge import (merge_sorted_slots,
                                                   merge_sorted_slots_plain)
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

    # ---- kernel 2: merge of the 16 docid-sorted slots, lane payload
    skeys = keys_k.view(q, N_SLOTS, p // N_SLOTS)
    lane = torch.arange(p, dtype=torch.int32, device=dev).repeat(q, 1) \
        .view(q, N_SLOTS, p // N_SLOTS)
    mk, mv = merge_sorted_slots(skeys, lane)
    pk, pv = merge_sorted_slots_plain(skeys, lane)
    lk, lv = torch.sort(keys_k, dim=1, stable=True)
    torch.cuda.synchronize()
    check(torch.equal(mk, pk) and torch.equal(mv, pv),
          "merge kernel keys and payload bit-equal to the stable sort")
    check(torch.equal(lk, pk) and torch.equal(lv.to(torch.int32), pv),
          "torch.sort agrees with the twin")
    # each (key, payload) pair read once and written once; a merge of
    # 16 runs needs at least log2(16) = 4 comparisons per element
    bytes2 = q * p * 16
    b2, by2 = bound_ms(bytes2, 4 * q * p, "int32")
    ms2, host2 = cuda_ms(lambda: merge_sorted_slots(skeys, lane), iters)
    out["merge_sorted_slots"] = dict(
        max_abs_err=float((mk.long() - pk.long()).abs().max()
                          + (mv.long() - pv.long()).abs().max()),
        ms=ms2, host_ms=host2,
        plain_ms=cuda_ms(lambda: merge_sorted_slots_plain(skeys, lane),
                         iters)[0],
        library_ms=cuda_ms(lambda: torch.sort(keys_k, dim=1, stable=True),
                           iters)[0],
        bound_ms=b2, bound_by=by2, bytes=bytes2)
    log(f"[kernels] merge bit-equal over [{q}, {p}]")
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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # the device rows only (the kernels); an operator row repeats the
    # time of the kernels it launched
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    total_us = sum(dev_us(e) for e in kernels)
    mine = {"gather_bm25_contrib": "gather_contrib_kernel",
            "merge_sorted_slots": ("chunk_stages", "global_stage",
                                   "flip_odd_slots")}
    share = {n: sum(dev_us(e) for e in kernels
                    if any(k in e.key for k in ((m,) if isinstance(m, str)
                                                else m))) / max(total_us, 1)
             for n, m in mine.items()}
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


# ---------------------------------------------------------------- phase 4
def phase_rest_scale(node, port, corpus, queries, clients, k):
    from elasticsearch_tpu_torch.corpus import exact_topk, term_name
    results = [None] * len(queries)
    lat = [0.0] * len(queries)
    nxt = [0]
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(queries):
                return
            body = {"query": {"match": {"title": " ".join(
                term_name(t) for t in queries[i])}}, "size": k}
            t0 = time.perf_counter()
            results[i] = http(port, "POST", "/bench/_search", body)
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
    misfits = 0
    served = []
    for i, (st, r) in enumerate(results):
        if st == 400 and r["error"]["type"] == \
                "unsupported_in_slice_exception":
            misfits += 1
            continue
        check(st == 200, f"scale query {i} -> {st} {r}")
        served.append(i)
    t_or = time.time()
    recalls = []
    for i in served:
        r = results[i][1]
        truth, _s, total = exact_topk(corpus, queries[i], k)
        got = {int(h["_id"]) for h in r["hits"]["hits"]}
        check(r["hits"]["total"] == {"value": total, "relation": "eq"},
              f"scale query {i} total {r['hits']['total']} vs {total}")
        check(len(r["hits"]["hits"]) == len(truth),
              f"scale query {i} hit count")
        recalls.append(len(got & set(truth.tolist())) / max(1, len(truth)))
    check(served and min(recalls) == 1.0,
          f"recall@{k} = 1.0 on every served query (min "
          f"{min(recalls) if recalls else None})")
    lat_ok = np.array([lat[i] for i in served]) * 1e3
    # qps counts the served queries only: a misfit's instant typed 400
    # does no device work
    res = dict(queries=len(queries), served=len(served), misfits=misfits,
               clients=clients, wall_s=wall, qps=len(served) / wall,
               p50_ms=float(np.percentile(lat_ok, 50)),
               p99_ms=float(np.percentile(lat_ok, 99)),
               recall_min=min(recalls), oracle_s=time.time() - t_or)
    log(f"[rest-scale] {res}")
    return res


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

        # ---- 3. REST, small
        for fn in counters.values():
            fn.launches = 0
        phase_rest_small(node, port, args.seed + 1)
        small = {n: fn.launches for n, fn in counters.items()}
        check(all(v > 0 for v in small.values()),
              f"both kernels launched in the small REST phase: {small}")

        # ---- 4. REST, at scale (the main path)
        fp = node.fastpath
        c0, q0 = fp.stats["cohorts"], fp.stats["fast_queries"]
        t_before = dict(fp.timing)
        for fn in counters.values():
            fn.launches = 0
        scale = phase_rest_scale(node, port, corpus, queries, args.clients,
                                 1000)
        launches = {n: fn.launches for n, fn in counters.items()}
        cohorts = fp.stats["cohorts"] - c0
        scale["cohorts"] = cohorts
        scale["mean_cohort_width"] = (fp.stats["fast_queries"] - q0) \
            / max(1, cohorts)
        # where the drain thread's time went, and the device's idle
        # share: 1 - the cohorts' device seconds (CUDA events around each
        # launch, so it is a lower bound on idle) / the phase's wall time
        scale["drain_s"] = {k: fp.timing[k] - t_before[k]
                            for k in fp.timing}
        scale["device_idle_share"] = \
            1.0 - scale["drain_s"]["device_busy_s"] / scale["wall_s"]
        check(all(v > 0 for v in launches.values()),
              f"both kernels launched on the main path: {launches}")
        log(f"[rest-scale] launches {launches} over {cohorts} cohorts, "
            f"mean cohort width {scale['mean_cohort_width']:.2f}")
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
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"scale": scale}))
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
