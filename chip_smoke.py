#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py                  # full size: 2M docs, 256 queries
    python3 chip_smoke.py --docs 200000 --knn-docs 1000000
                                           # a quicker rehearsal

The node serves through its C++ front (``Node.start``):
the scale bodies carry ``_source: false``, as the reference bench's do,
so the front parses them, resolves their term ids and hands them to the
fast path as arrays; the rest reaches the fallback workers.

Phases (any failure exits non-zero; no exception is swallowed):
  1. build    every hand-written CUDA kernel from elasticsearch_tpu_torch/csrc,
              and the C++ front from elasticsearch_tpu_torch/native/src
  2. kernels  each kernel against its plain PyTorch twin at main-path shapes
              (a 32-query cohort at NB=4096, 16 slots, on the corpus), timed;
              the merge also at NB=1024 and 2048 and on a tie-heavy cohort.
              One v1 cohort and one cohort of the v2 op (ported, serving
              nothing) at that shape (half of each reading a filter row)
              equal to the same launch on the CPU twins; each cohort (v2m,
              v1, v2) timed and traced. The θ-warm essential cohorts (Q = 32,
              one per bucket of 256 and 1024 essential blocks, as the
              binary-search op (ported, serving nothing) and as the dense
              op; splits from θ taken by full-lane launches), each equal to
              the same op on the plain contribution twin and, row by
              certified row, to the v1 lane's answer; each timed and
              traced beside the full lane the router gives the same queries
  3. rest     a port Node on CUDA indexes ~2,000 generated docs through
              _bulk, refreshes, force-merges and answers 20 match queries over
              HTTP, then bool+filter bodies (one to eight filters, an unknown filter
              term) on a fast lane; ids, order and totals equal the float64
              oracle. Then the plan path over HTTP on an index of two
              segments with a keyword and a long field: the reference's
              plan test bodies (bool, term, terms, constant_score,
              multi_match, dis_max, match options, range clauses as dense
              factors), a post_filter, a from > 0 and a size above 1000,
              each equal to the port's own CPU execution on the same
              segments
  4. scale    the seeded 2M-doc corpus installed as the index's one segment;
              (registered with the C++ front, timed) concurrent size:1000
              match queries over HTTP from Python clients, each parsed by
              the C++ front (its "fast" counter grows by every body; the
              plan-path ones bounce) and served by
              the v2m lane when its slot layout fits, by v1 when it needs at
              most the largest bucket, else by the plan path (no query is
              refused); totals exact against a float64 oracle, recall@1000 =
              1.0 on v2m and v1, and on the plan path every oracle top-k doc
              that is missing ties the kth score within float32 rounding
              (rtol 1e-5); the plan answers equal the port's CPU execution;
              each lane's kernels launch during this phase. Then the θ-warm
              pass: the same bodies again, each repeat the θ cache admits on
              the essential lane, every answer held to the oracle (recall
              1.0, exact "eq" totals). Then 64 of the fast-lane bodies
              with _source: true, which the C++ grammar refuses: through
              the fallback workers and the fast path's Python queue, each
              held to the oracle. Then throughput and latency from the
              C++ load generator (es_loadgen, 64 connections, each stepping
              through the bodies round-robin, as the reference bench
              drives it): the 256 bodies once cold (θ emptied), then
              θ-warm (two rounds to warm, then 12 rounds measured), every
              request done with 2xx, every bounce a plan-path body the
              plan path answered. Then (at size 999, which no θ licenses,
              under the load generator): the v2m-served queries alone
              (two rounds to warm, 12 measured), and all of them
              again under torch.profiler with each lane's cohort launches
              named (each lane's device seconds, the card's idle share); the
              queries no v2m cohort takes, asked of the plan path all at once
              (the cohorts they form, the lanes and memory in flight, each
              answer equal to the CPU execution), and the cohorts the
              PlanBatcher forms from them, traced; the reference bench's
              bool+filters mix (64 bodies with two filters each, 8 times
              over, each on a fast lane unless its query needs more than the
              largest bucket, exact against the filtered oracle; then the
              8 rounds again from the load generator). The plan
              path under track_total_hits: 10000 (phase 3's bodies, the
              misfits, and an index of the corpus as time-ordered logs
              around an incident, where pruning must engage): the hits of
              the exact ask, which holds the oracle; the binds that pruned
  5. dense    the logs index with access-log columns (corpus.py
              logs_columns: @timestamp over 24 h in docid order, status,
              bytes) and the dense mix over HTTP after Rally's http_logs
              operations: 1-hour ranges, Kibana Discover's filtered
              @timestamp desc sort (size 500), asc_sort_timestamp and 5
              pages of desc_sort_with_after_timestamp, a term on status
              under an incident match (a dense factor on the plan path),
              64 match + range bodies, exists, a must_not-only bool,
              boosting, dis_max with a range child, ids, match_all sorted
              by bytes, min_score. No body refused; each answer held to a
              float64 oracle under the reference's float32 column
              semantics and at least 16 to the port's CPU execution at full
              size; the contribution kernel launches on the dense path.
              Then timed from Python clients (p50/p99 per kind, qps), the
              dense executor's stages (score, mask, masked_topk, readback),
              the plan path beside the dense executor on the match + range
              bodies, the float32 gap (f32_gap) and the contribution kernel
              against its twin at the dense shape (Q = 1)
  6. knn      config 4: an index of 8M seeded 768-d unit vectors
              (cosine) installed through segment_from_numpy, its bfloat16
              slab built on the card; 16 pure kNN bodies (k 1000,
              num_candidates 3000, size 1000, _source: false) over HTTP
              through the KnnBatcher, each held to a float64 brute-force
              oracle (a missing oracle doc ties the 1000th score within
              rtol 1e-5; every score the exact float32 formula, rtol
              1e-6; order score desc then docid; total min(k, docs));
              one in-process cohort of 16 callers equal to the same
              queries launched alone; the nomination's device ms at
              Q = 1, 8, 32 by stage against its byte and tensor-core
              bounds; the host re-rank; the C++ load generator at 8
              connections over the bodies x 4. Config 5: the scale
              corpus with 256-d vectors as the index "hybrid": 32
              rank.rrf bodies (match + knn, k 1000, num_candidates 1500,
              size 1000), each the fusion of the port's own answers to
              its branches asked apart (the branches held to their
              oracles); merged-hybrid, filtered-knn, _source: true and
              exists bodies equal to the port's CPU execution, the
              contribution kernel launching on the merged ones; the rrf
              bodies from the load generator. The index also carries the
              reference bench's "feat" column (corpus.py bench_feat)
  7. script   config 3 on the index "hybrid": 32 script_score bodies of
              the reference bench's row (match + doc['feat'].value * 0.5
              + _score, size 1000) ride the plan launch, each equal to
              the port's CPU execution and within the recall rule of a
              float64 oracle; 16 cosineSimilarity + 1.0 + _score bodies
              on the dense executor held to a float64 oracle over the
              slab's bfloat16 values; function_score, min_score and
              rescore bodies equal to the CPU; a statement script is a
              400 at 2M docs and equals the CPU on phase 3's index; the
              bench bodies from the load generator; one plan cohort at
              Q = 1, 8, 32 timed with and without the script
  8. aggs     the reference bench's match+terms-agg row on "hybrid" (its
              segment carries the bench's skewed 500-term ``cat`` keyword
              column, corpus.py bench_cat): 32 bodies (match, size 0,
              terms on cat) over HTTP, each equal to a float64 oracle
              (exact per-category counts of the matched docs) and to the
              port's CPU execution; then a Kibana-style mix on "logs":
              a 30-minute date_histogram with avg/sum/max of bytes (the
              device scatter), stats under a 1-hour range (one fused
              launch), a histogram of bytes, numeric terms on status,
              percentiles and cardinality, filters 4xx/5xx, range on
              bytes, a calendar_interval hour histogram, a histogram
              with a terms sub-agg and extended_stats (the host), a
              post_filter body and a global body, each held to its
              float64 oracle under the reference's float32 column
              semantics (counts, keys, min and max exact; sums rtol
              1e-4) and to the CPU execution. Each collector of
              ops/aggs.py and the contribution kernel launch in the
              phase. Then each collector's device ms at 2M docs against
              its byte bound, the agg mask's readback and re-upload,
              the host bucket-id arithmetic, and the bench bodies from
              the load generator (64 connections, a warm round, then 4)
  9. accounting  the main node runs under an explicit hbm breaker limit
              (0.75 of the card, printed; the reference's 4 GiB default
              would refuse config 4's slab), and after every phase the
              breaker holds exactly the resident segments' bytes. Every
              DeviceSegment built on the card in the run added its
              hbm_bytes() to the allocator's requested bytes, and to
              memory_allocated() within the allocator's rounding (512 B
              a tensor, plus at most 1 MiB for a large tensor handed an
              unsplit cached block); so does each lazy build (a filter
              mask, an ord-major permutation). A second node holds four 2M-doc
              indices under a limit of 2.5 segments: 32 plan bodies equal
              the CPU execution, with the admissions and evictions of an
              LRU of two, and a segment evicted while the fast path
              holds its registration returns its memory; a node whose
              limit is below one segment answers 429 with bytes_wanted
              the segment's bytes and still serves an index that fits.
              Over fast-path, plan, dense, kNN and aggs bodies:
              /_kernels calls equal both kernels' .launches, the flight
              recorder holds one event per tracked call and per funnel
              readback, and profile: true answers the same hits with
              the kernels it launched and device + host == total
              nanos. Printed: the host us of a tracked call against
              the bare call at the v2m cohort's shape, of one flight
              event, and the drain's launch-to-readback ms a cohort
 10. report   the scale, lanes, theta_warm, prune, dense, knn, hybrid,
              script, aggs, accounting, filters, plan and kernels JSON
              lines, the card's name and power limit, and the last line
              {"ok": true, "device": {...}}

Needs one CUDA card, and the repository around it.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
from collections import Counter
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
    sel, ws = fp.assemble_cohort(reg, bucket, cohort)
    mids = np.zeros(Q_BATCH, np.int32)
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
            sel_b, ws_b = fp.assemble_cohort(reg, b, fit)
            keys_b = gather_bm25_contrib(
                dp.block_docids, dp.block_tfs,
                torch.from_numpy(sel_b).to(dev),
                torch.from_numpy(ws_b).to(dev), dp.doc_lens, masks,
                mids_t, avg64, 1.2, 0.75)[0]
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
    from elasticsearch_tpu_torch.ops.fastpath import \
        bm25_topk_total_merge_batch

    out["cohort"] = trace_cohort("v2m", lambda: bm25_topk_total_merge_batch(
        dp.block_docids, dp.block_tfs, sel_t, ws64, dp.doc_lens, masks,
        mids_t, dp.avg_len, N_SLOTS, 1.2, 0.75, MAX_K))
    return out


def trace_cohort(lane, launch, reps=3):
    """One cohort launch of ``lane``: device ms by CUDA events, and
    traced with torch.profiler: device ms, each hand-written kernel's
    share of it and the top operator rows (the table goes to stderr)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ms, _ = cuda_ms(launch, 5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = kernel_rows(events)
    total_us = sum(self_dev(e) for e in kernels)
    mine = {"gather_bm25_contrib": "gather_contrib_kernel",
            "merge_sorted_slots": "merge_path_round"}
    share = {n: sum(self_dev(e) for e in kernels if m in e.key)
             / max(total_us, 1) for n, m in mine.items()}
    ops = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and self_dev(e) > 0), key=self_dev, reverse=True)
    log(f"[cohort] {lane}: device time of one cohort launch by kernel "
        f"({reps} launches traced):")
    log(events.table(sort_by="self_cuda_time_total", row_limit=14))
    res = dict(ms=ms, traced_device_ms=total_us / reps / 1e3,
               kernel_share=share,
               top_ops={e.key: self_dev(e) / max(total_us, 1)
                        for e in ops[:6]})
    log(f"[cohort] {lane}: {ms:.3f} ms per cohort launch (events); traced "
        f"{res['traced_device_ms']:.3f} ms; shares {share}")
    return res


def phase_lane_cohorts(node, seg, queries, filt_pool):
    """One v1 cohort and one cohort of the v2 op at the main path's shape
    (Q = 32, NB = 4096 blocks, on the corpus), each equal to the same
    launch on the CPU, where the wrappers run the kernels' twins: ids,
    order, totals and v2's certificate exact, scores within rtol 1e-6;
    half of each cohort reads a filter row of the mask stack. Each timed
    and traced. The v1 cohort holds the queries the router sends to v1
    (slot misfits), topped up with others that fit the bucket; the v2
    op, which no lane serves, takes 32 queries that fit the slots."""
    import torch

    from elasticsearch_tpu_torch.index.segment import BLOCK_SIZE
    from elasticsearch_tpu_torch.ops.fastpath import (
        MAX_T, bm25_candidates_rerank_batch, bm25_topk_total_batch)
    from elasticsearch_tpu_torch.search.fastpath import (MAX_K,
                                                         NB_BUCKETS,
                                                         N_SLOTS, Q_BATCH)
    fp = node.serving_lane()
    reg = fp.register("bench", seg, "title", 1.2, 0.75)
    bucket = NB_BUCKETS[-1]
    routes = [fp.route(reg, q) for q in queries]
    v1q = [q for q, r in zip(queries, routes) if r == ("v1", bucket)]
    v1q += [q for q, r in zip(queries, routes)
            if r is not None and r[0] == "v2m"][:Q_BATCH - len(v1q)]
    v2q = [q for q, r in zip(queries, routes)
           if r is not None and r[0] == "v2m"][:Q_BATCH]
    check(len(v1q) == len(v2q) == Q_BATCH, "32 queries for each cohort")
    filt = tuple(sorted(int(t) for t in filt_pool[:2]))
    row = fp._resolve_mask_rows(reg, {filt})[filt]
    mids = np.where(np.arange(Q_BATCH) % 2 == 1, row, 0).astype(np.int32)
    dp = reg["dp"]
    cpu = torch.device("cpu")
    # the v2 op's flat postings are views of the resident block arrays
    # (a term's blocks are consecutive and full but the last)
    flat = (dp.block_docids.view(-1), dp.block_tfs.view(-1))
    on = {fp.device: (dp.block_docids, dp.block_tfs, *flat, dp.doc_lens,
                      reg["masks"]),
          cpu: tuple(t.cpu() for t in (
              dp.block_docids, dp.block_tfs, *flat, dp.doc_lens,
              reg["masks"]))}
    # v2's term-instance table: flat posting start and length, idf
    ts = np.zeros((Q_BATCH, MAX_T), np.int32)
    tl = np.zeros((Q_BATCH, MAX_T), np.int32)
    ti = np.zeros((Q_BATCH, MAX_T), np.float64)
    for qi, q in enumerate(v2q):
        known = [t for t in q if t >= 0]
        ts[qi, :len(known)] = reg["starts"][known] * BLOCK_SIZE
        tl[qi, :len(known)] = dp.doc_freq[known]
        ti[qi, :len(known)] = reg["idf"][known]

    def v1(dev):
        sel, ws = fp.assemble_cohort(reg, bucket, v1q, slotted=False)
        bd, bt, _, _, dl, masks = on[dev]
        sel, ws, m = (torch.from_numpy(a).to(dev) for a in (sel, ws, mids))
        args = (bd, bt, sel, ws, dl, masks, m, dp.avg_len, 1.2, 0.75, MAX_K)
        return lambda: bm25_topk_total_batch(*args)

    def v2(dev):
        sel, ws = fp.assemble_cohort(reg, bucket, v2q)
        bd, bt, fd, ft, dl, masks = on[dev]
        sel, ws, ts_, tl_, ti_, m = (torch.from_numpy(a).to(dev) for a in (
            sel, ws, ts, tl, ti, mids))
        args = (bd, bt, fd, ft, sel, ws.to(torch.float32), dl, masks, m,
                ts_, tl_, ti_, dp.avg_len, N_SLOTS, 1.2, 0.75, MAX_K)
        return lambda: bm25_candidates_rerank_batch(*args)

    out = {}
    for lane, make, exact in (("v1", v1, 2 * MAX_K + 1),
                              ("v2", v2, 2 * MAX_K + 2)):
        launch = make(fp.device)
        got = launch().cpu().numpy()
        want = make(cpu)().numpy()
        check(np.array_equal(got[:, MAX_K:exact], want[:, MAX_K:exact]),
              f"{lane} cohort on the card: ids, order, totals (and ok) "
              f"equal to its CPU twin")
        check(np.allclose(got[:, :MAX_K], want[:, :MAX_K], rtol=1e-6,
                          atol=0, equal_nan=True),
              f"{lane} cohort on the card: scores within rtol 1e-6 of "
              f"its CPU twin")
        out[lane] = dict(trace_cohort(lane, launch), q=Q_BATCH, nb=bucket,
                         filtered_rows=int((mids > 0).sum()),
                         totals_sum=int(got[:, 2 * MAX_K].sum()))
        if lane == "v2":
            out[lane]["certified_rows"] = int(got[:, 2 * MAX_K + 1].sum())
    out["v1"]["misfits"] = sum(1 for r in routes if r == ("v1", bucket))
    log(f"[lanes] {out}")
    return out


def phase_registration(node, seg):
    """The fast path's registration of the corpus, wall seconds: the
    segment's upload to the card; the first registration, which builds
    what the postings alone decide (each term's bound, the hot-term tf
    table) once per resident postings; a rebuild, as after a delete (a
    new live mask), which keeps those and makes only the θ cache and the
    mask stack (both on a server of their own, so the node's drain does
    not race them); then, with ``seg`` installed as the "bench" index's
    one segment, the node's registration with the C++ front, whose term
    dictionary and external ids are laid out and copied into C++."""
    import torch

    from elasticsearch_tpu_torch.search.fastpath import FastPathServer
    fp = FastPathServer(node.device, node.device_cache)
    t0 = time.perf_counter()
    node.device_cache.get(seg)
    torch.cuda.synchronize()
    upload = time.perf_counter() - t0
    t0 = time.perf_counter()
    reg = fp.register("bench", seg, "title", 1.2, 0.75)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    fp._regs.pop("bench")
    t0 = time.perf_counter()
    again = fp.register("bench", seg, "title", 1.2, 0.75)
    torch.cuda.synchronize()
    rebuild = time.perf_counter() - t0
    check(again["dense_tf"] is reg["dense_tf"]
          and again["maxc"] is reg["maxc"],
          "a rebuilt registration keeps the postings' derived tables")
    served = node.fastpath
    f0 = served.timing["front_register_s"]
    n0 = served.stats["front_registrations"]
    node.indices["bench"].engine.install_segments([seg])
    t0 = time.perf_counter()
    node.refresh_front()
    front_s = time.perf_counter() - t0
    front = served.front_registration()
    check(front is not None and front["segment"] is seg
          and served.stats["front_registrations"] == n0 + 1,
          "the C++ front holds the bench index's registration")
    dense = reg["dense_tf"]
    out = dict(upload_s=upload, first_s=first, rebuild_s=rebuild,
               front_register_s=served.timing["front_register_s"] - f0,
               front_refresh_s=front_s,
               front_terms=len(front["dp"].host.terms),
               front_ids=seg.n_docs,
               dense_rows=len(reg["dense_rows"]),
               dense_dtype=None if dense is None else str(dense.dtype),
               dense_bytes=0 if dense is None
               else dense.numel() * dense.element_size())
    log(f"[registration] {out}")
    return out


def phase_essential_cohorts(node, seg, queries):
    """The θ-warm essential cohorts at Q = 32 on the corpus, one per
    ESS_BUCKETS bucket, each launched as the binary-search op (ported,
    serving nothing) and as the dense op (the lane's). θ and the totals
    come from full-lane launches (the v1 op at the largest bucket on
    every query that fits it, stored as the serving front stores them);
    the splits are ``_essential_split``'s on a private copy of the
    registration (the serving θ stays cold for phase 4); it admits only
    splits with a hot-term row for every non-essential term, and counts
    the others (``no_dense``). A cohort holds the queries whose split
    lands in its bucket first, then smaller ones. Each launch equals the
    same op with the plain contribution twin on the card (packed rows
    bit-equal: ids, order, ok flags, float64-ranked values), and each
    certified row equals the v1 answer of its query (ids and order
    exact, values within one float32 ulp, rtol 2^-23: the float64 sums
    take another association). Each timed and traced, beside the full
    lanes the router gives the same queries (``full``: v2m at the
    query's own bucket, or v1, grouped as ``_merge_up`` groups them), the
    launches an essential cohort replaces."""
    import torch

    from elasticsearch_tpu_torch.index.segment import BLOCK_SIZE
    from elasticsearch_tpu_torch.ops import fastpath as ops_fp
    from elasticsearch_tpu_torch.ops.bm25_contrib import \
        gather_bm25_contrib_plain
    from elasticsearch_tpu_torch.search.fastpath import (ESS_BUCKETS, MAX_K,
                                                         N_SLOTS, NB_BUCKETS,
                                                         NE_SLOTS, Q_BATCH,
                                                         SCORE_DTYPE,
                                                         _Pending)
    fp = node.serving_lane()
    reg = fp.register("bench", seg, "title", 1.2, 0.75)
    dp, dev = reg["dp"], fp.device

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    zero_mids = torch.zeros(Q_BATCH, dtype=torch.int32, device=dev)
    args = (dp.block_docids, dp.block_tfs)
    tail = (dp.doc_lens, reg["masks"], zero_mids)
    full = [q for q in dict.fromkeys(tuple(q) for q in queries)
            if fp.route(reg, list(q)) not in (None, ("empty", None))]
    v1_rows = {}
    for lo in range(0, len(full), Q_BATCH):
        chunk = full[lo:lo + Q_BATCH]
        sel, ws = fp.assemble_cohort(reg, NB_BUCKETS[-1], chunk,
                                     slotted=False)
        out = ops_fp.bm25_topk_total_batch(
            *args, up(sel), up(ws), *tail, dp.avg_len, 1.2, 0.75, MAX_K,
            score_dtype=SCORE_DTYPE).cpu().numpy()
        v1_rows.update(zip(chunk, out))
    private = dict(reg, theta={}, ess_bad=set())
    for q, row in v1_rows.items():
        vals = row[:MAX_K]
        if np.isfinite(vals).all():
            private["theta"][(q, (), MAX_K)] = (float(vals.min()),
                                                int(row[2 * MAX_K]))
    no_dense0 = fp.stats["ess_no_dense"]
    splits = {}
    for q in full:
        known = [t for t in q if t >= 0]
        s = fp._essential_split(private, _Pending(private, list(q), (),
                                                  MAX_K, "v2m", None),
                                int(reg["nb"][known].sum()))
        if s is not None:
            splits[q] = s
    out = dict(
        full_lane_queries=len(full), with_theta=len(private["theta"]),
        admitted=len(splits),
        no_dense=fp.stats["ess_no_dense"] - no_dense0,
        admitted_per_bucket={b: sum(1 for s in splits.values() if s[0] == b)
                             for b in ESS_BUCKETS},
        mean_ess_blocks=float(np.mean([int(reg["nb"][s[1]].sum())
                                       for s in splits.values()]))
        if splits else None,
        mean_full_blocks=float(np.mean([int(reg["nb"][list(q)].sum())
                                        for q in splits])) if splits else None,
        full_routes={f"{lane}:{b}": n for (lane, b), n in Counter(
            fp.route(reg, list(q)) for q in splits).items()})
    for bucket in ESS_BUCKETS:
        fit = [q for q, s in splits.items() if s[0] <= bucket]
        fit.sort(key=lambda q: splits[q][0] != bucket)
        cohort = fit[:Q_BATCH]
        check(cohort, f"admitted essential queries for bucket {bucket}")
        sel, ws, nr, ni, nbound = fp.assemble_essential(
            reg, bucket, [splits[q] for q in cohort])
        # the binary-search op's inputs: each non-essential term's flat
        # posting range (its postings fill the first df lanes of its
        # blocks)
        ns = np.zeros((Q_BATCH, NE_SLOTS), np.int32)
        nl = np.zeros((Q_BATCH, NE_SLOTS), np.int32)
        for qi, q in enumerate(cohort):
            for i, t in enumerate(splits[q][2]):
                ns[qi, i] = reg["starts"][t] * BLOCK_SIZE
                nl[qi, i] = reg["df"][t]

        def launcher(op, sel=sel, ws=ws, ns=ns, nl=nl, nr=nr, ni=ni,
                     nbound=nbound):
            sel_t, ws_t, nb_t, ni_t = up(sel), up(ws), up(nbound), up(ni)
            if op == "binary":
                ns_t, nl_t = up(ns), up(nl)
                return lambda: ops_fp.bm25_essential_topk_batch(
                    *args, dp.block_docids.view(-1), dp.block_tfs.view(-1),
                    sel_t, ws_t, *tail, ns_t, nl_t, ni_t, nb_t, dp.avg_len,
                    1.2, 0.75, MAX_K, score_dtype=SCORE_DTYPE)
            nr_t = up(nr)
            return lambda: ops_fp.bm25_essential_dense_topk_batch(
                *args, reg["dense_tf"], sel_t, ws_t, *tail, nr_t, ni_t,
                nb_t, dp.avg_len, 1.2, 0.75, MAX_K, score_dtype=SCORE_DTYPE)

        for op in ("binary", "dense"):
            launch = launcher(op)
            got = launch().cpu().numpy()
            kernel = ops_fp.gather_bm25_contrib
            ops_fp.gather_bm25_contrib = gather_bm25_contrib_plain
            try:
                want = launch().cpu().numpy()
            finally:
                ops_fp.gather_bm25_contrib = kernel
            what = f"essential {op} cohort at {bucket} blocks"
            check(np.array_equal(got, want, equal_nan=True),
                  f"{what}: packed rows bit-equal to the plain twin's")
            n = len(cohort)
            ok = got[:n, 2 * MAX_K] == 1.0
            for i in np.nonzero(ok)[0]:
                ref = v1_rows[cohort[i]]
                check(np.array_equal(got[i, MAX_K:2 * MAX_K],
                                     ref[MAX_K:2 * MAX_K])
                      and np.allclose(got[i, :MAX_K], ref[:MAX_K],
                                      rtol=2.0 ** -23, atol=0),
                      f"{what}: certified row {i} equals the v1 answer")
            out[f"{op}{bucket}"] = dict(
                trace_cohort(f"ess {op} {bucket}", launch), q=n,
                nb=bucket, certified=int(ok.sum()),
                ess_blocks=[int(reg["nb"][splits[q][1]].sum())
                            for q in cohort])
        # the full-lane launches the router gives the same queries
        groups: dict = {}
        for q in cohort:
            lane, b = fp.route(reg, list(q))
            groups.setdefault(lane, {}).setdefault(b, []).append(q)
        launches = []
        for lane, by_b in groups.items():
            for b, group in fp._merge_up(by_b).items():
                gsel, gws = fp.assemble_cohort(reg, b, group,
                                               slotted=lane == "v2m")
                gsel_t, gws_t = up(gsel), up(gws)
                if lane == "v2m":
                    fn = (lambda s_=gsel_t, w_=gws_t:
                          ops_fp.bm25_topk_total_merge_batch(
                              *args, s_, w_, *tail, dp.avg_len, N_SLOTS,
                              1.2, 0.75, MAX_K, score_dtype=SCORE_DTYPE))
                else:
                    fn = (lambda s_=gsel_t, w_=gws_t:
                          ops_fp.bm25_topk_total_batch(
                              *args, s_, w_, *tail, dp.avg_len, 1.2, 0.75,
                              MAX_K, score_dtype=SCORE_DTYPE))
                launches.append(dict(
                    trace_cohort(f"full {lane} {b} (ess {bucket})", fn),
                    lane=lane, nb=b, q=len(group)))
        full_ms = sum(r["ms"] for r in launches)
        full_traced = sum(r["traced_device_ms"] for r in launches)
        out[f"full{bucket}"] = dict(ms=full_ms, traced_device_ms=full_traced,
                                    launches=launches)
        for op in ("binary", "dense"):
            r = out[f"{op}{bucket}"]
            r["traced_vs_full"] = (r["traced_device_ms"] / full_traced
                                   if full_traced else None)
    log(f"[ess] {out}")
    return out


# ---------------------------------------------------------------- phase 3
def phase_rest_small(node, port, seed):
    """A ~2,000-doc index over HTTP; the 20 match queries, then
    bool+filter bodies of the fast grammar (one filter, two to eight, an unknown filter term), each
    equal to the float64 oracle (with the filters applied) and served
    by a fast lane."""
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

    def ask(body, terms, filters, size, what):
        st, r = http(port, "POST", "/small/_search", body)
        check(st == 200, f"{what} -> {st} {r}")
        pl = [post.get(t, ([], [])) for t in terms]
        idfs = [np.log(1 + (n_docs - len(p[0]) + 0.5) / (len(p[0]) + 0.5))
                for p in pl]
        scores = bm25_reference_scores(pl, idfs, lens, avg, 1.2, 0.75)
        for f in filters:
            keep = np.zeros(n_docs, bool)
            keep[post.get(f, ([], []))[0]] = True
            scores[~keep] = 0.0
        matched = np.nonzero(scores > 0)[0]
        top = matched[np.lexsort((matched, -scores[matched]))][:size]
        # the served order is (reported float32 score desc, docid asc)
        top = top[np.lexsort((top, -scores[top].astype(np.float32)))]
        got = [int(h["_id"]) for h in r["hits"]["hits"]]
        check(r["hits"]["total"] == {"value": len(matched),
                                     "relation": "eq"},
              f"{what}: total {r['hits']['total']} vs {len(matched)}")
        check(got == top.tolist(), f"{what}: ids/order")
        got_s = np.array([h["_score"] for h in r["hits"]["hits"]])
        check(np.allclose(got_s, scores[top], rtol=1e-6, atol=0),
              f"{what}: scores")
        return len(matched)

    fp = node.fastpath
    queries = []
    for _ in range(20):
        queries.append((sorted({int(t) for t in rng.choice(
            len(vocab), size=int(rng.integers(1, 5)), p=zipf)}),
            int(rng.choice([10, 50, 200]))))
    out = {}
    d0 = fp.serving_stats()["dispatch"]
    for qi, (terms, size) in enumerate(queries):
        ask({"query": {"match": {"body": " ".join(
            vocab[t] for t in terms)}}, "size": size}, terms, (), size,
            f"small query {qi}")
    out["match"] = dispatched_since(fp, d0)
    check(sum(out["match"].values()) == len(queries),
          f"every small query on a fast lane {out['match']}")

    # bool + filter bodies of the fast grammar: the filters are the
    # commonest terms of a doc with at least nine distinct terms, and the
    # must clause holds another of its terms, so the doc matches
    wide = [d for d in range(n_docs) if len(set(docs[d])) >= 9]
    bodies = []
    for i, nf in enumerate((1, 2, 3, 5, 8, 1)):
        held = sorted({int(t) for t in docs[wide[i]]},
                      key=lambda t: -len(post[t][0]))
        filters = held[:nf]
        terms = sorted(set(queries[i][0]) | {held[nf]})
        names = [vocab[f] for f in filters]
        if i == 5:          # an unknown filter term: nothing matches
            names = names[:1] + ["nosuchterm"]
            filters = filters[:1] + [-1]
        flt = ({"match": {"body": names[0]}} if nf == 1 and i == 0 else
               [{"match": {"body": n}} for n in names])
        bodies.append(({"query": {"bool": {
            "must": [{"match": {"body": " ".join(vocab[t]
                                                 for t in terms)}}],
            "filter": flt}}, "size": 100, "_source": False},
            terms, filters))
    d0 = fp.serving_stats()["dispatch"]
    plan0 = node.search_service.plan_batcher.launches
    totals = [ask(b, terms, filters, 100, f"small filter body {i}")
              for i, (b, terms, filters) in enumerate(bodies)]
    check(totals[-1] == 0 and all(t > 0 for t in totals[:-1]),
          f"filter totals {totals}: the unknown filter term matches none")
    out["filters"] = dispatched_since(fp, d0)
    check(sum(out["filters"].values()) == len(bodies)
          and node.search_service.plan_batcher.launches == plan0,
          f"every filter body on a fast lane {out['filters']}")
    out["filter_totals"] = totals
    log(f"[rest-small] {n_docs} docs: 20 queries and "
        f"{len(bodies)} filter bodies equal to the oracle: {out}")
    return out


def dispatched_since(fp, before):
    """Queries each lane:bucket took since ``before`` (a dispatch map)."""
    now = fp.serving_stats()["dispatch"]
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v > before.get(k, 0)}


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
    tag keyword; views long), each answer held against the port's CPU
    execution."""
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
    # the range cases put a dense factor into the plan launch, which
    # launches alone (no PlanBatcher cohort)
    bodies = [{"query": c, "size": 50} for c in PLAN_CASES]
    n_dense = sum("range" in json.dumps(c) for c in PLAN_CASES)
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
    out = dict(docs=n_docs, segments=len(segments), bodies=len(bodies),
               dense_factor_bodies=n_dense,
               plan_launches=batcher.launches - launches0)
    check(out["plan_launches"] >= len(bodies) - n_dense, "plan launches")
    log(f"[plan-small] {out}: every answer equal to the CPU execution")
    return out, bodies


# ---------------------------------------------------------------- phase 4
def drive(port, bodies, clients, index="bench"):
    """``bodies`` as _search requests to /``index`` from ``clients``
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
            results[i] = http(port, "POST", f"/{index}/_search", bodies[i])
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


def front_since(node, before):
    """The C++ front's request counters (and the drain's bounces) since
    ``before`` (``Node.http_stats``)."""
    now = node.http_stats()
    return {k: now[k] - before[k]
            for k in ("requests", "fast", "fallback", "bounced",
                      "bounced_stale", "front_registrations")}


def loadgen_pass(node, port, bodies, lanes, conns, reps=1, warmup=0):
    """``bodies`` (each of the C++ grammar; ``lanes``: the lane each is
    routed to) sent ``reps`` times over from ``conns`` keep-alive
    connections by the front's C++ load generator (off the GIL, in this
    process), after ``warmup`` rounds that are not measured. Each
    connection steps through the bodies round-robin from its own start,
    so how often each body goes out depends on the timing. Every request
    must be done and answered 2xx, parsed by the front, and bounced to
    the plan path only if its body is a plan-path body: the plan path
    must have answered exactly the bounces (those not parsed under a
    stale registration, which REST sends to the fast path), each a
    plan-path body. Reports qps over the wall seconds of the measured
    window, p50/p99, the front's counters, the drain thread's stage
    seconds and the card's idle share (1 - the fast cohorts'
    CUDA-event seconds / wall)."""
    from elasticsearch_tpu_torch.rest.native_http import loadgen

    def run(total):
        res = loadgen(port, "/bench/_search", bodies, conns, total)
        check(res["done"] == total and res["non2xx"] == 0,
              f"the load generator's {total} requests all done with 2xx: "
              f"{res['done']} done, {res['non2xx']} not 2xx")
        return res

    if warmup:
        run(len(bodies) * warmup)
    fp = node.fastpath
    service = node.search_service
    plan_queries = {json.dumps(b["query"], sort_keys=True)
                    for b, lane in zip(bodies, lanes) if lane == "plan"}
    planned = []

    def recorded(index, svc, body):
        planned.append(json.dumps(body.get("query"), sort_keys=True))
        return type(service).search(service, index, svc, body)

    total = len(bodies) * reps
    h0, t0, s0 = node.http_stats(), dict(fp.timing), dict(fp.stats)
    d0 = fp.serving_stats()["dispatch"]
    service.search = recorded
    try:
        res = run(total)
    finally:
        del service.search
    front = front_since(node, h0)
    check(front["fast"] == total,
          f"the C++ front parsed all {total} bodies: {front}")
    check(len(planned) == front["bounced"] - front["bounced_stale"]
          and set(planned) <= plan_queries,
          f"the plan path answered the bounces alone, each a plan-path "
          f"body: {len(planned)} plan answers, "
          f"{len(set(planned) - plan_queries)} of other bodies, {front}")
    drain = {k: fp.timing[k] - t0[k] for k in fp.timing}
    cohorts = fp.stats["cohorts"] - s0["cohorts"]
    check(fp.stats["cohorts_failed"] == s0["cohorts_failed"],
          "no cohort failed under the load generator")
    p50, p99 = p50_p99(res["lat_s"])
    return dict(requests=total, warmup_requests=len(bodies) * warmup,
                conns=conns, wall_s=res["wall_s"],
                qps=total / res["wall_s"], p50_ms=p50, p99_ms=p99,
                plan_requests=len(planned),
                front=front, dispatch=dispatched_since(fp, d0),
                cohorts=cohorts,
                mean_cohort_width=(fp.stats["fast_queries"]
                                   - s0["fast_queries"]) / max(1, cohorts),
                ess_queries=fp.stats["ess_queries"] - s0["ess_queries"],
                drain_s=drain, device_busy_s=drain["device_busy_s"],
                idle_share=1.0 - drain["device_busy_s"] / res["wall_s"])


def phase_loadgen(node, port, bodies, lanes, conns):
    """The scale phase's bodies under the C++ load generator: a cold
    round (the θ cache emptied first, as on a fresh registration; a
    second round would already be warm) and a θ-warm pass (two rounds
    to warm, then 12 measured, as the reference bench measures). Answers
    are held to the oracle in the passes driven by Python clients; these
    measure."""
    reg = node.fastpath.front_registration()
    check(reg is not None and reg["index"] == "bench",
          "the C++ front serves the bench index")
    reg["theta"].clear()
    reg["ess_bad"].clear()
    out = dict(cold=loadgen_pass(node, port, bodies, lanes, conns),
               warm=loadgen_pass(node, port, bodies, lanes, conns, reps=12,
                                 warmup=2))
    check(out["warm"]["ess_queries"] > 0,
          "the warm load rode the essential lane")
    log(f"[loadgen] {out}")
    return out


def phase_source_true(node, port, queries, oracles, lanes, clients):
    """Bodies the C++ grammar refuses (``_source: true``) for the queries
    a fast lane serves: each goes to the fallback workers, whose REST
    layer puts it on the fast path's Python queue (the drain takes it
    beside the front's arrays); every answer against the float64
    oracle. Sent twice: as served, where ``submit`` wakes the drain from
    its poll of the front, and with that wake taken out, where the drain
    waits out its poll (``POLL_MS``) first."""
    from elasticsearch_tpu_torch.rest.native_http import NativeHttpFront
    out = source_true_pass(node, port, queries, oracles, lanes, clients)
    wake = NativeHttpFront.wake
    NativeHttpFront.wake = lambda self: None
    try:
        out["no_wake"] = source_true_pass(node, port, queries, oracles,
                                          lanes, clients)
    finally:
        NativeHttpFront.wake = wake
    log(f"[source-true] {out}")
    return out


def source_true_pass(node, port, queries, oracles, lanes, clients):
    fp = node.fastpath
    idx = [i for i, lane in enumerate(lanes) if lane != "plan"][:64]
    bodies = [match_body(queries[i], 1000, source=True) for i in idx]
    h0, r0 = node.http_stats(), fp.stats["ess_refires"]
    d0 = fp.serving_stats()["dispatch"]
    results, lat, wall = drive(port, bodies, clients)
    front = front_since(node, h0)
    check(front["fast"] == 0 and front["fallback"] == len(bodies),
          f"every _source: true body went to the fallback: {front}")
    # the dispatch is counted before a cohort launches, so before its
    # answers; a refired essential row is dispatched twice
    served = sum(dispatched_since(fp, d0).values())
    check(served - (fp.stats["ess_refires"] - r0) == len(bodies),
          f"every _source: true body was served on the fast path "
          f"({served} dispatched)")
    for j, (i, (st, r)) in enumerate(zip(idx, results)):
        check(st == 200, f"_source body {j} -> {st} {r}")
        check_answer(r, oracles[i], lanes[i], f"_source body {j}")
    p50, p99 = p50_p99(lat)
    return dict(bodies=len(bodies), clients=clients, wall_s=wall,
                qps=len(bodies) / wall, p50_ms=p50, p99_ms=p99, front=front)


def p50_p99(lat_s):
    ms = np.asarray(lat_s) * 1e3
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def lane_of(fp, reg, terms, k):
    """The lane the REST layer sends a match query of ``terms`` to."""
    return fp.route(reg, terms)[0] if fp.fits(reg, terms, k) else "plan"


def match_body(terms, k, source=False):
    """A match body of the reference bench's shape (``_source: false``,
    bench.py:954), which the C++ front parses; ``source`` True sends it
    to the fallback workers instead."""
    from elasticsearch_tpu_torch.corpus import term_name
    return {"query": {"match": {"title": " ".join(
        term_name(t) for t in terms)}}, "size": k, "_source": source}


def plan_body(terms, k):
    """The same query outside the fast grammar (a match with a boost of
    1, which scales no score): the plan path serves it."""
    from elasticsearch_tpu_torch.corpus import term_name
    return {"query": {"match": {"title": {
        "query": " ".join(term_name(t) for t in terms), "boost": 1.0}}},
        "size": k}


def served_order(truth, scores):
    """An oracle top k in the order the port serves it: (reported float32
    score desc, docid asc)."""
    return truth[np.lexsort((truth, -scores.astype(np.float32)))]


def check_answer(r, oracle, lane, what, exact_order=False):
    """An HTTP answer against the float64 oracle ``(truth, scores,
    total)``: the total exact; a fast lane's hits the oracle's top k
    (recall 1.0; in its served order when ``exact_order``); on the plan
    path (float32 ranking) a missing oracle doc must tie the kth score
    within rtol 1e-5. Returns the recall."""
    truth, scores, total = oracle
    got = [int(h["_id"]) for h in r["hits"]["hits"]]
    check(r["hits"]["total"] == {"value": total, "relation": "eq"},
          f"{what}: total {r['hits']['total']} vs {total}")
    check(len(got) == len(truth), f"{what}: hit count")
    hit = np.isin(truth, got)
    if lane == "plan":
        kth = scores[-1] if len(scores) else 0.0
        check(bool(np.all(np.abs(scores[~hit] - kth) <= 1e-5 * kth)),
              f"{what}: the missing oracle docs tie the kth score within "
              f"rtol 1e-5")
    else:
        check(bool(hit.all()), f"{what} ({lane}): recall 1.0")
        if exact_order:
            check(got == served_order(truth, scores).tolist(),
                  f"{what} ({lane}): ids and order")
    return float(hit.mean()) if len(truth) else 1.0


@contextlib.contextmanager
def lane_launches(counters):
    """Within the block each fast-path cohort launch
    (``FastPathServer._launch_cohort``, any server) runs inside a named
    profiler range ``<label>_cohort`` and adds its kernels' launches to
    the yielded per_lane {label: {kernel: launches}}; ``taken`` maps each
    launched query's term tuple to the labels of its launches, in order.
    The label is the lane (v2m, v1, ess), or "refire" for a full-lane
    cohort launched
    inside an essential one (its uncertified rows); an essential
    cohort's count excludes its refires'. Every kernel counter starts
    at 0."""
    from torch.profiler import record_function

    from elasticsearch_tpu_torch.search.fastpath import FastPathServer
    orig = FastPathServer._launch_cohort
    per_lane, taken = {}, {}
    local = threading.local()

    def wrapped(self, lane, reg, bucket, items, rows):
        stack = local.__dict__.setdefault("stack", [])
        label = "refire" if stack and stack[-1][0] == "ess" else lane
        for p in items:
            taken.setdefault(tuple(p.term_ids), []).append(label)
        before = {n: c.launches for n, c in counters.items()}
        frame = (lane, dict.fromkeys(counters, 0))
        stack.append(frame)
        try:
            with record_function(f"{label}_cohort"):
                return orig(self, lane, reg, bucket, items, rows)
        finally:
            stack.pop()
            d = per_lane.setdefault(label, dict.fromkeys(counters, 0))
            for n, c in counters.items():
                total = c.launches - before[n]
                d[n] += total - frame[1][n]
                if stack:
                    stack[-1][1][n] += total

    for c in counters.values():
        c.launches = 0
    FastPathServer._launch_cohort = wrapped
    try:
        yield per_lane, taken
    finally:
        FastPathServer._launch_cohort = orig


def phase_rest_scale(node, port, corpus, queries, clients, k, taken):
    """The main path: every query over HTTP from ``clients`` threads,
    each served by the lane the router picks (v2m when the slot layout
    fits, v1 for a misfit within the largest bucket, the plan path
    beyond it), each answer against the float64 oracle. ``taken``: the
    labels of each query's launches (``lane_launches``)."""
    from elasticsearch_tpu_torch.corpus import exact_topk
    svc = node.indices["bench"]
    seg = svc.engine.segments[0]
    fp = node.serving_lane()
    reg = fp.register("bench", seg, "title", svc.k1, svc.b)
    lanes = [lane_of(fp, reg, q, k) for q in queries]
    bodies = [match_body(q, k) for q in queries]
    d0 = fp.serving_stats()["dispatch"]
    h0 = node.http_stats()
    results, lat, wall = drive(port, bodies, clients)
    front = front_since(node, h0)
    misfits = sum(1 for st, r in results if st == 400)
    for i, (st, r) in enumerate(results):
        check(st == 200, f"scale query {i} ({lanes[i]}) -> {st} {r}")
    check(front["fast"] == len(bodies) and front["fallback"] == 0
          and front["bounced"] - front["bounced_stale"]
          == lanes.count("plan"),
          f"the C++ front parsed every body and bounced the plan-path "
          f"ones alone: {front}")
    disp = dispatched_since(fp, d0)

    def served(lane):
        return sum(v for key, v in disp.items() if key.startswith(lane + ":"))

    # each query on its routed lane; a query given twice in the mix may
    # ride the essential lane the second time, once the first answer
    # stored its θ (a refire then launches it on its routed lane again)
    occurs: dict = {}
    for q, lane in zip(queries, lanes):
        occurs.setdefault(tuple(q), [lane, 0])[1] += 1
    refired = {"v2m": 0, "v1": 0}
    for q, (lane, n) in occurs.items():
        got = taken.get(q, [])
        ess, ref = got.count("ess"), got.count("refire")
        if lane == "plan":
            ok = not got
        else:
            ok = (got.count(lane) + ess == n and ess <= n - 1
                  and ref <= ess and set(got) <= {lane, "ess", "refire"})
        check(ok, f"scale query {list(q)}: routed {lane} x{n}, "
              f"launched {got}")
        if lane in refired:
            refired[lane] += ref
    check(all(served(lane) == sum(taken.get(q, []).count(lane)
                                  for q in occurs) + refired[lane]
              for lane in ("v2m", "v1"))
          and served("ess") == sum(v.count("ess") for v in taken.values()),
          f"the dispatch counts each lane's launches: {disp}")
    t_or = time.time()
    oracles = [exact_topk(corpus, q, k) for q in queries]
    recall = {"v2m": [], "v1": [], "plan": []}
    for i, (_, r) in enumerate(results):
        recall[lanes[i]].append(check_answer(r, oracles[i], lanes[i],
                                             f"scale query {i}"))

    def pct(lane):
        sel = [lat[i] for i in range(len(queries))
               if lane in (None, lanes[i])]
        return p50_p99(sel) if sel else (None, None)

    res = dict(queries=len(queries), misfits=misfits,
               served_v2m=lanes.count("v2m"), served_v1=lanes.count("v1"),
               served_plan=lanes.count("plan"), served_ess=served("ess"),
               distinct_queries=len({tuple(q) for q in queries}),
               dispatch=disp, front=front,
               clients=clients, wall_s=wall, qps=len(queries) / wall,
               p50_ms=pct(None)[0], p99_ms=pct(None)[1],
               **{f"p{q}_ms_{lane}": pct(lane)[j]
                  for lane in ("v2m", "v1", "plan")
                  for j, q in enumerate((50, 99))},
               **{f"recall_min_{lane}": min(v, default=None)
                  for lane, v in recall.items()},
               oracle_s=time.time() - t_or)
    log(f"[rest-scale] {res}")
    return res, lanes, bodies, results, oracles


def phase_theta_warm(node, port, queries, bodies, oracles, lanes, clients,
                     counters):
    """The θ-warm pass: the scale phase's bodies sent again from
    ``clients`` threads, after the cold pass stored each full answer's θ.
    A repeat the split admits rides the essential lane (its certificate
    failing: a refire on v2m or v1); the rest ride their cold lanes.
    Every answer against the float64 oracle: recall@1000 = 1.0 and the
    exact total with relation "eq" on the fast lanes, the plan path's
    tolerance on the plan path. Reports qps, p50/p99 overall and per
    lane taken, the θ cache and essential-lane counters (with the splits
    refused for want of a hot-term row), and each lane's kernel
    launches."""
    fp = node.fastpath
    s0 = dict(fp.stats)
    e0 = fp.engine_cache_stats()
    busy0 = fp.timing["device_busy_s"]
    d0 = fp.serving_stats()["dispatch"]
    with lane_launches(counters) as (per_lane, taken):
        results, lat, wall = drive(port, bodies, clients)
    launches = {n: c.launches for n, c in counters.items()}
    # the lane that answered each occurrence: an essential row that
    # refired was answered by its refire
    answers = {}
    for q, labels in taken.items():
        out = answers[q] = []
        for label in labels:
            if label == "refire":
                out[out.index("ess")] = "refire"
            else:
                out.append(label)
    took = [answers[tuple(q)].pop(0) if answers.get(tuple(q)) else "plan"
            for q in queries]
    recall = {}
    for i, (st, r) in enumerate(results):
        check(st == 200, f"warm query {i} ({took[i]}) -> {st} {r}")
        recall.setdefault(took[i], []).append(check_answer(
            r, oracles[i], "plan" if took[i] == "plan" else took[i],
            f"warm query {i}"))
        check(took[i] in (lanes[i], "ess", "refire"),
              f"warm query {i}: lane {took[i]}, cold {lanes[i]}")
    c1 = fp.stats
    d = {k: c1[k] - s0[k] for k in c1}
    e1 = fp.engine_cache_stats()
    check(d["ess_queries"] > 0 and per_lane["ess"]["gather_bm25_contrib"]
          > 0, f"the essential lane served and launched its kernel: {d}, "
          f"{per_lane}")
    check(launches["gather_bm25_contrib"] > 0, "the contribution kernel "
          "launched in the warm pass")

    def pct(lane):
        sel = [lat[i] for i in range(len(queries))
               if lane in (None, took[i])]
        return p50_p99(sel) if sel else (None, None)

    lanes_taken = sorted(set(took))
    out = dict(
        queries=len(queries), clients=clients, wall_s=wall,
        qps=len(queries) / wall, p50_ms=pct(None)[0], p99_ms=pct(None)[1],
        **{f"p{q}_ms_{lane}": pct(lane)[j] for lane in lanes_taken
           for j, q in enumerate((50, 99))},
        lanes={n: took.count(n) for n in lanes_taken},
        dispatch=dispatched_since(fp, d0),
        theta={k: e1[k] - e0[k] for k in ("hits", "misses", "stores")},
        theta_entries=e1["entries"],
        ess_queries=d["ess_queries"], ess_refires=d["ess_refires"],
        cohorts_ess=d["cohorts_ess"], ess_no_dense=d["ess_no_dense"],
        cohorts=d["cohorts"], cohorts_failed=d["cohorts_failed"],
        mean_cohort_width=d["fast_queries"] / max(1, d["cohorts"]),
        device_busy_s=fp.timing["device_busy_s"] - busy0,
        launches=launches, launches_per_lane=per_lane,
        **{f"recall_min_{lane}": min(v) for lane, v in recall.items()})
    check(out["cohorts_failed"] == 0, "no warm cohort failed")
    log(f"[theta-warm] {out}")
    return out


def logs_bodies(corpus, n_base, filt_pool, seed):
    """The plan-path bodies of the incident index (``with_incident_terms``
    over the corpus): each incident term alone at sizes 10 and 1000, and
    at size 100 under a filter on a common term, each with its float64
    oracle (the filter applied)."""
    from elasticsearch_tpu_torch.corpus import (docs_with_all, exact_topk,
                                                term_name)
    rng = np.random.default_rng(seed)
    bodies, oracles = [], []
    for t in range(n_base, len(corpus["df"])):
        for k in (10, 1000):
            bodies.append(plan_body([t], k))
            oracles.append(exact_topk(corpus, [t], k))
        f = int(rng.choice(filt_pool))
        bodies.append({"query": {"bool": {
            "must": [plan_body([t], 100)["query"]],
            "filter": [{"match": {"title": term_name(f)}}]}}, "size": 100})
        oracles.append(exact_topk(corpus, [t], 100,
                                  keep=docs_with_all(corpus, [f])))
    return bodies, oracles


def phase_plan_prune(node, port, clients, plan_bodies, misfit_bodies,
                     logs_bodies, logs_oracles):
    """The plan path under ``track_total_hits: 10000``, which licenses
    block-max window pruning, each body also asked with
    ``track_total_hits: true``: phase 3's bodies on its two-segment
    index, the scale phase's misfits asked outside the fast grammar (on
    the uniform corpus the bound pass finds no window to drop, so its
    back-off engages), and the incident index's bodies, where the
    incident window holds each incident term's best scores and the
    binds must prune. The hits must equal the exact ask's (ids and order,
    scores within rtol 1e-6), and the exact ask the float64 oracle on
    the incident index (``check_answer``'s plan-path rule); the total is
    at most the exact one and the threshold, "eq" only when it is the
    exact one, and the exact one clamped to 10000 where no bind pruned.
    The exact asks go from ``clients`` threads; the threshold asks one at
    a time, so each body's binds that pruned are known (and the
    segment's back-off, which a bound pass that prunes nothing arms for
    the next binds, acts in body order). Counts the binds that reached
    the bound pass and those that pruned, and lists the bodies that
    pruned."""
    from elasticsearch_tpu_torch.search import plan as plan_mod
    orig = plan_mod._prune_fields
    count = {"calls": 0, "pruned": 0}

    def counted(*a, **kw):
        out, pruned = orig(*a, **kw)
        count["calls"] += 1
        count["pruned"] += int(pruned)
        return out, pruned

    out = {}
    plan_mod._prune_fields = counted
    try:
        for index, bodies, oracles in (
                ("plan", plan_bodies, None),
                ("bench", misfit_bodies, None),
                ("logs", logs_bodies, logs_oracles)):
            c0 = dict(count)
            exact, _, _ = drive(port, bodies, clients, index)
            thr, lat, pruned_bodies = [], [], []
            t0 = time.perf_counter()
            for i, b in enumerate(bodies):
                before = count["pruned"]
                t1 = time.perf_counter()
                thr.append(http(port, "POST", f"/{index}/_search",
                                dict(b, track_total_hits=10000)))
                lat.append(time.perf_counter() - t1)
                if count["pruned"] > before:
                    pruned_bodies.append(i)
            wall = time.perf_counter() - t0
            pruned_here = count["pruned"] - c0["pruned"]
            gte = 0
            for i, ((st, e), (st2, t)) in enumerate(zip(exact, thr)):
                what = f"prune {index} body {i}"
                check(st == st2 == 200, f"{what} -> {st} {st2}")
                if oracles is not None:
                    check_answer(e, oracles[i], "plan", what)
                check([h["_id"] for h in t["hits"]["hits"]]
                      == [h["_id"] for h in e["hits"]["hits"]],
                      f"{what}: ids and order equal to the exact ask")
                check(np.allclose([h["_score"] for h in t["hits"]["hits"]],
                                  [h["_score"] for h in e["hits"]["hits"]],
                                  rtol=1e-6, atol=0),
                      f"{what}: scores within rtol 1e-6")
                exact_total = e["hits"]["total"]["value"]
                check(e["hits"]["total"]["relation"] == "eq",
                      f"{what}: the exact ask counts exactly")
                tt = t["hits"]["total"]
                check(tt["value"] <= min(exact_total, 10000)
                      and (tt["relation"] == "gte"
                           or tt["value"] == exact_total),
                      f"{what}: total {tt} against {exact_total}")
                if not pruned_here:
                    check(tt == {
                        "value": min(exact_total, 10000),
                        "relation": "gte" if exact_total > 10000 else "eq"},
                        f"{what}: total {tt}")
                gte += tt["relation"] == "gte"
            out[index] = dict(bodies=len(bodies), wall_s=wall,
                              p50_ms=p50_p99(lat)[0], relation_gte=gte,
                              prune_calls=count["calls"] - c0["calls"],
                              binds_pruned=pruned_here,
                              bodies_pruned=pruned_bodies)
    finally:
        plan_mod._prune_fields = orig
    check(out["logs"]["binds_pruned"] > 0,
          f"pruning engaged on the incident index: {out['logs']}")
    for index in ("bench", "logs"):
        dev = node.device_cache.get(node.indices[index].engine.segments[0])
        out[f"{index}_backoff"] = dict(prune_fail=dev._prune_fail,
                                       prune_skip=dev._prune_skip)
    log(f"[plan-prune] {out}")
    return out


def phase_plan_cpu(node, bodies, results, k, what):
    """Plan-path answers against the port's CPU execution of the same
    queries on the same segment."""
    from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
    from elasticsearch_tpu_torch.search.queries import parse_query
    from elasticsearch_tpu_torch.search.searcher import ShardSearcher
    svc = node.indices["bench"]
    segments = svc.engine.segments
    cpu = ShardSearcher(segments, svc.mapper, DeviceSegmentCache("cpu"),
                        svc.k1, svc.b)
    t0 = time.time()
    for i, (body, (_, r)) in enumerate(zip(bodies, results)):
        res = cpu.query_phase(parse_query(body["query"]), k)
        hits_match_cpu(r, res, segments, 0, f"{what} {i}")
    log(f"[plan-cpu] {len(bodies)} {what} answers equal to the CPU "
        f"execution ({time.time() - t0:.1f} s)")
    return len(bodies)


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


def phase_scale_trace(node, port, lanes, bodies, clients, counters):
    """What the lanes cost each other on the card they share, with the
    load from the C++ load generator (``clients`` connections). (a) The
    scale phase's v2m-served queries alone, untraced, two rounds to warm
    and 12 measured: latency and the CUDA-event seconds of their
    cohorts. (b) All the queries again under
    torch.profiler, each cohort launch of each lane inside a named range,
    so the trace gives each lane's device seconds in the mixed load, and
    the card's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from elasticsearch_tpu_torch.ops import plan as plan_ops
    from elasticsearch_tpu_torch.rest.native_http import loadgen
    fp = node.fastpath
    v2m = [b for b, lane in zip(bodies, lanes) if lane == "v2m"]
    alone = loadgen_pass(node, port, v2m, ["v2m"] * len(v2m), clients,
                         reps=12, warmup=2)

    orig = plan_ops.plan_topk_batch

    def plan_named(*a, **kw):
        with record_function("plan_cohort"):
            return orig(*a, **kw)

    plan_ops.plan_topk_batch = plan_named
    s0, busy0 = dict(fp.stats), fp.timing["device_busy_s"]
    config = all_threads()
    try:
        with lane_launches(counters), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                experimental_config=config) as prof:
            res = loadgen(port, "/bench/_search", bodies, clients,
                          len(bodies))
            torch.cuda.synchronize()
    finally:
        plan_ops.plan_topk_batch = orig
    check(res["done"] == len(bodies) and res["non2xx"] == 0,
          f"traced run answered: {res['done']} done, {res['non2xx']} "
          f"not 2xx")
    wall = res["wall_s"]
    events = prof.key_averages()
    total_us = sum(self_dev(e) for e in kernel_rows(events))
    names = ("v2m", "v1", "plan")
    ranges = {n: [e for e in events if e.key == f"{n}_cohort"
                  and e.device_type == torch.autograd.DeviceType.CPU]
              for n in names}
    p50, p99 = p50_p99(res["lat_s"])
    mixed = dict(
        queries=len(bodies), wall_s=wall, qps=len(bodies) / wall,
        p50_ms=p50, p99_ms=p99,
        device_s=total_us / 1e6, idle_share=1.0 - total_us / 1e6 / wall,
        device_s_handwritten=sum(
            self_dev(e) for e in kernel_rows(events)
            if "gather_contrib_kernel" in e.key
            or "merge_path_round" in e.key) / 1e6,
        v2m_device_busy_s=fp.timing["device_busy_s"] - busy0,
        all_threads=config is not None)
    for n in names:
        mixed[f"device_s_{n}"] = sum(dev_total(e) for e in ranges[n]) / 1e6
        mixed[f"{n}_launches"] = sum(e.count for e in ranges[n])
    for n in ("v2m", "v1"):
        mixed[f"{n}_cohorts"] = fp.stats[f"cohorts_{n}"] - s0[f"cohorts_{n}"]
    if config is not None:
        check(all(mixed[f"{n}_launches"] == mixed[f"{n}_cohorts"]
                  for n in ("v2m", "v1"))
              and (mixed["plan_launches"] > 0) == ("plan" in lanes),
              f"every cohort launch of each lane named in the trace: "
              f"{mixed}")
    out = dict(v2m_alone=alone, mixed_traced=mixed)
    log(f"[scale-trace] {out}")
    return out


def phase_plan_burst(node, port, bodies, k):
    """The plan path under a burst: ``bodies`` (the scale phase's
    queries that no v2m cohort takes, asked outside the fast grammar)
    sent all at once; the cohorts the PlanBatcher forms from them, the
    lanes in flight at once against its admission limit, and the device
    memory they hold. Each answer equals the port's CPU execution."""
    import torch

    from elasticsearch_tpu_torch.search import batching
    check(bodies, "queries for the plan burst")
    batcher = node.search_service.plan_batcher
    s0 = batcher.stats()
    batcher.peak_lanes_in_flight = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got, lat, wall = drive(port, bodies, len(bodies))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    for i, (st, r) in enumerate(got):
        check(st == 200, f"burst query {i} -> {st} {r}")
    s1 = batcher.stats()
    check(s1["batched_queries"] - s0["batched_queries"] == len(bodies),
          "every burst query went through the PlanBatcher")
    equal = phase_plan_cpu(node, bodies, got, k, "plan burst query")
    hist = {q: n - s0["batch_hist"].get(q, 0)
            for q, n in s1["batch_hist"].items()
            if n > s0["batch_hist"].get(q, 0)}
    p50, p99 = p50_p99(lat)
    out = dict(queries=len(bodies), wall_s=wall, p50_ms=p50, p99_ms=p99,
               cohorts=s1["launches"] - s0["launches"], q_bucket_hist=hist,
               peak_lanes_in_flight=s1["peak_lanes_in_flight"],
               max_lanes_in_flight=batching.MAX_LANES_IN_FLIGHT,
               admission_waits=s1["admission_waits"]
               - s0["admission_waits"],
               peak_extra_bytes=peak - base, resident_bytes=base,
               equal_to_cpu=equal)
    log(f"[plan-burst] {out}")
    return out


def phase_plan_trace(node, bodies, k, reps=3):
    """The cohorts the PlanBatcher forms from the plan ``bodies``, each
    traced with torch.profiler: the largest
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
    picked = bodies
    check(picked, "plan queries to trace")
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


def phase_filters(node, port, corpus, queries, k, clients, counters):
    """The reference bench's bool+filters mix: 64 bodies from the first
    64 queries, each with two match filters drawn from a pool of 8 terms
    of df > N/20, sent once to warm the mask rows and then 8 times over
    from ``clients`` threads. Every body whose query the fast path's
    buckets hold is served by a fast lane; one that needs more blocks
    than the largest bucket goes to the plan path (the reference's
    impact-truncated lane bounces it too at size 1000). Totals are exact
    and recall@k = 1.0 against the float64 oracle with both filters
    applied (the plan path: misses only at float32 ties of the kth)."""
    from elasticsearch_tpu_torch.corpus import (docs_with_all, exact_topk,
                                                term_name)
    fp = node.fastpath
    svc = node.indices["bench"]
    reg = fp.register("bench", svc.engine.segments[0], "title", svc.k1,
                      svc.b)
    dev = reg["dev"]
    n_docs = len(corpus["lens"])
    frng = np.random.default_rng(777)
    eligible = np.nonzero(corpus["df"] > n_docs // 20)[0]
    pool = frng.choice(eligible, size=min(8, len(eligible)), replace=False)
    bodies, oracles, lanes = [], [], []
    t0 = time.time()
    for q in queries[:64]:
        f1, f2 = (int(f) for f in frng.choice(pool, size=2, replace=False))
        bodies.append({"query": {"bool": {
            "must": [{"match": {"title": " ".join(
                term_name(t) for t in q)}}],
            "filter": [{"match": {"title": term_name(f1)}},
                       {"match": {"title": term_name(f2)}}]}},
            "size": k, "_source": False})
        oracles.append(exact_topk(corpus, q, k,
                                  keep=docs_with_all(corpus, (f1, f2))))
        lanes.append(lane_of(fp, reg, q, k))
    oracle_s = time.time() - t0
    batcher = node.search_service.plan_batcher
    plan0 = batcher.stats()["batched_queries"]
    hits0, miss0 = dev.filter_mask_hits, dev.filter_mask_misses
    s0, d0 = dict(fp.stats), fp.serving_stats()["dispatch"]
    with lane_launches(counters) as (per_lane, _):
        warm, _, warm_wall = drive(port, bodies, clients)
        sent = bodies * 8
        results, lat, wall = drive(port, sent, clients)
    recall = {"fast": [1.0], "plan": [1.0]}
    for i, (st, r) in enumerate(warm + results):
        j = i % len(bodies)
        check(st == 200, f"filter body {i} -> {st} {r}")
        recall["plan" if lanes[j] == "plan" else "fast"].append(
            check_answer(r, oracles[j], lanes[j], f"filter body {j}"))
    served = dispatched_since(fp, d0)
    n_plan = lanes.count("plan")
    refires = fp.stats["ess_refires"] - s0["ess_refires"]
    check(sum(served.values()) - refires == 9 * (len(bodies) - n_plan)
          and batcher.stats()["batched_queries"] - plan0 == 9 * n_plan,
          f"only the bodies beyond the largest bucket reached the plan "
          f"path ({served}, {n_plan} bodies)")
    cohorts = fp.stats["cohorts"] - s0["cohorts"]
    p50, p99 = p50_p99(lat)
    # the same 8 rounds from the C++ load generator
    load = loadgen_pass(node, port, bodies, lanes, clients, reps=8)
    out = dict(bodies=len(bodies), requests=len(sent), clients=clients,
               filter_pool=[int(t) for t in pool], wall_s=wall,
               qps=len(sent) / wall, p50_ms=p50, p99_ms=p99,
               warm_wall_s=warm_wall, lanes={n: lanes.count(n)
                                             for n in set(lanes)},
               plan_bodies=[j for j, n in enumerate(lanes) if n == "plan"],
               plan_requests=9 * n_plan,
               dispatch=served, cohorts=cohorts,
               mean_cohort_width=(fp.stats["fast_queries"]
                                  - s0["fast_queries"]) / max(1, cohorts),
               mask_rows_in_use=len(reg["stack_map"]),
               filter_mask_hits=dev.filter_mask_hits - hits0,
               filter_mask_misses=dev.filter_mask_misses - miss0,
               ess_queries=fp.stats["ess_queries"] - s0["ess_queries"],
               ess_refires=refires,
               launches_per_lane=per_lane, oracle_s=oracle_s,
               loadgen=load,
               recall_min_fast=min(recall["fast"]),
               recall_min_plan=min(recall["plan"]))
    for lane, d in per_lane.items():
        check(d["gather_bm25_contrib"] > 0 and (
            lane != "v2m" or d["merge_sorted_slots"] > 0),
            f"{lane}: its kernels launched in the filters mix {d}")
    log(f"[filters] {out}")
    return out


# ---------------------------------------------------------------- phase 5
F32_MAX = float(np.finfo(np.float32).max)


def iso_ms(ms: int) -> str:
    """Epoch milliseconds as an ISO-8601 UTC date with milliseconds."""
    import datetime as dt
    t = dt.datetime.fromtimestamp(int(ms) // 1000, tz=dt.timezone.utc)
    return t.strftime("%Y-%m-%dT%H:%M:%S.") + f"{int(ms) % 1000:03d}Z"


class LogsOracle:
    """float64 numpy answers on the logs index under the reference's
    float32 column semantics: a bound or a search_after value rounds to
    float32 and compares with the float32 column; a field sort picks its
    k winners by the float32 key (missing last, the lowest docid winning
    a tie), and the page orders them by the float64 values (then docid).
    Also the same answers on exact int64 milliseconds, for the gap."""

    def __init__(self, corpus, cols):
        self.corpus = corpus
        self.n = len(corpus["lens"])
        self.ts = cols["@timestamp"]["values"]
        self.ts_ms = self.ts.astype(np.int64)
        self.cols = {f: c["values"] for f, c in cols.items()}

    def col32(self, field):
        v = self.cols[field]
        return np.nan_to_num(v).astype(np.float32), np.isnan(v)

    def range_mask(self, field, gte=None, lt=None, lte=None, exact=False):
        """Docs whose value passes the bounds (in the column's unit)."""
        if exact:
            v, miss = self.cols[field], np.isnan(self.cols[field])
        else:
            v, miss = self.col32(field)

        def b(x):
            return x if exact else np.float32(x)
        m = ~miss
        if gte is not None:
            m &= v >= b(gte)
        if lt is not None:
            m &= v < b(lt)
        if lte is not None:
            m &= v <= b(lte)
        return m

    def sorted_page(self, mask, field, order, k, after=None, exact=False):
        """(page docids, total) of a field-sorted ask: total counts
        before the cursor; with ``exact`` every compare is float64."""
        total = int(mask.sum())
        v64 = self.cols[field]
        miss = np.isnan(v64)
        v = v64 if exact else self.col32(field)[0]
        if after is not None:
            a = after if exact else np.float32(after)
            mask = mask & ~miss & ((v > a) if order == "asc" else (v < a))
        cand = np.nonzero(mask)[0]
        fill = F32_MAX if order == "asc" else -F32_MAX
        key = np.where(miss[cand], fill, v[cand]).astype(np.float64)
        key = -key if order == "asc" else key
        win = cand[np.lexsort((cand, -key))[:k]]
        # the page: by the float64 value (missing last), then docid
        val = v64[win]
        sgn = 1.0 if order == "asc" else -1.0
        page = win[np.lexsort((win, sgn * np.nan_to_num(val),
                               np.isnan(val)))]
        return page, total

    def bm25(self, text):
        from elasticsearch_tpu_torch.corpus import dense_scores
        terms = [int(t[1:]) for t in text.split()]
        return dense_scores(self.corpus, terms)


def oracle_topk(scores, mask, k):
    """(truth, scores, total) of ``scores`` over ``mask``: the top k by
    (score desc, docid asc), as check_answer takes them."""
    docs = np.nonzero(mask)[0]
    order = docs[np.lexsort((docs, -scores[docs]))][:k]
    return order, scores[order], len(docs)


def gap_score(scores, mask):
    """A min_score that sits in a gap of the float64 scores (relative
    gap > 1e-4), so float32 and float64 agree on every doc's side."""
    v = np.unique(scores[mask])[::-1]
    for i in range(len(v) // 20, len(v) - 1):
        if v[i] - v[i + 1] > 1e-4 * v[i]:
            return float((v[i] + v[i + 1]) / 2)
    raise RuntimeError("no gap in the scores for a min_score")


def dense_bodies(oracle, n_base, queries, seed):
    """The dense mix on the logs index, after Rally's http_logs
    operations and Kibana Discover: [(kind, body, expected)], where
    ``expected`` is ("page", ids, total, score) for a constant-score or
    field-sorted ask (ids in order) or ("topk", truth, scores, total)
    for a BM25-scored one (check_answer's plan-path rule)."""
    from elasticsearch_tpu_torch.corpus import LOGS_T0_MS, term_name
    rng = np.random.default_rng(seed)
    hour = 3_600_000
    out = []
    # range: a one-hour window of @timestamp, size 10 (constant 1.0:
    # the lowest docids of the window)
    for h in (1, 7, 13, 22):
        lo, hi = LOGS_T0_MS + h * hour, LOGS_T0_MS + (h + 1) * hour
        m = oracle.range_mask("@timestamp", gte=lo, lt=hi)
        out.append(("range", {"query": {"range": {"@timestamp": {
            "gte": iso_ms(lo), "lt": iso_ms(hi)}}}, "size": 10},
            ("page", np.nonzero(m)[0][:10], int(m.sum()), 1.0)))
    # Kibana Discover: a time filter, newest first, 500 rows
    for h, span in ((3, hour // 4), (11, hour), (20, 2 * hour)):
        lo = LOGS_T0_MS + h * hour
        m = oracle.range_mask("@timestamp", gte=lo, lte=lo + span)
        page, total = oracle.sorted_page(m, "@timestamp", "desc", 500)
        out.append(("discover", {"query": {"bool": {"filter": [{"range": {
            "@timestamp": {"gte": iso_ms(lo), "lte": iso_ms(lo + span)}}}]}},
            "sort": [{"@timestamp": "desc"}], "size": 500},
            ("page", page, total, 0.0)))
    allm = np.ones(oracle.n, bool)
    page, total = oracle.sorted_page(allm, "@timestamp", "asc", 10)
    out.append(("asc_sort_timestamp", {"query": {"match_all": {}},
                "sort": [{"@timestamp": "asc"}]},
                ("page", page, total, 1.0)))
    # an incident term: the commonest of the incident terms
    nb = oracle.corpus["nb"]
    inc = n_base + int(np.argmax(nb[n_base:]))
    t_inc = term_name(inc)
    s_inc = oracle.bm25(t_inc)
    st32 = oracle.col32("status")[0]
    out.append(("status_500", {"query": {"bool": {
        "must": [{"match": {"title": t_inc}}],
        "filter": [{"term": {"status": 500}}]}}, "size": 100},
        ("topk",) + oracle_topk(s_inc, (s_inc > 0) & (st32 == 500), 100)))
    # the scale phase's queries under a time filter (1-6 hours)
    for q in queries[:64]:
        h0 = int(rng.integers(0, 20))
        lo = LOGS_T0_MS + h0 * hour
        hi = lo + int(rng.integers(1, 7)) * hour
        text = " ".join(term_name(t) for t in q)
        s = oracle.bm25(text)
        m = oracle.range_mask("@timestamp", gte=lo, lt=hi)
        out.append(("match_range", {"query": {"bool": {
            "must": [{"match": {"title": text}}],
            "filter": [{"range": {"@timestamp": {
                "gte": iso_ms(lo), "lt": iso_ms(hi)}}}]}}, "size": 100},
            ("topk",) + oracle_topk(s, (s > 0) & m, 100)))
    bm = oracle.range_mask("bytes")
    out.append(("exists", {"query": {"exists": {"field": "bytes"}}},
                ("page", np.nonzero(bm)[0][:10], int(bm.sum()), 1.0)))
    nm = st32 != 200
    out.append(("must_not_only", {"query": {"bool": {"must_not": [
        {"term": {"status": 200}}]}}, "size": 20},
        ("page", np.nonzero(nm)[0][:20], int(nm.sum()), 0.0)))
    neg = st32 >= 500
    out.append(("boosting", {"query": {"boosting": {
        "positive": {"match": {"title": t_inc}},
        "negative": {"range": {"status": {"gte": 500}}},
        "negative_boost": 0.5}}, "size": 50},
        ("topk",) + oracle_topk(np.where(neg, s_inc * 0.5, s_inc),
                                s_inc > 0, 50)))
    b32 = oracle.col32("bytes")[0]
    big = (b32 >= 100000) & bm
    s_q = oracle.bm25(" ".join(term_name(t) for t in queries[0]))
    rng_s = big.astype(np.float64)
    best = np.maximum(s_q, rng_s)
    out.append(("dis_max", {"query": {"dis_max": {"queries": [
        {"match": {"title": " ".join(term_name(t) for t in queries[0])}},
        {"range": {"bytes": {"gte": 100000}}}], "tie_breaker": 0.2}},
        "size": 50},
        ("topk",) + oracle_topk(best + 0.2 * (s_q + rng_s - best),
                                (s_q > 0) | big, 50)))
    ids = sorted(int(i) for i in rng.choice(oracle.n, 40, replace=False))
    out.append(("ids", {"query": {"ids": {"values": [str(i) for i in ids]
                                          + ["not-an-id"]}},
                        "size": 50},
                ("page", np.asarray(ids), len(ids), 1.0)))
    page, total = oracle.sorted_page(allm, "bytes", "asc", 100)
    out.append(("sort_bytes", {"query": {"match_all": {}},
                               "sort": [{"bytes": "asc"}], "size": 100},
                ("page", page, total, 1.0)))
    ms = gap_score(s_inc, s_inc > 0)
    out.append(("min_score", {"query": {"match": {"title": t_inc}},
                              "min_score": ms, "size": 100},
                ("topk",) + oracle_topk(s_inc, s_inc >= ms, 100)))
    return out


def check_dense_answer(r, expected, what):
    if expected[0] == "topk":
        check_answer(r, expected[1:], "plan", what)
        return
    _, ids, total, score = expected
    check(r["hits"]["total"] == {"value": total, "relation": "eq"},
          f"{what}: total {r['hits']['total']} vs {total}")
    got = [int(h["_id"]) for h in r["hits"]["hits"]]
    check(got == [int(i) for i in ids], f"{what}: ids and order")
    check(all(h["_score"] == score for h in r["hits"]["hits"]),
          f"{what}: constant score {score}")


def desc_pages(port, oracle, n_pages, size):
    """Rally's desc_sort_timestamp, then ``n_pages`` of
    desc_sort_with_after_timestamp, each continuing from the last sort
    value of the page before; each page held to the oracle. Returns the
    bodies, the answers and the expected pages."""
    allm = np.ones(oracle.n, bool)
    bodies, answers, expected = [], [], []
    after = None
    for i in range(n_pages + 1):
        body = {"query": {"match_all": {}},
                "sort": [{"@timestamp": "desc"}], "size": size}
        if after is not None:
            body["search_after"] = [after]
        page, total = oracle.sorted_page(allm, "@timestamp", "desc", size,
                                         after=after)
        st, r = http(port, "POST", "/logs/_search", body)
        check(st == 200, f"desc page {i} -> {st} {r}")
        exp = ("page", page, total, 1.0)
        check_dense_answer(r, exp, f"desc page {i}")
        bodies.append(("desc_after" if i else "desc_sort_timestamp", body))
        answers.append(r)
        expected.append(exp)
        after = r["hits"]["hits"][-1]["sort"][0]
    return bodies, answers, expected


def f32_gap(oracle, kind, body, served_ids):
    """Docs that change membership (``member``) or page rank (``rank``)
    between the float32 columns and exact int64 milliseconds, for a
    range or @timestamp-sorted body; for a range also the docs whose
    membership of the whole match set changes (``set``)."""
    from elasticsearch_tpu_torch.index.mapper import DateFieldType
    parse = DateFieldType("@timestamp").parse
    q = body["query"]
    if kind == "range":
        r = q["range"]["@timestamp"]
        lo, hi = parse(r["gte"]), parse(r["lt"])
        m32 = oracle.range_mask("@timestamp", gte=lo, lt=hi)
        m64 = oracle.range_mask("@timestamp", gte=lo, lt=hi, exact=True)
        exact = np.nonzero(m64)[0][:body["size"]]
        set_gap = int((m32 ^ m64).sum())
    else:
        if kind == "discover":
            r = q["bool"]["filter"][0]["range"]["@timestamp"]
            lo, hi = parse(r["gte"]), parse(r["lte"])
            m64 = oracle.range_mask("@timestamp", gte=lo, lte=hi,
                                    exact=True)
            set_gap = int((oracle.range_mask("@timestamp", gte=lo, lte=hi)
                           ^ m64).sum())
        else:
            m64 = np.ones(oracle.n, bool)
            set_gap = 0
        (field, order), = body["sort"][0].items()
        after = body.get("search_after", [None])[0]
        exact, _ = oracle.sorted_page(m64, field, order,
                                      body.get("size", 10), after=after,
                                      exact=True)
    served = np.asarray(served_ids)
    member = int(len(np.setdiff1d(exact, served)))
    n = min(len(exact), len(served))
    rank = int((exact[:n] != served[:n]).sum() + abs(len(exact) - n))
    return dict(member=member, rank=rank, set=set_gap)


def dense_breakdown(node, bodies, iters):
    """Device ms of the dense executor's stages for each of ``bodies``
    ([(kind, body)]) on the logs index, by CUDA events: ``score`` (the
    query's execute: dense BM25 through the contribution kernel, masks,
    columns), ``mask`` (live, search_after and the primary key column),
    ``masked_topk``; ``readback``: host ms of the copies of the k keys,
    docids and scores and the total and max; ``query_ms``: host ms of
    the whole dense query phase (ends in its readback)."""
    import torch

    from elasticsearch_tpu_torch.ops.topk import masked_topk
    from elasticsearch_tpu_torch.search.queries import parse_query
    from elasticsearch_tpu_torch.search.searcher import (
        ShardSearcher, _parse_sort, _primary_sort_key, _search_after_mask)
    svc = node.indices["logs"]
    searcher = ShardSearcher(svc.engine.segments, svc.mapper,
                             node.device_cache, svc.k1, svc.b)
    ctx = searcher._contexts()[0]
    out = {}
    for kind, body in bodies:
        query = parse_query(body["query"])
        k = body.get("size", 10)
        spec = _parse_sort(body.get("sort"))
        after = body.get("search_after")
        score_ms = cuda_ms(lambda: query.execute(ctx), iters)[0]
        scores, m0 = query.execute(ctx)

        def mask_fn():
            m = m0 & ctx.live
            if after is not None:
                m = m & _search_after_mask(ctx, svc.mapper, scores, spec,
                                           after)
            return m, _primary_sort_key(ctx, svc.mapper, scores, spec)
        mask_ms = cuda_ms(mask_fn, iters)[0]
        m, key = mask_fn()
        topk_ms = cuda_ms(lambda: masked_topk(key, m, k), iters)[0]
        vals, ids = masked_topk(key, m, k)
        win = scores[ids.clamp(max=ctx.n_docs_padded - 1).long()]
        tot = m.sum(dtype=torch.int64).reshape(1)
        mx = torch.where(m, scores, float("-inf")).amax().reshape(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            for t in (vals, ids, win, tot, mx):
                t.cpu()
        rb_ms = (time.perf_counter() - t0) * 1e3 / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            searcher.query_phase(query, k, sort=body.get("sort"),
                                 search_after=after,
                                 min_score=body.get("min_score"),
                                 allow_plan=False)
        q_ms = (time.perf_counter() - t0) * 1e3 / iters
        out[kind] = dict(score=score_ms, mask=mask_ms, masked_topk=topk_ms,
                         readback=rb_ms, query_ms=q_ms)
    return out


def plan_vs_dense(node, bodies, reps=3):
    """The match + range bodies on the device through the plan path
    (its dense_mask) and through the dense executor (``allow_plan``
    False), each timed by the host around the whole query phase (both
    end in a readback): mean and p50 ms of each; totals must agree, and
    the count of bodies whose ids and order agree is reported."""
    from elasticsearch_tpu_torch.search.queries import parse_query
    from elasticsearch_tpu_torch.search.searcher import ShardSearcher
    svc = node.indices["logs"]
    searcher = ShardSearcher(svc.engine.segments, svc.mapper,
                             node.device_cache, svc.k1, svc.b)
    t_plan, t_dense, same_ids = [], [], 0
    for _, body in bodies:
        q = parse_query(body["query"])
        k = body["size"]
        p = d = None
        for _ in range(reps):
            t0 = time.perf_counter()
            p = searcher.query_phase(q, k)
            t1 = time.perf_counter()
            d = searcher.query_phase(q, k, allow_plan=False)
            t2 = time.perf_counter()
            t_plan.append(t1 - t0)
            t_dense.append(t2 - t1)
        check(p.total_hits == d.total_hits,
              f"plan and dense totals agree ({p.total_hits} vs "
              f"{d.total_hits})")
        same_ids += [x.docid for x in p.docs] == [x.docid for x in d.docs]
    return dict(bodies=len(bodies), reps=reps,
                plan_mean_ms=float(np.mean(t_plan)) * 1e3,
                plan_p50_ms=p50_p99(t_plan)[0],
                dense_mean_ms=float(np.mean(t_dense)) * 1e3,
                dense_p50_ms=p50_p99(t_dense)[0],
                same_ids_and_order=same_ids)


def contrib_dense_shape(node, n_base, iters):
    """The contribution kernel against its twin at the dense scorer's
    shape: Q = 1, the blocks of the commonest incident term (padded to
    its bucket), the all-true mask row; timed with its bound."""
    import torch

    from elasticsearch_tpu_torch.ops.bm25_contrib import (
        gather_bm25_contrib, gather_bm25_contrib_plain)
    svc = node.indices["logs"]
    dev = node.device_cache.get(svc.engine.segments[0])
    dp = dev.postings["title"]
    counts = dp.term_block_count[n_base:]
    tid = n_base + int(np.argmax(counts))
    sel, ws = dp.select_blocks([tid], [1.7])
    sel_t = torch.from_numpy(sel).to(dev.device)[None].contiguous()
    ws_t = torch.from_numpy(ws).to(dev.device)[None].contiguous()
    mids = torch.zeros(1, dtype=torch.int32, device=dev.device)
    avg = float(np.float32(dp.avg_len))
    args = (dp.block_docids, dp.block_tfs, sel_t, ws_t, dp.doc_lens,
            dev.all_docs_row, mids, avg, 1.2, 0.75)
    kk, ck = gather_bm25_contrib(*args)
    kp, cp = gather_bm25_contrib_plain(*args)
    torch.cuda.synchronize()
    rel = float(((ck - cp).abs() / cp.abs().clamp_min(1e-30)).max())
    check(torch.equal(kk, kp) and rel <= 2e-7,
          f"contrib kernel at the dense shape: keys equal, rtol {rel}")
    n_valid = int((kk != 0x7FFFFFFF).sum())
    nb = sel.shape[0]
    n_blocks = len(np.unique(sel))
    n_bytes = (n_blocks * 128 * 8 + n_valid * 5 + nb * 8
               + nb * 128 * (4 + 4))
    b, by = bound_ms(n_bytes, 7 * n_valid, "float32")
    return dict(term=int(tid), nb=int(nb), lanes=int(nb * 128),
                valid_lanes=n_valid, max_abs_err=float((ck - cp).abs().max()),
                rtol=rel, ms=cuda_ms(lambda: gather_bm25_contrib(*args),
                                     iters)[0],
                plain_ms=cuda_ms(lambda: gather_bm25_contrib_plain(*args),
                                 iters)[0],
                bound_ms=b, bound_by=by, bytes=n_bytes)


def phase_dense(node, port, logs, cols, n_base, queries, clients, seed,
                iters, counters):
    """The dense mix over HTTP on the logs index (2M docs with the
    ``logs_columns``): every body answered (no 400), each held to the
    float64 oracle under float32 column semantics, and at least 16 to
    the port's own CPU execution at full size; then timed from
    ``clients`` Python clients; the dense executor's stage times, the
    plan path beside the dense executor on the match + range bodies,
    the float32 gap, and the contribution kernel at the dense shape."""
    from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
    from elasticsearch_tpu_torch.search.service import SearchService
    oracle = LogsOracle(logs, cols)
    t0 = time.time()
    mix = dense_bodies(oracle, n_base, queries, seed)
    log(f"[dense] {len(mix)} bodies and their oracles in "
        f"{time.time() - t0:.1f} s")
    for fn in counters.values():
        fn.launches = 0
    # the main run: the paged walk, then every other body from clients
    pages, page_answers, page_expected = desc_pages(port, oracle, 5, 100)
    kinds = [k for k, _, _ in mix]
    bodies = [b for _, b, _ in mix]
    results, _, _ = drive(port, bodies, clients, "logs")
    launches = {n: fn.launches for n, fn in counters.items()}
    check(launches["gather_bm25_contrib"] > 0,
          f"the contribution kernel launched on the dense path: {launches}")
    refused = 0
    for i, ((st, r), (kind, body, exp)) in enumerate(zip(results, mix)):
        refused += st != 200
        check(st == 200, f"dense body {i} ({kind}) -> {st} {r}")
        check_dense_answer(r, exp, f"dense body {i} ({kind})")
    all_kinds = [k for k, _ in pages] + kinds
    all_bodies = [b for _, b in pages] + bodies
    all_answers = page_answers + [r for _, r in results]
    # the port's own CPU execution of the same bodies on the same segment
    svc = node.indices["logs"]
    cpu = SearchService(DeviceSegmentCache("cpu"))
    t0 = time.time()
    n_cpu = 0
    for i, (kind, body, r) in enumerate(zip(all_kinds, all_bodies,
                                            all_answers)):
        if kind == "match_range" and n_cpu >= 24:
            continue
        c = cpu.search("logs", svc, body)
        what = f"dense body {i} ({kind}) vs the CPU"
        check(c["hits"]["total"] == r["hits"]["total"], f"{what}: total")
        check([h["_id"] for h in c["hits"]["hits"]]
              == [h["_id"] for h in r["hits"]["hits"]],
              f"{what}: ids and order")
        check([h.get("sort") for h in c["hits"]["hits"]]
              == [h.get("sort") for h in r["hits"]["hits"]],
              f"{what}: sort values")
        check(np.allclose([h["_score"] for h in c["hits"]["hits"]],
                          [h["_score"] for h in r["hits"]["hits"]],
                          rtol=1e-6, atol=0), f"{what}: scores rtol 1e-6")
        n_cpu += 1
    check(n_cpu >= 16, f"{n_cpu} bodies held to the CPU execution")
    log(f"[dense] {n_cpu} answers equal to the CPU execution "
        f"({time.time() - t0:.1f} s)")
    # the float32 gap of every range and @timestamp-sorted body
    gaps = {}
    for kind, body, r in zip(all_kinds, all_bodies, all_answers):
        if kind in ("range", "discover", "asc_sort_timestamp",
                    "desc_sort_timestamp", "desc_after"):
            g = f32_gap(oracle, kind, body,
                        [int(h["_id"]) for h in r["hits"]["hits"]])
            gaps.setdefault(kind, []).append(g)
    # timed: three rounds of the whole mix from the clients
    rounds = 3
    t_bodies = all_bodies * rounds
    res2, lat, wall = drive(port, t_bodies, clients, "logs")
    for i, (st, r) in enumerate(res2):
        j = i % len(all_bodies)
        check(st == 200 and [h["_id"] for h in r["hits"]["hits"]]
              == [h["_id"] for h in all_answers[j]["hits"]["hits"]],
              f"timed dense body {j} equal to its first answer")
    per_kind = {}
    for i, t in enumerate(lat):
        per_kind.setdefault(all_kinds[i % len(all_bodies)], []).append(t)
    latency = {k: dict(n=len(v), p50_ms=p50_p99(v)[0], p99_ms=p50_p99(v)[1])
               for k, v in per_kind.items()}
    sample = {}
    for kind, body in zip(all_kinds, all_bodies):
        sample.setdefault(kind, body)
    out = dict(
        docs=oracle.n, bodies=len(all_bodies), refused=refused,
        checked_oracle=len(all_bodies), checked_cpu=n_cpu,
        launches=launches,
        timed=dict(requests=len(t_bodies), wall_s=wall,
                   qps=len(t_bodies) / wall, clients=clients,
                   p50_ms=p50_p99(lat)[0], p99_ms=p50_p99(lat)[1],
                   per_kind=latency),
        f32_gap=gaps,
        stages=dense_breakdown(node, [(k, sample[k]) for k in (
            "range", "discover", "desc_after", "sort_bytes", "boosting",
            "min_score")], iters),
        plan_vs_dense=plan_vs_dense(
            node, [(k, b) for k, b in zip(kinds, bodies)
                   if k == "match_range"]),
        contrib_dense_shape=contrib_dense_shape(node, n_base, iters))
    log(f"[dense] {out}")
    return out


# ---------------------------------------------------------------- phase 6
# the tensor-core rate for the kNN product's bound (bf16 in, float32
# accumulation: H100 SXM data sheet, dense)
BF16_TC_OPS_PER_S = 989e12


def host_free_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2 ** 20
    return float("nan")


def knn_oracle(vecs, qs, k, chunk=1 << 19):
    """The float64 brute-force oracle on the card: for each query [Q, D]
    the top ``k`` docs of ``vecs`` [N, D] by the cosine ES score
    (1 + cos) / 2 in float64, as (ids [Q, k] by score desc then docid
    asc, float64 scores [Q, k]). The slab goes up in row chunks."""
    import torch
    q = torch.from_numpy(qs).cuda().double()
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    best_s = torch.full((len(qs), 0), float("-inf"), dtype=torch.float64,
                        device="cuda")
    best_i = torch.zeros((len(qs), 0), dtype=torch.int64, device="cuda")
    for lo in range(0, len(vecs), chunk):
        v = torch.from_numpy(vecs[lo:lo + chunk]).cuda().double()
        n = torch.linalg.vector_norm(v, dim=1)
        cos = (q @ v.T) / torch.where(n > 0, n, 1.0)[None, :]
        s = torch.cat([best_s, (1.0 + cos) / 2.0], dim=1)
        ids = torch.cat([best_i, torch.arange(lo, lo + v.shape[0],
                                              device="cuda").expand(
            len(qs), -1)], dim=1)
        best_s, pos = torch.topk(s, min(k, s.shape[1]), dim=1)
        best_i = torch.gather(ids, 1, pos)
    best_s, best_i = best_s.cpu().numpy(), best_i.cpu().numpy()
    order = [np.lexsort((best_i[r], -best_s[r])) for r in range(len(qs))]
    return (np.stack([best_i[r][o] for r, o in enumerate(order)]),
            np.stack([best_s[r][o] for r, o in enumerate(order)]))


def exact_f32_cosine(vecs, ids, q):
    """The ES cosine score in float32 of the rows ``ids`` for ``q``,
    written out here: (1 + v.q / (|v| |q|)) / 2."""
    v = vecs[ids].astype(np.float32)
    q = np.asarray(q, np.float32)
    nrm = np.linalg.norm(v, axis=1) * np.linalg.norm(q)
    return ((np.float32(1.0) + (v @ q) / np.where(nrm > 0, nrm, 1.0))
            / np.float32(2.0)).astype(np.float32)


def check_knn_answer(r, vecs, q, oracle_ids, oracle_s, k, total, what):
    """A kNN answer: the total; every oracle top-k doc that is missing
    ties the oracle's kth score within rtol 1e-5; every score equals
    the exact float32 formula for its vector (rtol 1e-6); order by
    score desc, then lowest docid. Returns the recall."""
    hits = r["hits"]["hits"]
    check(r["hits"]["total"] == {"value": total, "relation": "eq"},
          f"{what}: total {r['hits']['total']} vs {total}")
    got = np.array([int(h["_id"]) for h in hits], np.int64)
    scores = np.array([h["_score"] for h in hits], np.float64)
    check(len(got) == min(k, len(oracle_ids)), f"{what}: {len(got)} hits")
    hit = np.isin(oracle_ids, got)
    kth = oracle_s[-1]
    check(bool(np.all(np.abs(oracle_s[~hit] - kth) <= 1e-5 * kth)),
          f"{what}: {int((~hit).sum())} oracle docs missing, not all "
          f"tied with the kth score")
    check(np.allclose(scores, exact_f32_cosine(vecs, got, q), rtol=1e-6,
                      atol=0), f"{what}: scores are the exact float32 "
                               f"formula")
    check(all((-scores[i], got[i]) < (-scores[i + 1], got[i + 1])
              for i in range(len(got) - 1)),
          f"{what}: ordered by score desc, then docid")
    return float(hit.mean())


def one_cohort(batcher, ctx, field, qs, cut):
    """Each caller's (scores, ids) for ``qs`` asked at once from one
    thread each, while the batcher's launch slots are held until every
    caller has queued: the leader then pops them all as one cohort."""
    out = [None] * len(qs)

    def call(i):
        out[i] = batcher.topk(ctx, field, qs[i], cut)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(qs))]
    held = 0
    while batcher._launch_slots.acquire(blocking=False):
        held += 1
    try:
        for t in threads:
            t.start()
        while True:
            with batcher._lock:
                if sum(map(len, batcher._pending.values())) == len(qs):
                    break
            time.sleep(0.001)
    finally:
        for _ in range(held):
            batcher._launch_slots.release()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads), "cohort callers finished")
    return out


def nominate_breakdown(dv, live, qs, cut, iters):
    """Device ms of ``knn_nominate_batch`` at Q = 1, 8 and 32 on the
    slab ``dv`` (cosine): the whole op, and its stages (the product,
    the transform and mask, ``stable_topk``), a bare ``torch.topk`` of
    the same scores beside them, and the host ms of the packed readback;
    the byte and tensor-core bounds of the op's work."""
    import torch

    from elasticsearch_tpu_torch.ops import vector as vec_ops
    from elasticsearch_tpu_torch.ops.device import readback
    from elasticsearch_tpu_torch.ops.topk import stable_topk
    nd, d = dv.vectors.shape
    out = {}
    for q in (1, 8, 32):
        qt = torch.from_numpy(qs[np.arange(q) % len(qs)]).cuda()
        qn = qt / torch.linalg.vector_norm(qt, dim=1, keepdim=True)
        raw = vec_ops.dot_scores(qn, dv.vectors)
        keep = (dv.has_value & live)[None, :]
        scores = torch.where(keep, (1.0 + raw) / 2.0, float("-inf"))
        docids = torch.arange(nd, dtype=torch.int32,
                              device="cuda")[None].expand(q, nd)
        top_s, top_i = stable_topk(scores, docids, cut)
        t_read = []
        for _ in range(iters):
            t0 = time.perf_counter()
            readback("chip_smoke.knn_breakdown", torch.cat(
                [top_s, top_i.to(torch.float32)], dim=1))
            t_read.append((time.perf_counter() - t0) * 1e3)
        row = dict(
            op_ms=cuda_ms(lambda: vec_ops.knn_nominate_batch(
                qt, dv.vectors, dv.sq_norms, dv.has_value, live, "cosine",
                cut), iters)[0],
            product_ms=cuda_ms(lambda: vec_ops.dot_scores(qn, dv.vectors),
                               iters)[0],
            transform_mask_ms=cuda_ms(lambda: torch.where(
                keep, (1.0 + raw) / 2.0, float("-inf")), iters)[0],
            stable_topk_ms=cuda_ms(lambda: stable_topk(scores, docids, cut),
                                   iters)[0],
            torch_topk_ms=cuda_ms(lambda: torch.topk(scores, cut, dim=1),
                                  iters)[0],
            readback_host_ms=float(np.median(t_read)))
        n_bytes = (nd * d * dv.vectors.element_size() + nd * (4 + 1 + 1)
                   + q * d * 4 + q * cut * 8)
        n_ops = 2.0 * q * nd * d
        row["byte_bound_ms"] = n_bytes / HBM_BYTES_PER_S * 1e3
        row["tensor_core_bound_ms"] = n_ops / BF16_TC_OPS_PER_S * 1e3
        row["bound_ms"] = max(row["byte_bound_ms"],
                              row["tensor_core_bound_ms"])
        row["bound_by"] = ("bytes" if row["byte_bound_ms"]
                           >= row["tensor_core_bound_ms"] else "operations")
        row["op_over_bound"] = row["op_ms"] / row["bound_ms"]
        out[f"q{q}"] = row
        del raw, scores, top_s, top_i
    return out


def phase_knn(node, port, n_docs, dims, n_queries, seed, iters):
    """Config 4: pure kNN at full width on the index ``knn`` (cosine,
    ``dims``, ``n_docs`` seeded unit vectors installed through
    ``segment_from_numpy``). The 16 bodies over HTTP, each held to the
    float64 oracle; one in-process cohort of 16 callers equal to the
    same queries launched alone; the nomination's stage times against
    its bounds; the host re-rank; the load generator at 8 connections
    over the bodies x 4."""
    import torch

    from elasticsearch_tpu_torch.corpus import (knn_query_vectors,
                                                unit_vectors)
    from elasticsearch_tpu_torch.index.segment import segment_from_numpy
    from elasticsearch_tpu_torch.ops import vector as vec_ops
    from elasticsearch_tpu_torch.rest.native_http import loadgen
    from elasticsearch_tpu_torch.search.batching import (KnnBatcher,
                                                         _KnnEntry)
    out = dict(docs=n_docs, dims=dims, queries=n_queries,
               host_free_gib_before=host_free_gib())
    t0 = time.time()
    vecs = unit_vectors(n_docs, dims, seed, device="cuda")
    out["generate_s"] = time.time() - t0
    out["host_bytes"] = int(vecs.nbytes)
    qs = knn_query_vectors(vecs, n_queries, np.random.default_rng(seed + 1))
    node.create_index("knn", {"properties": {"vec": {
        "type": "dense_vector", "dims": dims, "similarity": "cosine"}}})
    svc = node.indices["knn"]
    svc.engine.install_segments([segment_from_numpy(
        {"vectors": {"vec": {"vectors": vecs}}}, name="knn0")])
    seg = svc.engine.segments[0]
    check(seg.vectors["vec"].vectors is vecs,
          "the segment keeps the generated array as its host copy")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.time()
    dev = node.device_cache.get(seg)
    torch.cuda.synchronize()
    out["slab_upload_s"] = time.time() - t0
    dv = dev.vectors["vec"]
    out["slab_bytes"] = dv.vectors.numel() * dv.vectors.element_size()
    out["device_bytes_added"] = torch.cuda.memory_allocated() - mem0
    out["slab_dtype"] = str(dv.vectors.dtype)
    out["matmul_route"] = vec_ops.matmul_route(dv.vectors)
    out["host_free_gib_after_upload"] = host_free_gib()
    log(f"[knn] {n_docs} x {dims} generated in {out['generate_s']:.1f} s, "
        f"slab up in {out['slab_upload_s']:.1f} s "
        f"({out['slab_bytes'] / 1e9:.2f} GB, route {out['matmul_route']})")
    t0 = time.time()
    o_ids, o_s = knn_oracle(vecs, qs, 1000)
    out["oracle_s"] = time.time() - t0
    bodies = [{"knn": {"field": "vec", "query_vector": [float(x) for x in q],
                       "k": 1000, "num_candidates": 3000},
               "size": 1000, "_source": False} for q in qs]
    batcher = node.search_service.knn_batcher
    b0 = batcher.stats()
    h0 = node.http_stats()
    results, lat, wall = drive(port, bodies, len(bodies), "knn")
    front = front_since(node, h0)
    check(front["fallback"] == len(bodies) and front["fast"] == 0,
          f"every kNN body went to the fallback workers: {front}")
    recalls = []
    for i, (st, r) in enumerate(results):
        check(st == 200, f"knn body {i} -> {st} {r}")
        recalls.append(check_knn_answer(r, vecs, qs[i], o_ids[i], o_s[i],
                                        1000, min(1000, n_docs),
                                        f"knn body {i}"))
    b1 = batcher.stats()
    check(b1["knn_batched_queries"] - b0["knn_batched_queries"]
          == len(bodies), "every kNN body went through the KnnBatcher")
    out["recall_at_1000"] = float(np.mean(recalls))
    out["recall_min"] = float(np.min(recalls))
    out["http"] = dict(wall_s=wall, p50_ms=p50_p99(lat)[0],
                       p99_ms=p50_p99(lat)[1],
                       launches=b1["knn_launches"] - b0["knn_launches"])
    # one cohort of all the callers at full size, against solo launches
    ctx = node.search_service._searcher(svc)._contexts()[0]
    cut = 3000          # max(k, num_candidates): the service's cut
    solo_b = KnnBatcher()
    t0 = time.time()
    solo = [solo_b.topk(ctx, "vec", q, cut) for q in qs]
    solo_s = time.time() - t0
    cohort_b = KnnBatcher()
    t0 = time.time()
    rows = one_cohort(cohort_b, ctx, "vec", qs, cut)
    cohort_s = time.time() - t0
    check(cohort_b.launches == 1 and cohort_b.batched_queries
          == len(qs) >= 16, f"one cohort of {len(qs)}: "
                            f"{cohort_b.stats()}")
    for i, ((s, d), (s0, d0)) in enumerate(zip(rows, solo)):
        check(np.array_equal(d, d0) and np.array_equal(s, s0),
              f"cohort row {i} equals its query launched alone")
    out["cohort"] = dict(q=len(qs), launches=cohort_b.launches,
                         wall_s=cohort_s, solo_wall_s=solo_s)
    # the host half: the exact re-rank of one nominated row
    entries = [_KnnEntry(q, cut) for q in qs]
    cohort_b._run(entries, dv, dev.live, 4096)
    t_rr = []
    for e in entries:
        t0 = time.perf_counter()
        KnnBatcher._finish(e, ctx, "vec")
        t_rr.append((time.perf_counter() - t0) * 1e3)
    out["rerank_host_ms"] = dict(p50=float(np.median(t_rr)),
                                 max=float(np.max(t_rr)), candidates=4096)
    out["nominate"] = nominate_breakdown(dv, dev.live, qs, 4096, iters)
    # throughput: the C++ load generator, 8 connections, the bodies x 4
    b0 = batcher.stats()
    res = loadgen(port, "/knn/_search", bodies, 8, len(bodies) * 4)
    check(res["done"] == len(bodies) * 4 and res["non2xx"] == 0,
          f"the load generator's kNN requests all done with 2xx: {res}")
    b1 = batcher.stats()
    launches = b1["knn_launches"] - b0["knn_launches"]
    out["loadgen"] = dict(
        conns=8, requests=res["done"], wall_s=res["wall_s"],
        qps=res["done"] / res["wall_s"], p50_ms=p50_p99(res["lat_s"])[0],
        p99_ms=p50_p99(res["lat_s"])[1], knn_launches=launches,
        knn_avg_batch=(b1["knn_batched_queries"]
                       - b0["knn_batched_queries"]) / max(1, launches))
    out["host_free_gib_after"] = host_free_gib()
    log(f"[knn] {out}")
    return out


def rrf_fusion(branches, k_const, size, index):
    """(ids, scores, total) of the rank.rrf fusion of ``branches`` (hit
    lists, best first), ties by (index, id)."""
    scores = {}
    for hits in branches:
        for rank, h in enumerate(hits):
            scores[h["_id"]] = scores.get(h["_id"], 0.0) + 1.0 / (
                k_const + rank + 1)
    order = sorted(scores, key=lambda i: (-scores[i], (index, i)))[:size]
    return order, [scores[i] for i in order], len(scores)


def phase_hybrid(node, port, corpus, queries, oracles, dims, seed, conns,
                 counters, feat, cpu):
    """Config 5 on the index ``hybrid``: the scale corpus's segment with
    a ``vec`` field of ``dims``-d seeded unit vectors. 32 rank.rrf
    bodies (match + knn k 1000 / num_candidates 1500, size 1000), each
    equal to the fusion of the port's own answers to its two branches
    asked apart, the branches held to their oracles; 8 merged-hybrid
    bodies, 4 filtered knn bodies, 2 with ``_source: true`` and an
    ``exists`` on ``vec``, each equal to the port's CPU execution; the
    contribution kernel launches on the merged bodies; then the rrf
    bodies from the load generator. The segment also holds the numeric
    column ``feat`` (a ``double``), phase 7's, and the keyword doc values
    ``cat`` (``corpus.py bench_cat``, no postings), phase 8's. ``cpu``: a
    SearchService on the CPU, the port's CPU execution."""
    import torch

    from elasticsearch_tpu_torch.corpus import (bench_cat,
                                                segment_from_corpus,
                                                term_name, unit_vectors)
    from elasticsearch_tpu_torch.rest.native_http import loadgen
    n = len(corpus["lens"])
    t0 = time.time()
    vecs = unit_vectors(n, dims, seed, device="cuda")
    node.create_index("hybrid", {"properties": {
        "title": {"type": "text"}, "feat": {"type": "double"},
        "cat": {"type": "keyword"},
        "vec": {"type": "dense_vector", "dims": dims,
                "similarity": "cosine"}}})
    svc = node.indices["hybrid"]
    svc.engine.install_segments([segment_from_corpus(
        corpus, name="hybrid0", numerics={"feat": {"values": feat}},
        vectors={"vec": {"vectors": vecs}},
        keywords={"cat": dict(zip(("ords", "terms"), bench_cat(n)))})])
    node.device_cache.get(svc.engine.segments[0])
    torch.cuda.synchronize()
    out = dict(docs=n, dims=dims, setup_s=time.time() - t0)
    vrng = np.random.default_rng(7)
    qv = vrng.standard_normal((32, dims))
    qv = np.round(qv / np.linalg.norm(qv, axis=1, keepdims=True), 4)
    text = [" ".join(term_name(t) for t in q) for q in queries[:32]]
    rbodies = [{"query": {"match": {"title": t}},
                "knn": {"field": "vec", "query_vector": v.tolist(),
                        "k": 1000, "num_candidates": 1500},
                "rank": {"rrf": {}}, "size": 1000, "_source": False}
               for t, v in zip(text, qv)]
    results, lat, wall = drive(port, rbodies, 16, "hybrid")
    q32 = qv.astype(np.float32)
    o_ids, o_s = knn_oracle(vecs, q32, 1000)
    service = node.search_service
    recalls = []
    for i, ((st, r), body) in enumerate(zip(results, rbodies)):
        check(st == 200, f"rrf body {i} -> {st} {r}")
        bm25 = service.search("hybrid", svc, {
            "query": body["query"], "size": 1000, "_source": False})
        knn = service.search("hybrid", svc, {
            "knn": body["knn"], "size": 1000, "_source": False})
        check_answer(bm25, oracles[i], "plan", f"rrf body {i} BM25 branch")
        recalls.append(check_knn_answer(
            knn, vecs, q32[i], o_ids[i], o_s[i], 1000, 1000,
            f"rrf body {i} kNN branch"))
        ids, scores, total = rrf_fusion(
            [bm25["hits"]["hits"], knn["hits"]["hits"]], 60, 1000,
            "hybrid")
        check([h["_id"] for h in r["hits"]["hits"]] == ids
              and [h["_score"] for h in r["hits"]["hits"]] == scores
              and r["hits"]["total"]["value"] == total,
              f"rrf body {i}: the fusion of its branches asked apart")
    out["rrf"] = dict(bodies=len(rbodies), knn_branch_recall=float(
        np.mean(recalls)), python_clients=dict(
        clients=16, wall_s=wall, p50_ms=p50_p99(lat)[0],
        p99_ms=p50_p99(lat)[1]))
    # the dense executor's bodies, against the CPU execution
    common = [t for t in np.argsort(-corpus["df"])[:4]]
    mixed = []
    for i in range(8):
        mixed.append(("merged", {
            "query": {"match": {"title": text[i]}},
            "knn": {"field": "vec", "query_vector": qv[i].tolist(),
                    "k": 100, "num_candidates": 300},
            "size": 100, "_source": False}))
    for i in range(4):
        mixed.append(("filtered", {
            "knn": {"field": "vec", "query_vector": qv[8 + i].tolist(),
                    "k": 50, "filter": {"term": {
                        "title": term_name(int(common[i]))}}},
            "size": 50, "_source": False}))
    for i in range(2):
        mixed.append(("source", {
            "knn": {"field": "vec", "query_vector": qv[12 + i].tolist(),
                    "k": 20}, "size": 20, "_source": True}))
    mixed.append(("exists", {"query": {"exists": {"field": "vec"}},
                             "size": 10}))
    for fn in counters.values():
        fn.launches = 0
    res2, _, _ = drive(port, [b for _, b in mixed], 8, "hybrid")
    launches = {name: fn.launches for name, fn in counters.items()}
    check(launches["gather_bm25_contrib"] > 0,
          f"the contribution kernel launched on the merged bodies: "
          f"{launches}")
    t0 = time.time()
    for (kind, body), (st, r) in zip(mixed, res2):
        what = f"hybrid {kind} body vs the CPU"
        check(st == 200, f"{what}: {st} {r}")
        c = cpu.search("hybrid", svc, body)
        check(c["hits"]["total"] == r["hits"]["total"], f"{what}: total")
        check([h["_id"] for h in c["hits"]["hits"]]
              == [h["_id"] for h in r["hits"]["hits"]]
              and len(r["hits"]["hits"]) > 0, f"{what}: ids and order")
        check(np.allclose([h["_score"] for h in c["hits"]["hits"]],
                          [h["_score"] for h in r["hits"]["hits"]],
                          rtol=1e-6, atol=0), f"{what}: scores rtol 1e-6")
    out["dense_bodies"] = dict(
        bodies=len(mixed), kinds={k: sum(1 for m, _ in mixed if m == k)
                                  for k in ("merged", "filtered", "source",
                                            "exists")},
        launches=launches, cpu_s=time.time() - t0)
    # throughput of the rrf bodies: the load generator, 4 rounds
    b0 = service.knn_batcher.stats()
    res = loadgen(port, "/hybrid/_search", rbodies, conns, len(rbodies) * 4)
    check(res["done"] == len(rbodies) * 4 and res["non2xx"] == 0,
          f"the load generator's rrf requests all done with 2xx: {res}")
    b1 = service.knn_batcher.stats()
    kl = b1["knn_launches"] - b0["knn_launches"]
    out["rrf"]["loadgen"] = dict(
        conns=conns, requests=res["done"], wall_s=res["wall_s"],
        qps=res["done"] / res["wall_s"], p50_ms=p50_p99(res["lat_s"])[0],
        p99_ms=p50_p99(res["lat_s"])[1], knn_launches=kl,
        knn_avg_batch=(b1["knn_batched_queries"]
                       - b0["knn_batched_queries"]) / max(1, kl))
    log(f"[hybrid] {out}")
    return out


# ---------------------------------------------------------------- phase 7
SCRIPT_BENCH = "doc['feat'].value * 0.5 + _score"
SCRIPT_VECTOR = "cosineSimilarity(params.qv, 'vec') + 1.0 + _score"
# a served score of a vector body against the float64 oracle over the
# slab's bfloat16 values: float32 BM25 (up to ~40, ulp 3.8e-6 summed over
# at most 8 terms) plus a float32 sum of 256 bfloat16 products
SCRIPT_VECTOR_ATOL = 1e-4


def script_body(text, source, size, params=None, **extra):
    script = {"source": source}
    if params is not None:
        script["params"] = params
    return {"query": {"script_score": {
        "query": {"match": {"title": text}}, "script": script, **extra}},
        "size": size, "_source": False}


def equal_to_cpu(r, c, what):
    """An HTTP answer against the port's CPU execution of the same body:
    ids, order and totals exact, scores rtol 1e-6."""
    check(c["hits"]["total"] == r["hits"]["total"], f"{what}: total "
          f"{r['hits']['total']} vs CPU {c['hits']['total']}")
    check([h["_id"] for h in c["hits"]["hits"]]
          == [h["_id"] for h in r["hits"]["hits"]], f"{what}: ids and order")
    check(np.allclose([h["_score"] for h in c["hits"]["hits"]],
                      [h["_score"] for h in r["hits"]["hits"]],
                      rtol=1e-6, atol=0), f"{what}: scores rtol 1e-6")


def script_oracle(bm25, feat32, k):
    """Config 3's float64 oracle: BM25 + 0.5 x the float32 feat column
    over the matched docs: (top-k docids by (score desc, docid asc),
    their scores, total)."""
    matched = np.nonzero(bm25 > 0)[0]
    score = bm25[matched] + 0.5 * feat32[matched].astype(np.float64)
    order = np.lexsort((matched, -score))[:k]
    return matched[order], score[order], len(matched)


def vector_oracle(slab, qvec, bm25, k):
    """The feature-vector body's float64 oracle over the slab's own
    bfloat16 values: cosine of the query normalized in float32 and cast
    to bfloat16 (as ops/vector.py cosine_scores casts it) against each
    slab row, + 1 + the float64 BM25, over the matched docs."""
    import torch
    q = torch.from_numpy(qvec.astype(np.float32)).cuda()
    qb = (q / torch.linalg.vector_norm(q)).to(torch.bfloat16).double()
    n = len(bm25)
    cos = torch.empty(n, dtype=torch.float64, device="cuda")
    for lo in range(0, n, 1 << 19):
        hi = min(n, lo + (1 << 19))
        cos[lo:hi] = slab[lo:hi].double() @ qb
    cos = cos.cpu().numpy()
    matched = np.nonzero(bm25 > 0)[0]
    score = cos[matched] + 1.0 + bm25[matched]
    order = np.lexsort((matched, -score))[:k]
    return matched[order], score[order], len(matched), cos


def check_vector_answer(r, oracle, bm25, cos, what):
    """Every served score within SCRIPT_VECTOR_ATOL of the oracle's score
    of that doc; every missing oracle doc within it of the kth score;
    the total exact."""
    truth, scores, total = oracle[:3]
    got = np.array([int(h["_id"]) for h in r["hits"]["hits"]], np.int64)
    check(r["hits"]["total"] == {"value": total, "relation": "eq"},
          f"{what}: total {r['hits']['total']} vs {total}")
    check(len(got) == len(truth), f"{what}: hit count")
    want = cos[got] + 1.0 + bm25[got]
    served = np.array([h["_score"] for h in r["hits"]["hits"]])
    err = float(np.abs(served - want).max()) if len(got) else 0.0
    check(err <= SCRIPT_VECTOR_ATOL,
          f"{what}: served scores within {SCRIPT_VECTOR_ATOL} of the "
          f"oracle ({err})")
    miss = ~np.isin(truth, got)
    kth = scores[-1] if len(scores) else 0.0
    check(bool(np.all(np.abs(scores[miss] - kth) <= SCRIPT_VECTOR_ATOL)),
          f"{what}: every missing oracle doc within {SCRIPT_VECTOR_ATOL} "
          f"of the kth score")
    return float((~miss).mean()) if len(truth) else 1.0, err


# plan launches timed in one cuda_ms window (see script_cohort_ms)
LAUNCHES_QUEUED = 3


def script_cohort_ms(node, bodies, reps=3):
    """Device ms (CUDA events) of one plan cohort of the first Q bench
    bodies at Q = 1, 8, 32 (every member padded to the widest member's
    selection, ``nb_width`` blocks, as a cohort pads), launched with the
    script and without it (the same bound selections, uploaded once),
    the difference (the transform's cost) and a byte bound of the
    transform: per lane a docid read, the feat value gathered, the score
    read and written (16 B), plus the feat column read once, at
    3.35 TB/s. The events time LAUNCHES_QUEUED launches queued behind a
    sleep (``*_host_ms``: the host's time to queue one); beside them the
    kernels' summed device time under torch.profiler over ``reps``
    launches (``*_kernel_ms``) and the kernel launches in one
    (``*_kernels``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from elasticsearch_tpu_torch.ops import plan as plan_ops
    from elasticsearch_tpu_torch.search.batching import PlanBatcher
    from elasticsearch_tpu_torch.search.plan import bind_plan, compile_plan
    from elasticsearch_tpu_torch.search.queries import parse_query
    from elasticsearch_tpu_torch.search.searcher import ShardSearcher
    svc = node.indices["hybrid"]
    searcher = ShardSearcher(svc.engine.segments, svc.mapper,
                             node.device_cache, svc.k1, svc.b)
    ctx = searcher._contexts()[0]
    bps = []
    for b in bodies:
        plan = compile_plan(parse_query(b["query"]), searcher)
        check(plan is not None and plan.script is not None,
              "the bench body compiles into a scripted plan")
        bps.append(bind_plan(plan, ctx, 1000))

    def up(a):
        if isinstance(a, torch.Tensor):
            return a
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).cuda()

    out = {}
    for q in (1, 8, 32):
        args, kw = PlanBatcher.cohort_args(bps[:q], ctx.live)
        streams = [st._replace(**{f: up(getattr(st, f)) for f in (
            "sel_blocks", "sel_group", "sel_sub", "sel_weight",
            "sel_const")}) for st in args[0]]
        args = (streams,) + tuple(up(a) for a in args[1:])
        lanes = q * sum(int(st.sel_blocks.shape[1]) * 128 for st in streams)
        row = {}
        for name, fn in (("script", kw["script_fn"]), ("plain", None)):
            def launch(fn=fn):
                plan_ops.plan_topk_batch(
                    *args, k1=svc.k1, b=svc.b, k=1000,
                    combine=kw["combine"], max_run=kw["max_run"],
                    script_fn=fn)
            # a plan launch is a few hundred kernel launches and the
            # card queues about a thousand: more launches than
            # LAUNCHES_QUEUED cannot be queued behind cuda_ms's sleep
            row[f"{name}_ms"], row[f"{name}_host_ms"] = cuda_ms(
                launch, LAUNCHES_QUEUED)
            # the kernels' own time, free of the host's launch gaps
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    launch()
                torch.cuda.synchronize()
            kernels = kernel_rows(prof.key_averages())
            row[f"{name}_kernel_ms"] = sum(
                self_dev(e) for e in kernels) / reps / 1e3
            row[f"{name}_kernels"] = sum(e.count for e in kernels) / reps
        nd = int(ctx.live.shape[0])
        row.update(lanes=lanes,
                   nb_width=max(int(st.sel_blocks.shape[1])
                                for st in streams),
                   transform_ms=row["script_ms"] - row["plain_ms"],
                   transform_kernel_ms=(row["script_kernel_ms"]
                                        - row["plain_kernel_ms"]),
                   transform_bound_ms=(lanes * 16 + nd * 4)
                   / HBM_BYTES_PER_S * 1e3)
        out[str(q)] = row
    return out


def phase_script(node, port, corpus, queries, feat, seed, conns, counters,
                 cpu):
    """BASELINE config 3 ("script_score re-rank (BM25 base +
    feature-vector scoring function)") on phase 6's index "hybrid" (the
    scale corpus's postings, the 256-d ``vec`` slab and the reference
    bench's ``feat`` column); ``cpu`` is a SearchService on the CPU, the
    port's CPU execution. (a) the bench's row over HTTP; (b) the
    feature-vector form; (c) function_score, min_score and rescore
    bodies; (d) a Painless statement script: a 400 over 2M docs, equal
    to the CPU on phase 3's index; (e) the bench bodies from the load
    generator; (f) one plan cohort timed with and without the script.
    Returns the phase's JSON; the contribution kernel's launches of
    (a)-(d) are counted in ``launches``."""
    import torch

    from elasticsearch_tpu_torch.corpus import dense_scores, term_name
    from elasticsearch_tpu_torch.ops.device import READBACKS
    from elasticsearch_tpu_torch.rest.native_http import loadgen
    svc = node.indices["hybrid"]
    service = node.search_service
    batcher = service.plan_batcher
    texts = [" ".join(term_name(t) for t in q) for q in queries[:32]]
    bm25 = [dense_scores(corpus, q) for q in queries[:32]]
    feat32 = feat.astype(np.float32)
    # the executors that served the HTTP bodies (the CPU executions read
    # back through the same funnel, so only the served calls count)
    sites = ("search.searcher.dense_topk", "search.script.statement_score",
             "search.searcher.rescore")
    tiers = Counter()

    def served(call):
        r0 = {k: READBACKS[k] for k in sites}
        b0 = batcher.stats()["batched_queries"]
        res = call()
        for k in sites:
            tiers[k] += READBACKS[k] - r0[k]
        tiers["plan"] += batcher.stats()["batched_queries"] - b0
        return res

    for fn in counters.values():
        fn.launches = 0
    out = dict(docs=len(feat))

    # (a) the bench's row: the plan launch with the script in it
    bench = [script_body(t, SCRIPT_BENCH, 1000) for t in texts]
    p0 = batcher.stats()
    res, lat, wall = served(lambda: drive(port, bench, 16, "hybrid"))
    p1 = batcher.stats()
    recalls = []
    for i, ((st, r), body) in enumerate(zip(res, bench)):
        what = f"script bench body {i}"
        check(st == 200, f"{what} -> {st} {r}")
        equal_to_cpu(r, cpu.search("hybrid", svc, body), what)
        recalls.append(check_answer(
            r, script_oracle(bm25[i], feat32, 1000), "plan", what))
    check(p1["batched_queries"] - p0["batched_queries"] == len(bench),
          "every bench body rode the plan launch")
    out["bench"] = dict(
        bodies=len(bench), recall=float(np.mean(recalls)),
        plan_cohorts=p1["launches"] - p0["launches"],
        python_clients=dict(clients=16, wall_s=wall,
                            p50_ms=p50_p99(lat)[0], p99_ms=p50_p99(lat)[1]))

    # (b) the feature-vector form, on the dense executor
    slab = node.device_cache.get(svc.engine.segments[0]).vectors["vec"]
    vrng = np.random.default_rng(seed)
    qv = vrng.standard_normal((16, slab.dims))
    qv = (qv / np.linalg.norm(qv, axis=1, keepdims=True)).astype(np.float32)
    vbodies = [script_body(texts[i], SCRIPT_VECTOR, 1000,
                           {"qv": qv[i].tolist()}) for i in range(16)]
    d0 = tiers["search.searcher.dense_topk"]
    res, lat, wall = served(lambda: drive(port, vbodies, 8, "hybrid"))
    check(tiers["search.searcher.dense_topk"] - d0 == len(vbodies),
          "every vector body took the dense executor")
    vrec, verr = [], []
    for i, ((st, r), body) in enumerate(zip(res, vbodies)):
        what = f"script vector body {i}"
        check(st == 200, f"{what} -> {st} {r}")
        orc = vector_oracle(slab.vectors[:len(feat)], qv[i], bm25[i], 1000)
        rec, err = check_vector_answer(r, orc, bm25[i], orc[3], what)
        vrec.append(rec)
        verr.append(err)
    out["vector"] = dict(bodies=len(vbodies), recall=float(np.mean(vrec)),
                         max_abs_err=float(max(verr)),
                         atol=SCRIPT_VECTOR_ATOL,
                         python_clients=dict(clients=8, wall_s=wall,
                                             p50_ms=p50_p99(lat)[0]))

    # (c) function_score, min_score and rescore, against the CPU
    mixed = []
    for i in range(8):
        mixed.append(("function_score", {"query": {"function_score": {
            "query": {"match": {"title": texts[i]}},
            "functions": [{"script_score": {"script": {
                "source": "doc['feat'].value"}}, "weight": 2.0},
                {"weight": 0.5}],
            "score_mode": "sum",
            "boost_mode": "multiply" if i % 2 else "sum"}},
            "size": 100, "_source": False}))
    for i in range(4):
        mixed.append(("min_score", script_body(
            texts[8 + i], "doc['feat'].value * 10 + _score", 100,
            min_score=10.0)))
    rescorer = {"script_score": {"query": {"match_all": {}},
                                 "script": {"source": "doc['feat'].value * 5"}}}
    modes = [("total", 1.0, 1.0), ("multiply", 1.0, 1.0), ("avg", 1.0, 1.0),
             ("max", 1.0, 1.0), ("min", 1.0, 1.0), ("total", 0.7, 1.2),
             ("multiply", 2.0, 0.5), ("max", 0.5, 3.0)]
    for i, (mode, qw, rqw) in enumerate(modes):
        mixed.append(("rescore", {
            "query": {"match": {"title": texts[12 + i]}}, "size": 10,
            "_source": False,
            "rescore": {"window_size": 100, "query": {
                "rescore_query": rescorer, "score_mode": mode,
                "query_weight": qw, "rescore_query_weight": rqw}}}))
    res, _, _ = served(lambda: drive(port, [b for _, b in mixed], 8,
                                     "hybrid"))
    for (kind, body), (st, r) in zip(mixed, res):
        what = f"script {kind} body"
        check(st == 200, f"{what} -> {st} {r}")
        check(len(r["hits"]["hits"]) > 0, f"{what}: hits")
        equal_to_cpu(r, cpu.search("hybrid", svc, body), what)
    out["mixed"] = {k: sum(1 for m, _ in mixed if m == k)
                    for k in ("function_score", "min_score", "rescore")}

    # (d) a statement script: over the interpreter's budget at 2M docs,
    # equal to the CPU on phase 3's index of 2400 docs
    stmt = ("double s = _score; if (doc['{f}'].value > {x}) {{ s += 1; }} "
            "return s;")
    st, r = served(lambda: http(port, "POST", "/hybrid/_search", script_body(
        texts[20], stmt.format(f="feat", x=0.5), 10)))
    check(st == 400 and r["error"]["type"] == "script_exception"
          and "interpreter budget" in r["error"]["reason"],
          f"a statement script over 2M docs -> 400 script_exception "
          f"({st} {r})")
    small = {"query": {"script_score": {
        "query": {"match": {"body": "wolf fox"}},
        "script": {"source": stmt.format(f="views", x=50)}}}, "size": 50}
    st, r = served(lambda: http(port, "POST", "/plan/_search", small))
    check(st == 200, f"the statement script on the small index -> {st} {r}")
    equal_to_cpu(r, cpu.search("plan", node.indices["plan"], small),
                 "the statement script on the small index")
    out["launches"] = {name: fn.launches for name, fn in counters.items()}
    check(out["launches"]["gather_bm25_contrib"] > 0,
          f"the contribution kernel launched in the script phase: "
          f"{out['launches']}")
    out["tiers"] = dict(
        plan=tiers["plan"], dense=tiers["search.searcher.dense_topk"],
        statement=tiers["search.script.statement_score"],
        rescore_readbacks=tiers["search.searcher.rescore"])

    # (e) the bench bodies from the load generator: a warm round, then 4
    f0 = node.http_stats()
    loadgen(port, "/hybrid/_search", bench, conns, len(bench))
    lg = loadgen(port, "/hybrid/_search", bench, conns, len(bench) * 4)
    check(lg["done"] == len(bench) * 4 and lg["non2xx"] == 0,
          f"the load generator's script requests all done with 2xx: {lg}")
    out["loadgen"] = dict(
        conns=conns, requests=lg["done"], wall_s=lg["wall_s"],
        qps=lg["done"] / lg["wall_s"], p50_ms=p50_p99(lg["lat_s"])[0],
        p99_ms=p50_p99(lg["lat_s"])[1], front=front_since(node, f0))
    check(out["loadgen"]["front"]["fallback"] == len(bench) * 5,
          f"the script bodies reached the fallback workers: "
          f"{out['loadgen']['front']}")

    # (f) the script's cost in the plan launch
    torch.cuda.synchronize()
    out["cohort"] = script_cohort_ms(node, bench)
    log(f"[script] {out}")
    return out


# ---------------------------------------------------------------- phase 8
HOUR_MS = 3_600_000
# the card's float32 sums (atomic adds in no fixed order) against the
# float64 oracle over the float32 column values, and against the CPU
AGG_RTOL = 1e-4
AGG_COLLECTORS = ("terms_counts_per_term", "masked_metric_stats",
                  "bucket_counts", "bucket_metric_columns")


def agg_equal(got, want, what, path="aggregations"):
    """An aggregations tree against its expected tree: keys, order and
    every int and string exactly; a float exactly when it is a key, a
    bound, a min or a max (a column's own value), else within
    AGG_RTOL."""
    if isinstance(want, dict):
        check(isinstance(got, dict) and sorted(got) == sorted(want),
              f"{what}: {path} keys {sorted(got) if isinstance(got, dict) else got}"
              f" vs {sorted(want)}")
        for k in want:
            agg_equal(got[k], want[k], what, f"{path}.{k}")
    elif isinstance(want, list):
        check(isinstance(got, list) and len(got) == len(want),
              f"{what}: {path} length")
        for i, (g, w) in enumerate(zip(got, want)):
            agg_equal(g, w, what, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        last = path.rsplit(".", 1)[-1]
        if last in ("key", "from", "to", "min", "max"):
            check(got == want, f"{what}: {path} {got!r} vs {want!r}")
        else:
            check(isinstance(got, (int, float)) and np.isclose(
                got, want, rtol=AGG_RTOL, atol=0),
                f"{what}: {path} {got!r} vs {want!r} (rtol {AGG_RTOL})")
    else:
        check(got == want and type(got) is type(want),
              f"{what}: {path} {got!r} vs {want!r}")


def o_metric(kind, vals):
    """The oracle's simple metric of float64 ``vals`` (the float32
    column's values): the reference's response shape."""
    n = len(vals)
    if kind == "value_count":
        return {"value": n}
    if n == 0:
        return ({"count": 0, "min": None, "max": None, "avg": None,
                 "sum": 0.0} if kind == "stats" else {"value": None})
    s = float(vals.sum())
    out = {"sum": s, "avg": s / n, "min": float(vals.min()),
           "max": float(vals.max()), "count": n}
    if kind == "stats":
        return out
    return {"value": out[kind]}


def o_histogram(values, sel, interval, date=False, subs=None):
    """The oracle's histogram over float64 ``values`` where ``sel``:
    floor(v / interval) steps, gaps filled; ``subs`` {name: (kind,
    float32 column as float64, present mask)} per bucket."""
    steps = np.floor(values[sel] / interval).astype(np.int64)
    lo, hi = int(steps.min()), int(steps.max())
    counts = np.bincount(steps - lo, minlength=hi - lo + 1)
    docs = np.nonzero(sel)[0]
    out = []
    for i, c in enumerate(counts):
        key = (lo + i) * interval
        b = {"key": key}
        if date:
            b["key_as_string"] = iso_ms(int(key))[:-4] + "000Z"
        b["doc_count"] = int(c)
        for name, (kind, col, present) in (subs or {}).items():
            d = docs[steps - lo == i]
            d = d[present[d]]
            b[name] = o_metric(kind, col[d])
        out.append(b)
    return {"buckets": out}


def o_numeric_terms(vals, size=10):
    u, c = np.unique(vals, return_counts=True)
    order = np.lexsort((u, -c))
    top = order[:size]
    return {"doc_count_error_upper_bound": 0,
            "sum_other_doc_count": int(c[order[size:]].sum()),
            "buckets": [{"key": int(u[i]) if float(u[i]).is_integer()
                         else float(u[i]), "doc_count": int(c[i])}
                        for i in top]}


def logs_agg_mix(oracle, text):
    """The Kibana-style bodies on the logs index and their float64
    oracle answers (the reference's float32 column semantics: a range
    bound rounds to float32; a device metric sums the float32 column's
    values): [(kind, body, expected aggregations, expected hits or
    None)]."""
    from elasticsearch_tpu_torch.corpus import LOGS_T0_MS
    t0 = LOGS_T0_MS
    ts = oracle.cols["@timestamp"]
    status = oracle.cols["status"]
    b64 = oracle.cols["bytes"]
    has_b = ~np.isnan(b64)
    b32 = np.nan_to_num(b64).astype(np.float32).astype(np.float64)

    def rng(lo_h, hi_h):
        q = {"range": {"@timestamp": {"gte": iso_ms(t0 + lo_h * HOUR_MS),
                                      "lt": iso_ms(t0 + hi_h * HOUR_MS)}}}
        return q, oracle.range_mask("@timestamp", t0 + lo_h * HOUR_MS,
                                    t0 + hi_h * HOUR_MS)

    out = []
    q, m = rng(2, 14)
    out.append(("date_histogram_30m", {"query": q, "size": 0, "aggs": {
        "h": {"date_histogram": {"field": "@timestamp",
                                 "fixed_interval": "30m"},
              "aggs": {"avg_b": {"avg": {"field": "bytes"}},
                       "sum_b": {"sum": {"field": "bytes"}},
                       "max_b": {"max": {"field": "bytes"}}}}}},
        {"h": o_histogram(ts, m, 1_800_000.0, True, {
            "avg_b": ("avg", b32, has_b), "sum_b": ("sum", b32, has_b),
            "max_b": ("max", b32, has_b)})}, None))
    q, m = rng(5, 6)
    out.append(("stats_1h", {"query": q, "size": 0, "aggs": {
        "st": {"stats": {"field": "bytes"}}}},
        {"st": o_metric("stats", b32[m & has_b])}, None))
    out.append(("histogram_bytes", {"size": 0, "aggs": {
        "h": {"histogram": {"field": "bytes", "interval": 1000}}}},
        {"h": o_histogram(b64, has_b, 1000.0)}, None))
    q, m = rng(0, 12)
    out.append(("terms_status", {"query": q, "size": 0, "aggs": {
        "st": {"terms": {"field": "status"}}}},
        {"st": o_numeric_terms(status[m])}, None))
    # ten minutes (a float32 bound rounds to 131 s at these epochs): a
    # digest of this budget holds every value, so it is exact
    q, m = rng(3, 3 + 1 / 6)
    vals = b64[m & has_b]
    check(0 < len(vals) <= 20000, f"the percentiles window holds "
          f"{len(vals)} values")
    out.append(("percentiles_cardinality", {"query": q, "size": 0, "aggs": {
        "pc": {"percentiles": {"field": "bytes", "percents": [50, 95, 99],
                               "tdigest": {"compression": 20000}}},
        "cb": {"cardinality": {"field": "bytes"}},
        "cs": {"cardinality": {"field": "status"}}}},
        {"pc": {"values": {str(float(p)): float(np.percentile(vals, p))
                           for p in (50, 95, 99)}},
         "cb": {"value": len(np.unique(vals))},
         "cs": {"value": len(np.unique(status[m]))}}, None))
    q, m = rng(6, 18)
    out.append(("filters", {"query": q, "size": 0, "aggs": {
        "err": {"filters": {"filters": {
            "4xx": {"range": {"status": {"gte": 400, "lt": 500}}},
            "5xx": {"range": {"status": {"gte": 500}}}}}}}},
        {"err": {"buckets": {
            "4xx": {"doc_count": int((m & (status >= 400)
                                      & (status < 500)).sum())},
            "5xx": {"doc_count": int((m & (status >= 500)).sum())}}}},
        None))
    ranges = [(None, 1000.0), (1000.0, 10000.0), (10000.0, None)]
    rb = []
    for frm, to in ranges:
        sel = has_b.copy()
        if frm is not None:
            sel &= b64 >= frm
        if to is not None:
            sel &= b64 < to
        b = {"key": f"{frm if frm is not None else '*'}-"
                    f"{to if to is not None else '*'}"}
        if frm is not None:
            b["from"] = frm
        if to is not None:
            b["to"] = to
        b["doc_count"] = int(sel.sum())
        b["avg_b"] = o_metric("avg", b32[sel])
        rb.append(b)
    out.append(("range_bytes", {"size": 0, "aggs": {"r": {"range": {
        "field": "bytes", "ranges": [{k: v for k, v in (("from", f),
                                                         ("to", t))
                                      if v is not None}
                                     for f, t in ranges]},
        "aggs": {"avg_b": {"avg": {"field": "bytes"}}}}}},
        {"r": {"buckets": rb}}, None))
    q, m = rng(0, 24)
    out.append(("calendar_hour", {"query": q, "size": 0, "aggs": {
        "h": {"date_histogram": {"field": "@timestamp",
                                 "calendar_interval": "hour"}}}},
        {"h": o_histogram(ts, m, float(HOUR_MS), True)}, None))
    q, m = rng(0, 6)
    hist = o_histogram(ts, m, float(HOUR_MS), True)
    steps = np.floor(ts / HOUR_MS).astype(np.int64)
    for b in hist["buckets"]:
        b["st"] = o_numeric_terms(
            status[m & (steps == int(b["key"] // HOUR_MS))])
    out.append(("date_histogram_host", {"query": q, "size": 0, "aggs": {
        "h": {"date_histogram": {"field": "@timestamp",
                                 "fixed_interval": "1h"},
              "aggs": {"st": {"terms": {"field": "status"}}}}}},
        {"h": hist}, None))
    q, m = rng(1, 3)
    v = b64[m & has_b]
    var = float(v.var())
    out.append(("extended_stats", {"query": q, "size": 0, "aggs": {
        "es": {"extended_stats": {"field": "bytes"}}}},
        {"es": {"count": len(v), "min": float(v.min()),
                "max": float(v.max()), "avg": float(v.mean()),
                "sum": float(v.sum()),
                "sum_of_squares": float((v ** 2).sum()),
                "variance": var, "std_deviation": float(np.sqrt(var))}},
        None))
    q, m = rng(4, 8)
    hit = m & (status == 500)
    out.append(("post_filter", {"query": q, "size": 10,
                                "_source": False,
                                "post_filter": {"term": {"status": 500}},
                                "aggs": {"st": {"terms": {
                                    "field": "status"}}}},
                {"st": o_numeric_terms(status[m])},
                (np.nonzero(hit)[0][:10], int(hit.sum()))))
    matched = oracle.bm25(text) > 0
    out.append(("global", {"query": {"match": {"title": text}}, "size": 0,
                           "aggs": {"g": {"global": {}, "aggs": {
                               "avg_b": {"avg": {"field": "bytes"}}}}}},
                {"g": {"doc_count": oracle.n,
                       "avg_b": o_metric("avg", b32[has_b])}},
                (np.zeros(0, np.int64), int(matched.sum()))))
    return out


def profiled_ms(fn, reps):
    """(the kernels' summed device ms per call under torch.profiler,
    kernel launches per call, host ms per call with its readback)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = kernel_rows(prof.key_averages())
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    return (sum(self_dev(e) for e in kernels) / reps / 1e3,
            sum(e.count for e in kernels) / reps, float(np.median(host)))


def collector_timings(node, bench_mask, logs_mask, reps=10):
    """Each collector's device ms at 2M docs against its byte bound
    (each input read once, each output written once, at 3.35 TB/s), the
    agg mask's readback and re-upload, and the host bucket-id
    arithmetic of a 30-minute date_histogram over the whole column."""
    import torch

    from elasticsearch_tpu_torch.ops import aggs as agg_ops
    from elasticsearch_tpu_torch.ops.device import readback
    from elasticsearch_tpu_torch.search.aggregations import _upload
    hyb = node.device_cache.get(node.indices["hybrid"].engine.segments[0])
    logs = node.device_cache.get(node.indices["logs"].engine.segments[0])
    perm, starts = hyb.keyword_ord_major("cat")
    tmask = _upload(hyb, bench_mask)
    lmask = _upload(logs, logs_mask)
    ts = logs.segment.numerics["@timestamp"].values
    steps = np.floor(np.nan_to_num(ts) / 1_800_000.0).astype(np.int64)
    lo = int(steps.min())
    nb = int(steps.max()) - lo + 1
    ids = _upload(logs, np.clip(steps - lo, 0, nb - 1).astype(np.int32))
    vals, miss = logs.numerics["bytes"], logs.numeric_missing["bytes"]
    nd, nh = logs.n_docs_padded, hyb.n_docs_padded
    n_terms = len(starts) - 1
    cases = {
        "terms_counts_per_term": (
            lambda: agg_ops.terms_counts_per_term(perm, starts, tmask),
            4 * len(perm) + nh + 8 * (n_terms + 1) + 4 * n_terms,
            len(perm)),
        "masked_metric_stats": (
            lambda: agg_ops.masked_metric_stats(vals, miss, lmask),
            6 * nd + 40, 4 * nd),
        "bucket_counts": (
            lambda: agg_ops.bucket_counts(ids, lmask, nb),
            5 * nd + 4 * nb, nd),
        "bucket_metric_columns": (
            lambda: agg_ops.bucket_metric_columns(ids, lmask, vals, miss,
                                                  nb),
            10 * nd + 20 * nb, 5 * nd),
    }
    out = {}
    for name, (fn, n_bytes, n_ops) in cases.items():
        dev_ms, kernels, host_ms = profiled_ms(fn, reps)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "float32")
        out[name] = dict(device_ms=dev_ms, kernels=kernels,
                         host_ms=host_ms, bound_ms=b_ms, bound_by=b_by,
                         bytes=n_bytes, over_bound=dev_ms / b_ms)
    up, back, arith = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = readback("search.searcher.agg_mask", lmask[: logs.n_docs])
        t1 = time.perf_counter()
        _upload(logs, m)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        s = np.floor(np.nan_to_num(ts) / 1_800_000.0).astype(np.int64)
        np.clip(s - lo, 0, nb - 1).astype(np.int32)
        t3 = time.perf_counter()
        back.append((t1 - t0) * 1e3)
        up.append((t2 - t1) * 1e3)
        arith.append((t3 - t2) * 1e3)
    out["mask"] = dict(bytes=logs.n_docs, readback_ms=float(np.median(back)),
                       upload_ms=float(np.median(up)))
    out["bucket_ids_host_ms"] = float(np.median(arith))
    return out


def phase_aggs(node, port, corpus, queries, logs, cols, conns, counters,
               cpu):
    """Aggregations on one H100. (a) The reference bench's
    match+terms-agg row (``bench.py:1149-1154``) on the "hybrid" index,
    whose segment holds the bench's skewed 500-term ``cat`` keyword
    column (``corpus.py bench_cat``, installed through
    ``segment_from_numpy``): 32 bodies (match, size 0, terms on cat)
    from 16 Python clients, each equal to a float64 oracle (the exact
    per-category counts of the docs holding a query term) and to the
    port's CPU execution. (b) A Kibana-style mix on "logs" (phase 5's
    index), each body held to its float64 oracle and to the CPU. The
    launches of each collector of ops/aggs.py and of the contribution
    kernel in (a) and (b) are counted and must all be > 0. (c) The
    collectors' device ms at 2M docs against their byte bounds, the agg
    mask's round trip and the host bucket-id arithmetic. (d) The bench
    bodies from the C++ load generator (a warm round, then 4)."""
    import torch

    from elasticsearch_tpu_torch.corpus import (LOGS_T0_MS, bench_cat,
                                                dense_scores, term_name)
    from elasticsearch_tpu_torch.ops import aggs as agg_ops
    from elasticsearch_tpu_torch.rest.native_http import loadgen
    from elasticsearch_tpu_torch.telemetry.engine import TRACKER
    hybrid = node.indices["hybrid"]
    svc_logs = node.indices["logs"]
    n = len(corpus["lens"])
    cat, _terms = bench_cat(n)
    texts = [" ".join(term_name(t) for t in q) for q in queries[:32]]
    bench = [{"query": {"match": {"title": t}}, "size": 0,
              "aggs": {"cats": {"terms": {"field": "cat"}}}} for t in texts]
    oracle = LogsOracle(logs, cols)
    t0 = time.time()
    matched = [dense_scores(corpus, q) > 0 for q in queries[:32]]
    mix = logs_agg_mix(oracle, texts[0])
    log(f"[aggs] oracles in {time.time() - t0:.1f} s")
    # the collectors are PyTorch ops, not kernels: the tracker counts
    # their calls
    fns = {name: getattr(agg_ops, name).kernel_name
           for name in AGG_COLLECTORS}
    calls0 = {name: TRACKER.calls(k) for name, k in fns.items()}
    for fn in counters.values():
        fn.launches = 0
    # the main run: the bench bodies, then the logs mix, over HTTP
    res, lat, wall = drive(port, bench, 16, "hybrid")
    mres, mlat, mwall = drive(port, [b for _, b, _, _ in mix], 8, "logs")
    launches = {name: fn.launches for name, fn in counters.items()}
    launches.update({name: TRACKER.calls(k) - calls0[name]
                     for name, k in fns.items()})
    check(all(launches[name] > 0 for name in AGG_COLLECTORS)
          and launches["gather_bm25_contrib"] > 0,
          f"every collector and the contribution kernel launched in the "
          f"aggs phase: {launches}")
    t0 = time.time()
    for i, ((st, r), body, m) in enumerate(zip(res, bench, matched)):
        what = f"terms-agg bench body {i}"
        check(st == 200, f"{what} -> {st} {r}")
        counts = np.bincount(cat[m], minlength=500)
        order = np.lexsort((np.arange(500), -counts))
        top = [int(o) for o in order[:10] if counts[o] > 0]
        want = {"cats": {
            "doc_count_error_upper_bound": 0,
            "sum_other_doc_count": int(counts.sum()
                                       - counts[top].sum()),
            "buckets": [{"key": f"c{o:03d}", "doc_count": int(counts[o])}
                        for o in top]}}
        check(r["hits"]["total"] == {"value": int(m.sum()),
                                     "relation": "eq"}, f"{what}: total")
        check(r["aggregations"]["cats"]["buckets"][0]["doc_count"] > 0,
              f"{what}: the bench's check")
        agg_equal(r["aggregations"], want, what)
        c = cpu.search("hybrid", hybrid, body)
        check(c["hits"]["total"] == r["hits"]["total"], f"{what}: CPU total")
        agg_equal(r["aggregations"], c["aggregations"], f"{what} vs the CPU")
    kinds = {}
    for (kind, body, want, hits), (st, r) in zip(mix, mres):
        what = f"logs aggs body {kind}"
        check(st == 200, f"{what} -> {st} {r}")
        agg_equal(r["aggregations"], want, what)
        if hits is not None:
            ids, total = hits
            check(r["hits"]["total"]["value"] == total, f"{what}: total")
            check([int(h["_id"]) for h in r["hits"]["hits"]]
                  == [int(i) for i in ids], f"{what}: hits")
        c = cpu.search("logs", svc_logs, body)
        check(c["hits"]["total"] == r["hits"]["total"]
              and [h["_id"] for h in c["hits"]["hits"]]
              == [h["_id"] for h in r["hits"]["hits"]],
              f"{what}: hits vs the CPU")
        agg_equal(r["aggregations"], c["aggregations"], f"{what} vs the CPU")
        kinds[kind] = dict(
            latency_ms=mlat[len(kinds)] * 1e3,
            buckets=sum(len(v.get("buckets", ())) for v in
                        r["aggregations"].values() if isinstance(v, dict)))
    log(f"[aggs] {len(bench) + len(mix)} answers held to the oracle and the "
        f"CPU in {time.time() - t0:.1f} s")
    out = dict(docs=n, launches=launches,
               bench=dict(bodies=len(bench), wall_s=wall,
                          python_clients=16, p50_ms=p50_p99(lat)[0],
                          p99_ms=p50_p99(lat)[1]),
               logs=dict(bodies=len(mix), wall_s=mwall, python_clients=8,
                         kinds=kinds))
    # (c) the collectors alone
    torch.cuda.synchronize()
    q_mask = oracle.range_mask("@timestamp", LOGS_T0_MS + 2 * HOUR_MS,
                               LOGS_T0_MS + 14 * HOUR_MS)
    out["collectors"] = collector_timings(node, matched[0], q_mask)
    # (d) the bench bodies from the load generator: a warm round, then 4
    f0 = node.http_stats()
    loadgen(port, "/hybrid/_search", bench, conns, len(bench))
    lg = loadgen(port, "/hybrid/_search", bench, conns, len(bench) * 4)
    check(lg["done"] == len(bench) * 4 and lg["non2xx"] == 0,
          f"the load generator's terms-agg requests all done with 2xx: {lg}")
    out["loadgen"] = dict(
        conns=conns, requests=lg["done"], wall_s=lg["wall_s"],
        qps=lg["done"] / lg["wall_s"], p50_ms=p50_p99(lg["lat_s"])[0],
        p99_ms=p50_p99(lg["lat_s"])[1], front=front_since(node, f0))
    log(f"[aggs] {out}")
    return out


# ---------------------------------------------------------------- phase 9
# PyTorch's caching allocator rounds a block up to a multiple of 512 B,
# and does not split a cached large block (over 1 MiB) whose remainder
# would be 1 MiB or less: memory_allocated() counts each tensor's block,
# up to 512 B (a small tensor) or 512 B + 1 MiB (a large one) above its
# bytes. Its requested_bytes count the tensors' own bytes.
ALLOC_ROUND_B = 512
LARGE_BLOCK_B = 1 << 20


def alloc_slack(sizes) -> int:
    """The most memory_allocated() may count above tensors of ``sizes``
    bytes."""
    return sum(ALLOC_ROUND_B + (LARGE_BLOCK_B if n > LARGE_BLOCK_B else 0)
               for n in sizes)


def held_sizes(dev):
    """The bytes of each tensor a DeviceSegment holds on the card."""
    from elasticsearch_tpu_torch.ops.device import _tensors
    sizes = [int(t.nbytes) for _c, t in dev._fixed_tensors()]
    sizes += [int(m.nbytes) for m, _h in dev._filter_masks.values()]
    sizes += [int(e[0].nbytes) for e in dev._kw_ord_major.values()
              if e is not None]
    sizes += [b for b in dev._bound_bytes.values() if b]
    sizes += [int(t.nbytes) for dp in dev.postings.values()
              for v in dp._derived.values() for t in _tensors(v)]
    return sizes


def device_bytes():
    """(memory_allocated(), requested bytes) once the card and the
    collector settled."""
    import gc

    import torch
    gc.collect()
    torch.cuda.synchronize()
    return (torch.cuda.memory_allocated(),
            torch.cuda.memory_stats()["requested_bytes.all.current"])


def bytes_agree(row, what):
    """A build's requested bytes are its accounted bytes, and its
    allocated bytes within the allocator's rounding of them."""
    check(row["requested"] == row["hbm_bytes"]
          and 0 <= row["allocated"] - row["hbm_bytes"] <= row["slack"],
          f"{what}: requested == hbm_bytes and allocated within the "
          f"allocator's rounding: {row}")


def measure_builds(device_type: str = "cuda"):
    """Make the device cache build DeviceSegments that measure
    ``torch.cuda.memory_allocated()`` across their own build on
    ``device_type`` (synchronized, after ``gc.collect()``); returns the
    list each build appends (name, allocated, hbm_bytes, tensors) to."""
    import torch

    from elasticsearch_tpu_torch.ops.device import DeviceSegment
    from elasticsearch_tpu_torch.search import context
    builds = []

    class MeasuredSegment(DeviceSegment):
        def __init__(self, segment, device=None,
                     vector_dtype=torch.bfloat16):
            cuda = torch.device(device or "cuda").type == device_type
            if cuda:
                a0, r0 = device_bytes()
            super().__init__(segment, device, vector_dtype)
            if cuda:
                a1, r1 = device_bytes()
                builds.append(dict(
                    name=self.name, allocated=a1 - a0, requested=r1 - r0,
                    hbm_bytes=self.hbm_bytes(),
                    slack=alloc_slack(held_sizes(self))))

    context.DeviceSegment = MeasuredSegment
    return builds


def hbm_agrees(node, phase, out):
    """After a phase: the hbm breaker holds what the resident segments
    hold (``engine.hbm.total_bytes``); ``memory_allocated()`` is printed
    beside it (the gap is what no segment owns: the fast path's tables
    and mask stacks, cohort buffers)."""
    import torch
    torch.cuda.synchronize()
    br = node.breaker_service.get_breaker("hbm")
    hbm = node.device_cache.hbm_stats()
    row = dict(phase=phase, breaker_used=br.used,
               total_bytes=hbm["total_bytes"], segments=hbm["segments"],
               memory_allocated=torch.cuda.memory_allocated())
    out.append(row)
    log(f"[accounting] after {phase}: {row}")
    check(br.used == hbm["total_bytes"],
          f"after {phase}: breaker.used {br.used} == engine.hbm.total_bytes "
          f"{hbm['total_bytes']}")


def lazy_build(node, dev, build, what):
    """One lazy build on a resident segment: the bytes it adds to the
    card (requested; allocated within the allocator's rounding) equal
    the bytes its segment's classes gain and the breaker's charge
    gains; returns the row."""
    br = node.breaker_service.get_breaker("hbm")
    h0, u0, n0 = dev.hbm_bytes(), br.used, held_sizes(dev)
    a0, r0 = device_bytes()
    build()
    a1, r1 = device_bytes()
    new = list(held_sizes(dev))
    for n in n0:
        new.remove(n)
    row = dict(what=what, allocated=a1 - a0, requested=r1 - r0,
               hbm_bytes=dev.hbm_bytes() - h0, breaker=br.used - u0,
               slack=alloc_slack(new))
    check(row["hbm_bytes"] > 0 and row["breaker"] == row["hbm_bytes"],
          f"lazy build {what}: the breaker charged the bytes: {row}")
    bytes_agree(row, f"lazy build {what}")
    return row


def lru_prediction(order, capacity):
    """(admissions, evictions) of an LRU of ``capacity`` over ``order``."""
    from collections import OrderedDict
    lru = OrderedDict()
    adm = ev = 0
    for name in order:
        if name in lru:
            lru.move_to_end(name)
            continue
        adm += 1
        if len(lru) == capacity:
            lru.popitem(last=False)
            ev += 1
        lru[name] = True
    return adm, ev


def front_pin_check(node, queries, k, evicted):
    """The C++ front's registration must not pin an evicted segment: the
    started node registers its front index, plan bodies on indices that
    are not resident evict it, and its memory returns to the card with
    the front unregistered; the drain's refresh does not admit it
    again."""
    cache, fp = node.device_cache, node.fastpath
    node.start(0)
    check(cache.wait_evictions_heard(timeout=60),
          "the eviction listeners heard every eviction")
    front = fp.front_registration()
    check(front is not None, "the front registered an index")
    f_name = front["segment"].name
    stack_bytes = int(front["masks"].nbytes)
    del front
    resident = list(cache._devices())
    others = [f"ev{i}" for i in range(4) if f"ev{i}" not in resident]
    check(f_name in resident, f"{f_name} is resident: {resident}")
    before = {name: d.hbm_bytes() for name, d in cache._devices().items()}
    evicted.clear()
    a0, r0 = device_bytes()
    # the front's index is the most recently used: admit others until
    # it goes
    for name in others:
        st, _ = node.rest_controller.dispatch(
            "POST", f"/{name}/_search", {}, plan_body(queries[3], k))
        check(st == 200, f"plan body on {name}")
        if cache.resident(f_name) is None:
            break
    check(cache.wait_evictions_heard(timeout=60),
          "the eviction listeners heard every eviction")
    a1, r1 = device_bytes()
    after = {name: d.hbm_bytes() for name, d in cache._devices().items()}
    check(f_name in evicted and f_name not in after
          and fp.front_registration() is None,
          f"the front's {f_name} was evicted and unregistered: {evicted}")
    gone = sum(before[name] for name in evicted)
    came = sum(after[name] for name in after if name not in before)
    drop = dict(front=f_name, evicted=list(evicted), evicted_bytes=gone,
                admitted_bytes=came, mask_stack_bytes=stack_bytes,
                requested_delta=r1 - r0, allocated_delta=a1 - a0)
    check(abs((r1 - r0) - (came - gone - stack_bytes))
          <= ALLOC_ROUND_B * 64,
          f"the front's evicted segment returns its memory: {drop}")
    adm0 = cache.churn_counters()[0]
    node.refresh_front()
    check(cache.churn_counters()[0] == adm0
          and fp.front_registration() is None,
          "the drain's refresh does not admit the evicted front index")
    log(f"[accounting] the front's eviction frees: {drop}")
    return drop


def eviction_check(corpus, queries, k=100):
    """A second node holding four indices of one segment each (the
    phase-4 corpus, with the bench's ``cat`` column) under an hbm limit
    of 2.5 segments: 32 plan bodies in a fixed order of indices equal
    the CPU execution, and the segment admissions and breaker evictions
    are those of an LRU of two; lazy builds on a resident segment add
    the bytes they charge; a segment evicted while the fast path holds
    a registration of it returns its memory; a third node whose limit
    is below one segment answers 429 and still serves an index that
    fits."""
    import gc

    import torch

    from elasticsearch_tpu_torch.corpus import (bench_cat,
                                                segment_from_corpus,
                                                term_name)
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops.device import DeviceSegment
    from elasticsearch_tpu_torch.search.context import DeviceSegmentCache
    from elasticsearch_tpu_torch.search.queries import parse_query
    from elasticsearch_tpu_torch.search.searcher import ShardSearcher
    n = len(corpus["lens"])
    cat = dict(zip(("ords", "terms"), bench_cat(n)))
    segs = [segment_from_corpus(corpus, name=f"ev{i}",
                                keywords={"cat": cat}) for i in range(4)]
    one_dev = DeviceSegment(segs[0], "cuda")
    one = one_dev.hbm_bytes()
    del one_dev
    gc.collect()
    limit = int(2.5 * one)
    out = dict(segment_bytes=one, limit=limit)
    node = Node(device="cuda",
                settings={"indices.breaker.hbm.limit": limit})
    try:
        for i, seg in enumerate(segs):
            node.create_index(f"ev{i}", {"properties": {
                "title": {"type": "text"}, "cat": {"type": "keyword"}}})
            node.indices[f"ev{i}"].engine.install_segments([seg])
        cache = node.device_cache
        br = node.breaker_service.get_breaker("hbm")
        evicted = []
        cache.add_evict_listener(evicted.extend)
        pattern = [0, 1, 0, 2, 3, 1, 0, 3, 3, 2, 1, 1, 0, 2, 2, 3]
        order = [f"ev{pattern[i % len(pattern)]}" for i in range(32)]
        bodies = [plan_body(queries[i], k) for i in range(32)]
        adm0, ev0 = cache.churn_counters()
        results = []
        t0 = time.time()
        for name, body in zip(order, bodies):
            results.append(node.rest_controller.dispatch(
                "POST", f"/{name}/_search", {}, body))
            check(br.used <= limit and br.used == cache.hbm_stats()[
                "total_bytes"], f"the breaker holds the residents: {br.used}")
        out["plan_s"] = time.time() - t0
        adm, ev = cache.churn_counters()
        check(cache.wait_evictions_heard(timeout=60),
              "the eviction listeners heard every eviction")
        want = lru_prediction(order, 2)
        out.update(admissions=adm - adm0, breaker_evictions=ev - ev0,
                   predicted=dict(admissions=want[0], evictions=want[1]))
        check((adm - adm0, ev - ev0) == want,
              f"admissions and evictions {(adm - adm0, ev - ev0)} are the "
              f"LRU's {want}")
        check(len(evicted) == want[1], "every eviction reached the listener")
        cpu = ShardSearcher([segs[0]], node.indices["ev0"].mapper,
                            DeviceSegmentCache("cpu"))
        t0 = time.time()
        for i, (body, (st, r)) in enumerate(zip(bodies, results)):
            check(st == 200, f"eviction plan body {i} -> {st} {r}")
            res = cpu.query_phase(parse_query(body["query"]), k)
            hits_match_cpu(r, res, [segs[0]], 0,
                           f"eviction plan body {i} ({order[i]})")
        log(f"[accounting] 32 plan bodies over 4 indices under 2.5 "
            f"segments equal to the CPU ({time.time() - t0:.1f} s)")
        # lazy builds on the most recently used resident
        dev = cache.resident(order[-1])
        t = int(queries[0][0])
        out["lazy_builds"] = [
            lazy_build(node, dev, lambda: dev.filter_mask(
                "title", (term_name(t),)), "filter_mask"),
            lazy_build(node, dev, lambda: dev.keyword_ord_major("cat"),
                       "keyword_ord_major")]
        del dev
        # a registration of the fast path must not pin an evicted segment
        resident = [name for name in cache._devices()]
        a_name = next(f"ev{i}" for i in range(4)
                      if f"ev{i}" not in resident)
        others = [f"ev{i}" for i in range(4) if f"ev{i}" != a_name][:2]
        fast = match_body(queries[1], 10)
        st, r = node.rest_controller.dispatch("POST", f"/{a_name}/_search",
                                              {}, fast)
        check(st == 200 and a_name in node.fastpath._regs,
              f"the fast path registered {a_name}: {st}")
        reg = node.fastpath._regs[a_name]
        stack_bytes = int(reg["masks"].nbytes)
        del reg
        before = {name: d.hbm_bytes()
                  for name, d in cache._devices().items()}
        evicted.clear()
        a0, r0 = device_bytes()
        for name in others:
            st, _ = node.rest_controller.dispatch(
                "POST", f"/{name}/_search", {}, plan_body(queries[2], k))
            check(st == 200, f"plan body on {name}")
        check(cache.wait_evictions_heard(timeout=60),
              "the eviction listeners heard every eviction")
        a1, r1 = device_bytes()
        after = {name: d.hbm_bytes()
                 for name, d in cache._devices().items()}
        check(a_name in evicted and a_name not in after,
              f"{a_name} was evicted: {evicted}")
        gone = sum(before[name] for name in evicted)
        came = sum(after[name] for name in after if name not in before)
        drop = dict(evicted=list(evicted), evicted_bytes=gone,
                    admitted_bytes=came, mask_stack_bytes=stack_bytes,
                    requested_delta=r1 - r0, allocated_delta=a1 - a0)
        out["pin_check"] = drop
        check(abs((r1 - r0) - (came - gone - stack_bytes))
              <= ALLOC_ROUND_B * 64,
              f"an evicted segment's memory (its registration's included) "
              f"returns to the card: {drop}")
        log(f"[accounting] eviction frees: {drop}")
        out["front_pin_check"] = front_pin_check(node, queries, k, evicted)
    finally:
        node.close()
    del node, cache
    # a limit below one segment: 429, and an index that fits still serves
    node = Node(device="cuda",
                settings={"indices.breaker.hbm.limit": one // 2})
    try:
        node.create_index("big", {"properties": {"title": {"type": "text"}}})
        node.indices["big"].engine.install_segments([segs[0]])
        node.create_index("small", {"properties": {"title":
                                                   {"type": "text"}}})
        lines = "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                        + json.dumps({"title": f"t{i:06d} small doc"})
                        + "\n" for i in range(50))
        st, r = node.rest_controller.dispatch("POST", "/small/_bulk",
                                              {"refresh": "true"}, lines)
        check(st == 200 and not r["errors"], "bulk into small")
        a0, r0 = device_bytes()
        st, r = node.rest_controller.dispatch(
            "POST", "/big/_search", {}, plan_body(queries[0], k))
        a1, r1 = device_bytes()
        err = r.get("error", {})
        check(st == 429 and err.get("type") == "circuit_breaking_exception"
              and err.get("bytes_wanted") == one
              and err.get("bytes_limit") == one // 2,
              f"a limit below one segment answers 429 with bytes_wanted "
              f"{one}: {st} {r}")
        check(r1 - r0 <= ALLOC_ROUND_B * 64,
              f"the refused segment left nothing on the card "
              f"({r1 - r0} B requested, {a1 - a0} B allocated)")
        st, r = node.rest_controller.dispatch(
            "POST", "/small/_search", {}, {"query": {"match": {
                "title": "small"}}})
        check(st == 200 and r["hits"]["total"]["value"] == 50,
              f"an index that fits still serves: {st}")
        out["trip"] = dict(status=429, bytes_wanted=one,
                           bytes_limit=one // 2, trips=node.breaker_service
                           .get_breaker("hbm").trip_count,
                           requested_after=r1 - r0,
                           allocated_after=a1 - a0)
    finally:
        node.close()
    return out


def same_hits(a, b, what, rtol=1e-5):
    """Two answers to one body: equal totals, scores within ``rtol``, and
    equal ids up to the order of scores that tie within ``rtol`` (one of
    them ranked in float64 on a fast lane, the other in float32)."""
    check(a["hits"]["total"] == b["hits"]["total"], f"{what}: totals")
    ha, hb = a["hits"]["hits"], b["hits"]["hits"]
    check(len(ha) == len(hb), f"{what}: hit count")
    sa = np.array([h["_score"] for h in ha], np.float64)
    sb = np.array([h["_score"] for h in hb], np.float64)
    check(np.allclose(sa, sb, rtol=rtol, atol=0), f"{what}: scores")
    if len(sa):
        kth = sa[-1]
        firm = np.abs(sa - kth) > rtol * abs(kth)
        check({h["_id"] for h, f in zip(ha, firm) if f}
              == {h["_id"] for h, f in zip(hb, firm) if f},
              f"{what}: the ids above the kth score's ties")


def profile_tree_ok(shard, kernels, what):
    q = shard["searches"][0]["query"][0]
    bd = q["breakdown"]
    check(bd["device_time_in_nanos"] + bd["host_time_in_nanos"]
          == q["time_in_nanos"] > 0,
          f"{what}: device + host nanos == time_in_nanos")
    listed = {k["kernel"] for k in shard.get("device", {}).get("kernels",
                                                              [])}
    check(kernels <= listed, f"{what}: the profile lists {sorted(kernels)}"
                             f" (got {sorted(listed)})")
    return sorted(listed)


def tracked_call_costs(node, seg, queries, reps=5, n=64):
    """Host µs of one tracked call against the bare call at the v2m
    cohort's shape (the contribution kernel and the merge), with and
    without the node's flight recorder ambient; host µs of one flight
    recorder event."""
    import torch

    from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
    from elasticsearch_tpu_torch.ops.merge import merge_sorted_slots
    from elasticsearch_tpu_torch.search.fastpath import (N_SLOTS,
                                                         NB_BUCKETS, Q_BATCH)
    from elasticsearch_tpu_torch.telemetry import flightrecorder
    fp = node.fastpath
    reg = fp.register("bench", seg, "title", 1.2, 0.75)
    cohort = [q for q in queries
              if fp._v2_bucket(reg, q) is not None][:Q_BATCH]
    sel, ws = fp.assemble_cohort(reg, NB_BUCKETS[-1], cohort)
    dp = reg["dp"]
    dev = fp.device
    args = (dp.block_docids, dp.block_tfs, torch.from_numpy(sel).to(dev),
            torch.from_numpy(ws).to(dev), dp.doc_lens, reg["masks"],
            torch.zeros(Q_BATCH, dtype=torch.int32, device=dev),
            float(dp.avg_len), 1.2, 0.75)
    keys, _ = gather_bm25_contrib.__wrapped__(*args)
    q, p = keys.shape
    lane = torch.arange(p, dtype=torch.int32, device=dev).repeat(q, 1)
    margs = (keys.reshape(q, N_SLOTS, p // N_SLOTS),
             lane.view(q, N_SLOTS, p // N_SLOTS))

    def host_us(fn, a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*a)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        return host / n * 1e6

    out = {}
    for name, fn, a in (("gather_bm25_contrib", gather_bm25_contrib, args),
                        ("merge_sorted_slots", merge_sorted_slots, margs)):
        runs = {"bare": [], "tracked": [], "tracked_flight": []}
        for _ in range(reps):
            runs["bare"].append(host_us(fn.__wrapped__, a))
            runs["tracked"].append(host_us(fn, a))
            with flightrecorder.activate(node.flight):
                runs["tracked_flight"].append(host_us(fn, a))
            runs["bare"].append(host_us(fn.__wrapped__, a))
        out[name] = {k: float(np.median(v)) for k, v in runs.items()}
        out[name]["shape"] = [list(t.shape) for t in a
                              if isinstance(t, torch.Tensor)]
    fr = flightrecorder.FlightRecorder(node="cost")
    m = 20000
    t0 = time.perf_counter()
    for _ in range(m):
        fr.record_launch("k", "sel[32x4096]int32", dispatch_ns=1000,
                         cohort=32, capacity=32)
    out["flight_event_us"] = (time.perf_counter() - t0) / m * 1e6
    return out


def phase_accounting(node, port, corpus, queries, knn_dims, builds,
                     counters, hbm_log):
    """Device accounting and launch attribution on one H100 (module
    docstring, phase 9)."""
    import torch

    from elasticsearch_tpu_torch.corpus import bench_cat, term_name
    from elasticsearch_tpu_torch.ops.device import READBACKS
    from elasticsearch_tpu_torch.telemetry.engine import TRACKER
    out = {}
    # (a, b) eviction, pins and the 429 on nodes of their own; then every
    # segment built on the card in the run: its allocated bytes are its
    # hbm_bytes, within the allocator's rounding per tensor
    out["eviction"] = eviction_check(corpus, queries)
    hbm_agrees(node, "eviction nodes", hbm_log)
    out["builds"] = builds
    check(builds, "segments were built on the card")
    for b in builds:
        bytes_agree(b, f"the build of {b['name']}")
    log(f"[accounting] {len(builds)} segment builds measured: {builds}")
    # (c) attribution over the fast-path, plan, dense, kNN and aggs bodies
    rng = np.random.default_rng(11)
    qv = rng.standard_normal((4, knn_dims))
    qv = np.round(qv / np.linalg.norm(qv, axis=1, keepdims=True), 4)

    def names(q):
        return " ".join(term_name(t) for t in q)
    kinds = {
        "fast": ("bench", [match_body(q, 100) for q in queries[:8]]),
        "plan": ("bench", [plan_body(q, 100) for q in queries[8:16]]),
        "dense": ("logs", [{"query": {"match": {"title": names(q)}},
                            "sort": [{"bytes": "desc"}], "size": 20}
                           for q in queries[16:24]]),
        "knn": ("knn", [{"knn": {"field": "vec",
                                 "query_vector": v.tolist(), "k": 100,
                                 "num_candidates": 300},
                         "size": 100, "_source": False} for v in qv]),
        "aggs": ("hybrid", [{"query": {"match": {"title": names(q)}},
                             "size": 0, "aggs": {"cats": {"terms": {
                                 "field": "cat"}}}}
                            for q in queries[24:28]]),
    }
    fp = node.fastpath
    _, k0 = http(port, "GET", "/_kernels")
    for c in counters.values():
        c.launches = 0
    fr0 = node.flight.aggregates()
    calls0 = TRACKER.totals()["calls"]
    rb0 = sum(READBACKS.values())
    s0, t_dev0 = fp.stats["cohorts"], fp.timing["device_s"]
    answers = {}
    for kind, (index, bodies) in kinds.items():
        res, _lat, _wall = drive(port, bodies, 4, index)
        for i, (st, r) in enumerate(res):
            check(st == 200, f"attribution {kind} body {i} -> {st} {r}")
        answers[kind] = res
    _, k1 = http(port, "GET", "/_kernels")
    fr1 = node.flight.aggregates()
    launches = {name: c.launches for name, c in counters.items()}
    calls = {name: k1["kernels"].get(name, {}).get("calls", 0)
             - k0["kernels"].get(name, {}).get("calls", 0)
             for name in counters}
    check(calls == launches and all(v > 0 for v in launches.values()),
          f"/_kernels calls equal the launches counted at the kernels' "
          f"launch sites: {calls} vs {launches}")
    tracked = TRACKER.totals()["calls"] - calls0
    reads = sum(READBACKS.values()) - rb0
    ring = dict(launch_events=fr1["launches"] - fr0["launches"],
                tracked_calls=tracked,
                readback_events=fr1["readbacks"] - fr0["readbacks"],
                funnel_readbacks=reads,
                ring_events_new=len([
                    e for e in node.flight.events(limit=1 << 20)
                    if e["seq"] > fr0["ring"]["recorded_total"]]),
                capacity=fr1["ring"]["capacity"])
    check(ring["launch_events"] == tracked > 0
          and ring["readback_events"] == reads > 0
          and ring["ring_events_new"] == min(
              ring["capacity"], ring["launch_events"]
              + ring["readback_events"]),
          f"one flight event per tracked call and per funnel readback: "
          f"{ring}")
    cohorts = fp.stats["cohorts"] - s0
    out["attribution"] = dict(
        launches=launches, kernels_calls=calls, ring=ring,
        fast_cohorts=cohorts,
        drain_launch_to_readback_ms=((fp.timing["device_s"] - t_dev0)
                                     / max(1, cohorts) * 1e3))
    log(f"[accounting] attribution: {out['attribution']}")
    # profile: true on one body of each kind
    expect = {"fast": {"plan_topk_batch"}, "plan": {"plan_topk_batch"},
              "dense": {"bm25_dense_scores_sorted", "gather_bm25_contrib",
                        "masked_topk"},
              "knn": {"knn_nominate_batch"},
              "aggs": {"terms_counts", "bm25_dense_scores_sorted",
                       "gather_bm25_contrib"}}
    prof = {}
    for kind, (index, bodies) in kinds.items():
        body = bodies[0]
        _, plain = answers[kind][0]
        st, r = http(port, "POST", f"/{index}/_search",
                     {**body, "profile": True})
        check(st == 200, f"profiled {kind} body -> {st} {r}")
        shard = r.pop("profile")["shards"][0]
        what = f"profile: true on the {kind} body"
        if kind in ("fast", "plan"):
            # the profiled fast body takes the plan path (float32), and
            # a plan body's cohort differs from the plain one's
            same_hits(r, plain, what, rtol=1e-5 if kind == "fast" else 1e-6)
        elif kind == "aggs":
            check(r["hits"] == plain["hits"], f"{what}: hits")
            agg_equal(r["aggregations"], plain["aggregations"], what)
        else:
            check(r["hits"] == plain["hits"], f"{what}: the same hits")
        prof[kind] = profile_tree_ok(shard, expect[kind], what)
    out["profile_kernels"] = prof
    # what it costs
    seg = node.indices["bench"].engine.segments[0]
    out["costs"] = tracked_call_costs(node, seg, queries)
    log(f"[accounting] costs: {out['costs']}")
    hbm_agrees(node, "accounting", hbm_log)
    out["hbm_after_phases"] = hbm_log
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=2_000_000)
    ap.add_argument("--vocab", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    # config 4 (pure kNN) and config 5 (hybrid) of the reference's
    # BASELINE: 8M x 768 cosine, and the scale corpus with 256-d vectors
    ap.add_argument("--knn-docs", type=int, default=8_000_000)
    ap.add_argument("--knn-dims", type=int, default=768)
    ap.add_argument("--knn-queries", type=int, default=16)
    ap.add_argument("--hybrid-dims", type=int, default=256)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is "
            "False); nothing was run")
        return 2
    try:
        from elasticsearch_tpu_torch.corpus import (LOGS_MAPPINGS,
                                                    bench_feat,
                                                    build_corpus,
                                                    logs_columns,
                                                    make_queries,
                                                    segment_from_corpus,
                                                    with_incident_terms)
        from elasticsearch_tpu_torch.node import Node
        from elasticsearch_tpu_torch.ops import _build
        from elasticsearch_tpu_torch.ops.bm25_contrib import \
            gather_bm25_contrib
        from elasticsearch_tpu_torch.ops.merge import merge_sorted_slots
        from elasticsearch_tpu_torch.rest import native_http
        from elasticsearch_tpu_torch.search.context import \
            DeviceSegmentCache
        from elasticsearch_tpu_torch.search.service import SearchService
    except ImportError as e:
        log(f"chip_smoke: the elasticsearch_tpu_torch package is not "
            f"beside this script ({e})")
        return 2
    # the fast path's registrations and bounces, with the phases' lines
    logging.basicConfig(stream=sys.stderr, level=logging.WARNING,
                        format="[%(name)s] %(message)s")
    logging.getLogger("elasticsearch_tpu_torch.fastpath").setLevel(
        logging.INFO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"gather_bm25_contrib": gather_bm25_contrib,
                "merge_sorted_slots": merge_sorted_slots}
    # every DeviceSegment built on the card measures itself (phase 9)
    builds = measure_builds()

    # ---- 1. build
    t0 = time.time()
    _build.build_all()
    log(f"[build] kernels built and loaded in {time.time() - t0:.2f} s "
        f"into {_build.build_dir()}")
    log(_build.build_log())
    t0 = time.time()
    native_http.get_lib()
    front_build_s = time.time() - t0
    log(f"[build] the C++ front built and loaded in {front_build_s:.2f} s "
        f"into {native_http.build_dir()}")

    # set-up: the seeded corpus and its query log
    t0 = time.time()
    rng = np.random.default_rng(args.seed)
    corpus = build_corpus(rng, n_docs=args.docs, vocab=args.vocab)
    queries = make_queries(rng, corpus["df"], n_docs=args.docs,
                           n_queries=args.queries)
    seg = segment_from_corpus(corpus)
    log(f"[setup] corpus {args.docs} docs, {corpus['block_docids'].shape[0]}"
        f" blocks, {len(queries)} queries in {time.time() - t0:.1f} s")
    filt_pool = np.nonzero(corpus["df"] > args.docs // 20)[0]

    # the hbm breaker's limit, sized so every phase fits (the reference's
    # default, the host total of 4 GiB, would refuse config 4's slab)
    hbm_limit = int(0.75 * torch.cuda.mem_get_info()[1])
    log(f"[accounting] indices.breaker.hbm.limit = {hbm_limit} B "
        f"(0.75 of the card's {torch.cuda.mem_get_info()[1]} B)")
    node = Node(device="cuda",
                settings={"indices.breaker.hbm.limit": hbm_limit})
    hbm_log = []
    try:
        node.create_index("bench", {"properties": {"title":
                                                   {"type": "text"}}})
        # the C++ front and the drain start with nothing to register;
        # the registration phase installs the corpus as bench's segment
        port = node.start(0)
        st, info = http(port, "GET", "/")
        check(st == 200, "GET /")

        # ---- 2. kernels vs twins; the v1 and v2 cohorts vs the CPU
        registration = phase_registration(node, seg)
        registration["front_build_s"] = front_build_s
        kern = phase_kernels(node, seg, queries, args.iters)
        lane_cohorts = phase_lane_cohorts(node, seg, queries, filt_pool)
        ess_cohorts = phase_essential_cohorts(node, seg, queries)
        hbm_agrees(node, "kernels", hbm_log)

        # ---- 3. REST, small: each fast lane, filters, the plan path
        with lane_launches(counters) as (small, _):
            rest_small = phase_rest_small(node, port, args.seed + 1)
        check(all(d["gather_bm25_contrib"] > 0 for d in small.values())
              and small["v2m"]["merge_sorted_slots"] > 0,
              f"every lane launched its kernels in the small REST phase: "
              f"{small}")
        rest_small["launches_per_lane"] = small
        plan_small, plan_small_bodies = phase_plan_small(node, port,
                                                         args.seed + 2)
        hbm_agrees(node, "rest small", hbm_log)

        # ---- 4. REST, at scale (the main path)
        fp = node.fastpath
        batcher = node.search_service.plan_batcher
        s0 = dict(fp.stats)
        p0 = batcher.stats()
        t_before = dict(fp.timing)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with lane_launches(counters) as (per_lane, taken):
            scale, lanes, bodies, results, oracles = phase_rest_scale(
                node, port, corpus, queries, args.clients, 1000, taken)
        launches = {n: fn.launches for n, fn in counters.items()}
        scale["launches_per_lane"] = per_lane
        scale["registration"] = registration
        scale["peak_bytes"] = torch.cuda.max_memory_allocated()
        cohorts = fp.stats["cohorts"] - s0["cohorts"]
        scale["cohorts"] = cohorts
        scale["cohorts_per_lane"] = {
            n: fp.stats[f"cohorts_{n}"] - s0[f"cohorts_{n}"]
            for n in ("v2m", "v1")}
        scale["mean_cohort_width"] = (fp.stats["fast_queries"]
                                      - s0["fast_queries"]) / max(1, cohorts)
        p1 = batcher.stats()
        scale["plan_cohorts"] = p1["launches"] - p0["launches"]
        scale["plan_queries"] = p1["batched_queries"] - p0["batched_queries"]
        check(scale["plan_queries"] == scale["served_plan"],
              f"the plan-served queries went through the PlanBatcher "
              f"({scale['plan_queries']} vs {scale['served_plan']})")
        # where the drain thread's time went, and the device's idle
        # share: 1 - the fast cohorts' device seconds (CUDA events around
        # each launch, so it is a lower bound on idle; plan cohorts are
        # not timed) / the phase's wall time
        scale["drain_s"] = {k: fp.timing[k] - t_before[k]
                            for k in fp.timing}
        scale["device_idle_share"] = \
            1.0 - scale["drain_s"]["device_busy_s"] / scale["wall_s"]
        check(all(v > 0 for v in launches.values()),
              f"both kernels launched on the main path: {launches}")
        check(per_lane["v2m"]["gather_bm25_contrib"] > 0
              and per_lane["v2m"]["merge_sorted_slots"] > 0
              and (scale["served_v1"] == 0
                   or per_lane["v1"]["gather_bm25_contrib"] > 0),
              f"each lane launched its kernels: {per_lane}")
        log(f"[rest-scale] launches {per_lane} over {cohorts} cohorts, "
            f"mean cohort width {scale['mean_cohort_width']:.2f}")
        plan_served = [i for i, lane in enumerate(lanes) if lane == "plan"]
        scale["plan_equal_to_cpu"] = phase_plan_cpu(
            node, [bodies[i] for i in plan_served],
            [results[i] for i in plan_served], 1000, "scale plan query")
        # the θ-warm pass: the same bodies again
        theta_warm = phase_theta_warm(node, port, queries, bodies, oracles,
                                      lanes, args.clients, counters)
        # the bodies the C++ grammar refuses, through the fallback
        scale["source_true"] = phase_source_true(
            node, port, queries, oracles, lanes, args.clients)
        # throughput and latency from the C++ load generator: cold (θ
        # emptied) and θ-warm
        scale["loadgen"] = phase_loadgen(node, port, bodies, lanes,
                                         args.clients)
        # the trace asks size 999: θ licenses the essential lane only at
        # k = 1000, so it measures the cold lanes (the same launches)
        scale["trace"] = phase_scale_trace(
            node, port, lanes, [match_body(q, 999) for q in queries],
            args.clients, counters)
        # the plan path on the queries no v2m cohort takes (the misfits,
        # as PR 3's plan path served them), asked outside the fast grammar
        misfit_bodies = [plan_body(q, 1000) for q, lane in
                         zip(queries, lanes) if lane != "v2m"]
        plan_burst = phase_plan_burst(node, port, misfit_bodies, 1000)
        plan_trace = phase_plan_trace(node, misfit_bodies, 1000)
        filters = phase_filters(node, port, corpus, queries, 1000,
                                args.clients, counters)
        # the corpus as time-ordered logs around an incident: a second
        # index, where the plan path's pruning must engage
        t0 = time.time()
        logs = with_incident_terms(corpus,
                                   np.random.default_rng(args.seed + 3))
        cols = logs_columns(args.docs, np.random.default_rng(args.seed + 5))
        node.create_index("logs", LOGS_MAPPINGS)
        node.indices["logs"].engine.install_segments(
            [segment_from_corpus(logs, name="logs0", numerics=cols)])
        bodies_logs, oracles_logs = logs_bodies(
            logs, len(corpus["df"]), filt_pool, args.seed + 4)
        log(f"[setup] incident index in {time.time() - t0:.1f} s")
        prune = phase_plan_prune(node, port, args.clients,
                                 plan_small_bodies, misfit_bodies,
                                 bodies_logs, oracles_logs)
        hbm_agrees(node, "scale", hbm_log)

        # ---- 5. the dense executor on the logs index
        dense = phase_dense(node, port, logs, cols, len(corpus["df"]),
                            queries, args.clients, args.seed + 6,
                            args.iters, counters)
        hbm_agrees(node, "dense", hbm_log)

        # ---- 6. kNN: pure kNN (config 4) and hybrid rank.rrf (config 5)
        knn = phase_knn(node, port, args.knn_docs, args.knn_dims,
                        args.knn_queries, args.seed + 7, args.iters)
        cpu = SearchService(DeviceSegmentCache("cpu"))
        feat = bench_feat(args.docs)
        hybrid = phase_hybrid(node, port, corpus, queries, oracles,
                              args.hybrid_dims, args.seed + 8,
                              min(args.clients, 64), counters, feat, cpu)
        hbm_agrees(node, "knn", hbm_log)

        # ---- 7. script scoring (config 3) on the hybrid index
        script = phase_script(node, port, corpus, queries, feat,
                              args.seed + 9, min(args.clients, 64),
                              counters, cpu)
        hbm_agrees(node, "script", hbm_log)

        # ---- 8. aggregations: the bench's terms-agg row, a Kibana mix
        aggs = phase_aggs(node, port, corpus, queries, logs, cols,
                          min(args.clients, 64), counters, cpu)
        hbm_agrees(node, "aggs", hbm_log)

        # ---- 9. device accounting and launch attribution
        accounting = phase_accounting(node, port, corpus, queries,
                                      args.knn_dims, builds, counters,
                                      hbm_log)
        accounting["hbm_limit"] = hbm_limit
    finally:
        node.close()

    # ---- 10. report
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
            launches_per_lane=dict(
                {lane: d[name] for lane, d in per_lane.items()},
                **{(lane if lane in ("ess", "refire") else f"warm_{lane}"):
                   d[name]
                   for lane, d in theta_warm["launches_per_lane"].items()}),
            launches_per_cohort=launches[name] / max(1, cohorts),
            max_abs_err=r["max_abs_err"], ms=r["ms"], kernel_ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            per_bucket=r.get("per_bucket"),
            launches_dense=dense["launches"][name],
            launches_knn=hybrid["dense_bodies"]["launches"][name],
            launches_script=script["launches"][name],
            launches_aggs=aggs["launches"][name],
            launches_accounting=accounting["attribution"]["launches"][name],
            dense_shape=(dense["contrib_dense_shape"]
                         if name == "gather_bm25_contrib" else None)))
    print(json.dumps({"scale": scale}))
    print(json.dumps({"lanes": dict(lane_cohorts, v2m=kern["cohort"],
                                    ess=ess_cohorts, small=rest_small)}))
    print(json.dumps({"theta_warm": theta_warm}))
    print(json.dumps({"prune": prune}))
    print(json.dumps({"dense": dense}))
    print(json.dumps({"knn": knn}))
    print(json.dumps({"hybrid": hybrid}))
    print(json.dumps({"script": script}))
    print(json.dumps({"aggs": aggs}))
    print(json.dumps({"accounting": accounting}))
    print(json.dumps({"filters": filters}))
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
