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
              the merge also at NB=1024 and 2048 and on a tie-heavy cohort;
              the card's launch floor (a one-element add timed the same way).
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
              θ-warm (two rounds to warm, then 6 rounds measured), every
              request done with 2xx, every bounce a plan-path body the
              plan path answered. Then (at size 999, which no θ licenses,
              under the load generator): the v2m-served queries alone
              (two rounds to warm, 6 measured), and all of them
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
  6. knn      config 4: an index of 4M seeded 768-d unit vectors
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
              exists bodies, the first of each kind equal to the port's
              CPU execution, the contribution kernel launching on the
              merged ones; the rrf bodies from the load generator. The index also carries the
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
              indices under a limit of 2.5 segments: 8 plan bodies equal
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
 10. fulltext an index "fulltext" of the 2M-doc corpus with its token
              streams (the corpus's token sequence as a [2M, 200] int32
              rectangle on the host; corpus.py corpus_streams), its
              _source and a rank_features field ml.tokens (256 keys
              drawn Zipf(1.07), 24 a doc, weights in (0, 4]: 256 float32
              doc-value columns on the card; corpus.py
              rank_feature_columns); the host and device bytes printed.
              About 93 seeded bodies (size 100) over HTTP from Python
              clients: match_phrase (2-4 consecutive terms of random
              docs, slop 0; 3-4 terms, slop 1-2), match_phrase_prefix,
              match_bool_prefix, prefix, wildcard, regexp, fuzzy
              (fuzziness 1 and AUTO), intervals (ordered match with
              max_gaps, all_of ordered, any_of) and span_near,
              query_string and simple_query_string, more_like_this
              (like-text and a like-doc), pinned, text_expansion with 32
              weighted tokens, rank_feature (saturation, log, sigmoid),
              and bools of a phrase with a term or range filter. None
              refused; the phrase, interval, multi-term, fuzzy, pinned,
              feature and bool bodies held to a float64 oracle over the
              streams, postings and columns (totals exact; constant
              scores in docid order; served scores within rtol 1e-5 and
              every missing oracle doc tied with the kth score); every
              body equal to the port's CPU execution (text_expansion's
              float32 sums by the tie-aware rule); the contribution
              kernel launched once per dense BM25 scoring of the mix
              (the tracker's calls of the dense scorer; /_kernels
              agrees) and the merge not at all. Then each body once
              more with profile: true, its hits unchanged. Printed: qps
              and p50/p99, each body's query ms and its score stage's
              host work from the profile (the term dictionary scans,
              block selections, position checks with their candidates,
              score column uploads), and the device ms of the
              conjunction filter and of the feature plane's weighted sum
              against their bounds
 11. fetch    fetch, sort and filter conversion: an index "kw" of the
              corpus with the bench's 500-term ``cat`` keyword (its doc
              values and postings; every 13th doc without one) and a
              bulked second segment of 2,000 docs (a term of its own,
              "zz-only"; c250-c259; none). Keyword sorts asc and desc,
              alone, with ``_doc`` and under match queries, and cursors
              on a term of one segment only, a term of no segment, a
              common term and a missing value, each held to a numpy
              oracle (ids, order, sort values, totals: lexicographic
              terms, missing last, ties by (segment, docid)); walks of
              10 search_after pages of 100 equal to one page of 1000;
              collapse on cat (the first hit per key of the uncollapsed
              answer); on "fulltext" 12 bodies of _source filters,
              fields, docvalue_fields and highlight (unified, plain,
              fvh) at size 100, each equal to the CPU execution, with
              their query and fetch ms from profile: true; on "logs"
              script_fields (an expression over bytes and status held
              to a float64 oracle under float32 columns, rtol 1e-6; a
              statement script answers 400) and terminate_after; then
              filter conversion: plan bodies with a FILTER, a MUST_NOT
              or a should + FILTER on a high-df term of "bench" and a
              popular cat of "kw", run with conversion on and off, the
              hits, order and totals equal, equal under
              track_total_hits 10000, "bench"'s held to the float64
              oracle; the mask cache's hits and misses, each mix's qps
              and p50/p99 from 16 clients, and the cohorts the batcher
              forms with their lanes and device ms, on and off
 12. fields   the remaining field types: "geopoint" (Rally's geopoint
              track, cut to a sixteenth: 3,802,776 points clustered like
              populated places, corpus.py geo_points, in 4 segments of a
              location
              geo_point) with geo_distance at 1, 50 and 1000 km, the
              distanceRange bool, boxes (one across the dateline),
              polygons of 5 and 64 vertices and _geo_distance sorts of
              10 and 100 with a 3-page search_after walk; "geonames"
              (the corpus as places: location, population,
              country_code, an area envelope) with match + geo filter
              bodies (the contribution kernel) and geo_shape under each
              relation; "logs_ip" (phase 5's logs with clientip as ip,
              Zipf over /16 networks, and a session date_range) with a
              term, CIDR /24 and /16, an ip range and each range
              relation; "qa" (25,000 questions with 0-5 nested
              answers, Rally's nested track) with a nested bool of a
              term and a range, a score_mode over a match and
              inner_hits, and its join twin "qa_join" with has_child
              under each score_mode and min_children, has_parent with
              score and parent_id; "alerts" (1,000 stored queries of
              the phase 4 query log: match, bool with a range filter,
              range) percolating one document, and "alerts_small" (its
              first 100) ten documents and a document by index/id.
              Every body over HTTP (16 clients a
              mix); held to a float64/numpy oracle under the float32
              column semantics (geo docs within 1e-4 of a radius
              exempt, counted; the ip column's float32 neighbours
              counted) and to the port's CPU execution (one body of
              each geopoint family, the other bodies but the one-
              document and by-reference percolations; geo docs within
              1e-6 of a radius or of the page's last key exempt, at
              most 16 a body, counted); the contribution kernel
              launched once
              per dense BM25 scoring, the merge not at all, the breaker
              equal to the segments' bytes after. Printed: each body's
              profiled query, rewrite, join, top-k and verify ms; the
              geo masks' device ms at 7.6M points against their bounds
              and the polygon's launches; percolate ms per stored query
 13. shards   "bench5": the phase 4 corpus with the bench's 500-term
              cat keyword, in 5 shards (Rally geonames' default) routed
              by a numpy murmur3 of _id, which the port's shard_for
              equals on 200,000 ids, one segment a shard; "route5" takes 2,000
              docs through _bulk, each shard holding numpy's count.
              Over HTTP, every body reaching the fallback workers (the
              front's fast count +0): phase 4's first 16 match bodies
              at size 1000 (5 alone, then from 64 clients and the load
              generator), 8 of the bool+filters mix, 32 match + terms
              agg on cat, a cat sort with a 10-page search_after walk,
              collapse on cat, track_total_hits 10000, profile: true,
              8 dfs_query_then_fetch bodies before and after their
              default twins, and /bench,bench5 of 8 bodies. Held to
              float64 oracles (each shard's own statistics by default,
              the whole corpus's under dfs; the dfs answers also to the
              one-shard bench's), numpy (sort, walk by the cursor rule,
              collapse, agg counts) and, 2 bodies a kind, the port's
              CPU execution; _shards {5, 5, 0} (6 for the two indices)
              on every answer; the contribution kernel launched once per
              dense BM25 scoring, the merge not at all; the breaker
              equal to the segments' bytes. Printed: each shard's query
              ms and the coordinator's merge and fetch ms from the
              profile, launches a dense body, qps and p50/p99 beside
              the one-shard bench through the same fallback workers
 14. deferred the 35 aggregation types earlier slices deferred, on
              the resident indices, over HTTP through the fallback
              workers, each body once with profile: true: TSVB time
              series on "logs" (moving_fn, moving_avg, serial_diff,
              bucket_script, bucket_selector, normalize,
              cumulative_cardinality, moving_percentiles; one under a
              match), auto_date_histogram, variable_width_histogram,
              top_metrics under terms, t_test, matrix_stats, boxplot,
              median_absolute_deviation, adjacency_matrix, sampler and
              diversified_sampler under a match, scripted_metric under
              a filter of 20,000 docs; rare_terms and string_stats on
              "hybrid"'s cat under a match; significant_terms on
              "bench5"; composite over cat x a date_histogram of rank on
              "bench5" and cat x a histogram of feat on "hybrid", each
              walked page by page (1,000 a page) through after_key;
              Kibana Maps on "geopoint" (a geotile_grid at precision 7
              with geo_centroid, a geohash_grid, geo_bounds and
              geo_distance rings under a viewport's
              geo_bounding_box), a world geohash_grid at precision 3
              with geo_bounds and geo_centroid over 7.6M points, world
              rings; ip_range on "logs_ip" under a match; nested,
              top_hits under terms and multi_terms on "qa"; children and
              parent on "qa_join"; significant_text and top_hits on
              "fulltext"; then a 16-body dashboard mix of these from 8
              Python clients. Held to numpy/scipy oracles under the
              float32 column semantics (composite pages concatenated
              against one grouped pass, significant, rare and multi
              terms, adjacency, sampler, ring and grid counts exact, a
              point within 1e-9 of a grid cell's edge exempt and
              counted; geo_bounds exact, centroids, t_test, matrix_stats,
              string_stats, the scripted mean within rtol 1e-6), to the
              port's CPU execution (the first body of each type), 200
              with _shards.failed 0 everywhere; the contribution kernel
              launched once per dense BM25 scoring (/_kernels agrees),
              the merge not at all, the breaker equal to the segments'
              bytes. Printed: each body's query and aggregation ms from
              its profile, the composite walks' ms a page, the grids'
              seconds at 7.6M points, scripted_metric's us a doc, the
              mix's qps and p50/p99
 15. mesh     parallel/ on one H100. (a) Phase 13's 16 match and 8
              bool+filter bodies to "bench5" again over HTTP: the node's
              device list is the one card, so every body falls back to
              the per-shard loop (``fallback.not_enough_devices`` grows
              by exactly the bodies, no ``dispatch.*``, no
              ``fallback.error``) and answers what phase 13 answered.
              (b) The mesh programs over a grid of 5 x cuda:0: a
              search service with that device list serves the 24
              bodies on bench5's shards (the node's resident segments:
              no second copy), each answer equal to the loop's bit for
              bit (ids, order, float32 scores, totals); a query through
              MeshSearchBackend.execute profiled (its kernels' device
              ms, its host ms from compile to readback, one wait for
              the card); the gather and merge's ms; sharded_dfs_stats
              over build_sharded_index's stack of bench5's title field
              equal to the dfs phase's pooled doc freqs for the 8 dfs
              bodies' terms; _mesh_knn_nominate and
              _mesh_knn_step over config 4's 4M x 768 bfloat16 slab as
              five row ranges (views) for 4 queries at k 1000 and 3000
              candidates, each equal to the per-shard nomination, exact
              re-rank, cut and merge over the same views (ids, order,
              totals exact, scores rtol 1e-6). (c) The replica fan-out
              over 2 x cuda:0: a PlanBatcher cohort of 32 and a
              fast-path v1 cohort of 32 on "bench" byte-equal to their
              unsplit launches, the split v1 cohort launching the
              contribution kernel twice, /_kernels agreeing. (d)
              ``fallback.error`` 0 over the whole run. Printed: the
              device and host ms a mesh query and its waits for the
              card, the gather and merge ms
 16. durability  documents, versions and the translog, on a node of
              its own on a temporary data path (removed at the end;
              its bytes on disk printed). (a) "docs": 25,000 docs
              (corpus.py's text, seed 0, a keyword, a long) in 5
              _bulk requests of 5,000 over HTTP, then 1,250 single-doc
              requests (updates by doc and by script, deletes, new
              docs, a _create conflict, a CAS that succeeds and one
              that conflicts): before _refresh every search answers as
              before the requests (the NRT rule); after it the dense
              (min_score) and plan bodies against a float64 oracle over
              every copy the segments hold (totals exact, scores rtol
              1e-5, the recall rule); after _forcemerge the fast bodies
              on v2m (both kernels launch); every acknowledged write
              read back through _mget with its _version and _seq_no.
              (b) _flush, 2,500 ops by _bulk that only the translog
              holds, close, a new Node on the path: the translog
              replays them, every acknowledged write reads back, and
              every page equals its answer before the restart. (c)
              "bench", the 2M-doc corpus (the segment as built, before
              phase 21's delete), installed, flushed, closed
              and reopened: phase 4's first 64 match bodies answer
              bit-equal before and after. Printed: the bulk rate, the
              replay's ops/s, the seconds to recover split into
              segment load, version map and upload to the card, the
              bytes on disk, each part's launches
 17. contexts index metadata and the search contexts, on the node of
              phases 2-15 (run before phase 16): (a) four single-term
              bodies of the bench's queries (each at most 10,000
              hits) scrolled in pages of 1000, the pages disjoint,
              every page's total the float64 oracle's, the page after
              the last empty, the pages together bit-equal to one
              dense-executor page of 10,000, one contribution launch a
              page; a keyword-sorted scroll of "kw" (two segments)
              against phase 11's numpy oracle; (b) a sliced scroll
              (max 4): disjoint slices whose union is the unsliced
              scroll, each hit in slice abs(murmur3(id)) % 4, the hash
              column's build seconds over 2M ids; (c) a PIT on a
              100,000-doc index: later writes unseen, later deletes
              seen, none open after close; (f) a filtered alias, a
              template on an auto-created index, a data stream of
              20,000 docs rolled over at max_docs 10,000 answering as
              its backing indices, a write alias; (d) 32 _count
              bodies against the oracle totals, a size-0 aggs body
              answered again from the request cache with no launch,
              a miss after a write; (e) one _msearch of 32 fast-lane
              and 32 plan bodies, each equal to the body alone, its
              cohorts and wall beside the 64 sent one by one; (g)
              _clone, _split and _shrink of 25,000 docs of 2 shards,
              their totals and _mget equal the source's, the breaker
              equal to the resident bytes after the targets go; (h)
              _explain of 64 hits against their scores, a stored
              script by id against the inline one; (i) "bench" closed
              (the front drops it, the reference's 400) and opened
              (registered again); (j) a scroll and a PIT outliving a
              force-merge release the merged-away segments when
              cleared; {"contexts": ...}
 18. analysis per-field and custom analyzers, `_analyze`, term vectors
              and the by-query family, on the main node after phase
              17: (a) "an18", 10,000 English-like docs (corpus.py
              english_docs: inflected forms, stop words, HTML markup,
              accented, hyphenated and camel-case words) in 2 _bulk
              requests of 5,000, mapped title standard, body english
              with a synonym search analyzer, body.exact a custom chain
              (html_strip and mapping char filters, the pattern
              tokenizer, lowercase, asciifolding, a stop list,
              word_delimiter_graph, porter_stem), tags whitespace; the
              bulk rate and each analyzer's host us a doc; (b) on each
              field 32 match/bool bodies of size 1000 on the plan path
              and again with min_score (the dense executor), and phrase
              and highlight bodies: each against a float64 BM25 oracle
              over the postings the segments hold (totals exact, the
              recall rule, scores rtol 1e-5; a phrase's docs those
              whose token streams hold it) and the port's CPU
              execution (ids, order, totals, highlights equal, scores
              rtol 1e-6); (c) 64 _analyze requests (named, by field,
              ad hoc chains, explain), 32 _termvectors and one
              _mtermvectors of 32, each equal to the CPU answer, the
              term freqs the analyzer's tokens, the doc freqs the
              postings'; (d) the seven HEAD requests over HTTP answer
              the GET's status with no body; (e) after _forcemerge the
              front does not register an18 (its bodies: fast +0);
              "an18_std" (10,000 titles, one standard field): its
              fast bodies launch the merge once a v2m cohort and equal
              the plan path's; (f) _reindex into "an18_en" (body
              english with a stop list), totals equal; _update_by_query
              with a script over one term's docs and _delete_by_query
              over another's, each with refresh: counts, the totals
              and the _mget of the touched ids as the oracle says, a
              search after them against the oracle and the CPU; (g)
              the contribution kernel launched once a dense BM25
              scoring, the merge once a v2m cohort, /_kernels agreeing,
              the breaker equal to the resident bytes; {"analysis": ...}
 19. tasks    the task manager and the host search modules, on the
              main node after phase 18: (a) 8 clients send 64 plan and
              dense bodies to "bench" while `_tasks?detailed=true` is
              read: never more search tasks than requests in flight,
              each with its profile stage; none after, tasks.current 0;
              (b) a dense body over "bench5" (one launch a shard) run
              whole, then through `_async_search` with a 0 wait and
              cancelled by `POST /_tasks/{id}/_cancel` once its first
              launch shows (its task in its scoring stage): a 400
              task_cancelled_exception, fewer launches, the breaker at
              the resident bytes, no plan cohort in flight, asked again
              equal to the whole answer; an `_msearch` of 64 whose
              parent is cancelled after its first child answered: the
              children the ban killed, each answered child equal to its
              body alone; (c) 32 async plan and dense bodies (0 wait,
              polled to the end) each equal to its `_search`, a DELETE
              of a running one a 404 after; (d) `_reindex` of "an18"
              (max_docs 5,000) with wait_for_completion=false and one
              `_rethrottle`
              while it runs, polled through `GET /_tasks/{id}`: counts,
              `_count` and `_mget` equal a synchronous reindex's; (e)
              64 `_search/template` bodies (a stored template's fast
              match bodies, inline plan bodies) each equal to its
              rendered `_search`, an `_msearch/template` of 32 each
              slot equal; (f) `_rank_eval` of 16 requests rated from
              the float64 oracle, once a metric type, each metric equal
              to numpy's over the port's own `_search` ids; (g)
              `_terms_enum` prefixes against numpy's sorted dictionary,
              `_field_caps` of every index against its `_mapping`,
              `_validate/query`, `_resolve/index` against the metadata,
              `_cat` rows and `GET /_stats` against `_count` and the
              segments, a 0ms slow-log threshold catching every search
              of a burst with its slowest stage; the contribution
              kernel once a dense scoring and once a fast cohort, the
              merge once a v2m cohort, /_kernels agreeing; {"tasks": ...}
 20. telemetry node telemetry, on the main node after phase 19, over
              HTTP through the fallback workers: (a) 3 tenants (one by
              X-Tenant-Id, one by the body's tenant, one by "logs"'
              index.tenant.default) x 16 plan, dense and `_source:
              true` fast bodies each, 8 clients: each answer equal to
              the body sent untagged; `_tenants/stats` (and
              `_cat/tenants`) counts each tenant's searches, its cohort
              slots equal its bodies that entered the PlanBatcher, and
              the launch ms of every row (`_default` too) sum to the
              flight recorder's over the load; (b) 32 plan and dense
              bodies on "bench" and "bench5" with a trace.id header,
              one at a time: the answer echoes it, `_traces/{id}` has
              one rest.search root over its shard spans (5 on
              "bench5") and its fetch span, the waterfall lists exactly
              its launches and readbacks and its contribution-kernel
              events equal that kernel's launches across it; a fast
              cohort of 8 traced bodies, its attribution printed; (c)
              X-Workload-Class against classification (interactive,
              a header class, scroll, async, bulk): `_workload/stats`
              counts as sent, the bulk class its bytes; (d) a plan, a
              dense and a fast body in CBOR, answered in CBOR equal to
              JSON, a bad CBOR body a 400; `_msearch` of 16 sent as
              application/json equal to the same as x-ndjson; (e) a
              node with http.ip_filter.deny 127.0.0.0/8, and one with
              an allow list without it, refuse the connection; (f) a
              node with a 200,000-doc index and
              indices.breaker.request.limit below one segment's
              aggregation mask: a match + terms agg answers 429
              circuit_breaking_exception, breaker.tripped{breaker=
              request} +1, the body without aggs its exact total; the
              request breaker at 0 after every step; the host
              microseconds of a span, an observe, a tenant + class
              search record and a cohort slot, and the p50 of a dense
              `_search` with the four headers against without; (g)
              `_nodes/stats`: search.requests and search.latency grew
              by the searches sent, ?history=true renders;
              {"telemetry": ...}
 21. ops      the node's operational layer, on the main node after
              phase 20: (a) an `_msearch` of 64 "bench" bodies (plan
              and `_source: true` fast), each equal to itself asked
              alone, thread_pool.search.completed +64 and rejected +0,
              `_cat/thread_pool` equal to `_nodes/stats`; (b) "bench5"
              frozen: 16 plan and dense bodies and a 3-page scroll
              equal to their unfrozen answers (ids, order, float32
              scores, totals), none of its segments on the card and
              the hbm breaker at the resident bytes after each,
              search_throttled.completed +16, a write 403, each
              search's upload ms; (c) "bench" snapshotted into an fs
              repository and restored as "bench_r": fresh segment
              names, 32 bench-mix bodies equal to "bench"'s, its fast
              bodies on the v2m lane, a second snapshot of 0 new
              bytes, a delete in "bench" leaving "bench_r"'s total; the
              snapshot's seconds and bytes, the restore's seconds, the
              first search's upload ms; (d) the snapshot mounted as
              "bench_m": no segment file before its first search, then
              equal answers, a write 403, a second mount served from
              the blob cache; (e) an SLM policy executed twice, its
              max_count 1 keeping the newest; (f) `_health_report`:
              device_engine's hbm_used_ratio the breaker's used /
              limit, device_regime's launches and fill the history
              ring's over the window, repository_integrity green and
              then red naming a truncated snap-{name}.json,
              `_cluster/health` green with every shard active,
              `_health_report/nope` a 400; the contribution kernel once
              a dense scoring and once a fast cohort, the merge once a
              v2m cohort; {"ops": ...}
 the report   the scale, lanes, theta_warm, prune, dense, knn, hybrid,
              script, aggs, accounting, fulltext, fetch, fields, shards,
              aggs_deferred, mesh, durability, contexts, analysis,
              tasks, telemetry, ops, filters, plan and kernels JSON
              lines (each kernel's launches per phase,
              launches_aggs_deferred for phase 14, launches_mesh for
              15, launches_durability for 16, launches_contexts for 17,
              launches_analysis for 18, launches_tasks for 19,
              launches_telemetry for 20, launches_ops for 21, and the
              card's launch floor, launch_floor_ms: the device ms of a
              one-element add timed as every kernel is),
              the phases' wall seconds
              ({"phase_seconds": ...}), the card's
              name and power limit, and the last line {"ok": true,
              "device": {...}}

Needs one CUDA card, and the repository around it.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import fnmatch
import logging
import os
from collections import Counter
import json
import re
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
LAUNCH_FLOOR_N = 1000    # one-element launches timed for the floor


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

    # ---- the card's floor for one timed launch: a one-element op, as
    # cuda_ms times every kernel above (a launch that cannot be faster)
    one = torch.zeros(1, device="cuda")
    floor_ms, floor_host_ms = cuda_ms(lambda: one.add_(1.0), LAUNCH_FLOOR_N)
    out["launch_floor"] = dict(ms=floor_ms, host_ms=floor_host_ms,
                               calls=LAUNCH_FLOOR_N)
    log(f"[kernels] launch floor: {floor_ms:.5f} ms a one-element add "
        f"(host {floor_host_ms:.5f} ms a call)")

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
def drive(port, bodies, clients, index="bench", query="", method="POST"):
    """``bodies`` as _search requests to /``index`` (an index expression,
    or a list of one a body; ``query`` the URL's query string, "?..." or
    empty) from ``clients`` threads: ([(status, response)], latency s of
    each, wall s)."""
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
            idx = index[i] if isinstance(index, list) else index
            results[i] = http(port, method, f"/{idx}/_search{query}",
                              bodies[i])
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

    def recorded(expression, body, search_type=None, scroll=None,
                 task=None):
        planned.append(json.dumps(body.get("query"), sort_keys=True))
        return type(service).search(service, expression, body, search_type,
                                    scroll, task)

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
    to warm, then 6 measured; the reference bench measures 12). Answers
    are held to the oracle in the passes driven by Python clients; these
    measure."""
    reg = node.fastpath.front_registration()
    check(reg is not None and reg["index"] == "bench",
          "the C++ front serves the bench index")
    reg["theta"].clear()
    reg["ess_bad"].clear()
    out = dict(cold=loadgen_pass(node, port, bodies, lanes, conns),
               warm=loadgen_pass(node, port, bodies, lanes, conns, reps=6,
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
    and 6 measured: latency and the CUDA-event seconds of their
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
                         reps=6, warmup=2)

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
                m = m & _search_after_mask(ctx, scores, spec, after)
            return m, _primary_sort_key(ctx, scores, spec)
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
    cpu = SearchService(DeviceSegmentCache("cpu"), node.indices)
    t0 = time.time()
    n_cpu = 0
    per_kind = Counter()
    for i, (kind, body, r) in enumerate(zip(all_kinds, all_bodies,
                                            all_answers)):
        # the first two bodies of each kind (PERF.md section 4: the cut)
        per_kind[kind] += 1
        if per_kind[kind] > 2:
            continue
        c = cpu.search("logs", body)
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
    # timed: two rounds of the whole mix from the clients (PERF.md
    # section 4: the cut)
    rounds = 2
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


def host_rss_bytes() -> int:
    """This process's resident host memory (bytes)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


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
    ctx = node.search_service._shard_searchers(svc)[0]._contexts()[0]
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
        bm25 = service.search("hybrid", {
            "query": body["query"], "size": 1000, "_source": False})
        knn = service.search("hybrid", {
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
    seen_kinds = Counter()
    for (kind, body), (st, r) in zip(mixed, res2):
        what = f"hybrid {kind} body vs the CPU"
        check(st == 200, f"{what}: {st} {r}")
        # the first body of each kind against the CPU (PERF.md section
        # 4: the cut)
        seen_kinds[kind] += 1
        if seen_kinds[kind] > 1:
            continue
        c = cpu.search("hybrid", body)
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
        launches=launches, cpu_s=time.time() - t0,
        cpu_bodies=sum(min(1, n) for n in seen_kinds.values()))
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


# the script bench bodies held to the CPU execution (all 32 to their
# float64 oracle; PERF.md section 4: the cut)
SCRIPT_CPU_BODIES = 8


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
        if i < SCRIPT_CPU_BODIES:
            equal_to_cpu(r, cpu.search("hybrid", body), what)
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
        equal_to_cpu(r, cpu.search("hybrid", body), what)
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
    equal_to_cpu(r, cpu.search("plan", small),
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
        c = cpu.search("hybrid", body)
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
        c = cpu.search("logs", body)
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
    of 2.5 segments: 8 plan bodies in a fixed order of indices equal
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
        pattern = [0, 1, 0, 2, 3, 1, 0, 3]
        # half a cycle of the pattern, every index in it (PERF.md
        # section 4: the cut)
        order = [f"ev{p}" for p in pattern]
        bodies = [plan_body(queries[i], k) for i in range(len(order))]
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
        log(f"[accounting] {len(order)} plan bodies over 4 indices under "
            f"2.5 segments equal to the CPU ({time.time() - t0:.1f} s)")
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


# ---------------------------------------------------------------- phase 10
FULLTEXT_MAPPINGS = {"properties": {
    "title": {"type": "text"}, "views": {"type": "long"},
    "ml": {"properties": {"tokens": {"type": "rank_features"}}}}}
FT_RTOL = 1e-5
FT_SIZE = 100


class FulltextOracle:
    """float64 answers of the full-text mix from numpy over the corpus's
    token streams and postings (``corpus.py``), under the port's
    semantics as the reference defines them (search/phrase.py,
    search/intervals.py): each a float64 score column [n_docs] that is
    > 0 exactly where a doc matches (a constant 1.0 for the multi-term
    bodies), or (column, pinned ids)."""

    def __init__(self, corpus, streams, feats, views, k1=1.2, b=0.75):
        from elasticsearch_tpu_torch.corpus import term_name
        self.corpus, self.feats, self.views = corpus, feats, views
        self.tokens, self.lengths = streams["tokens"], streams["lengths"]
        lens = corpus["lens"].astype(np.float64)
        self.n = len(lens)
        self.N = int((lens > 0).sum())
        self.norm = k1 * (1.0 - b + b * lens / (lens.sum() / self.N))
        self.k1 = k1
        self.df = corpus["df"]
        self.names = [term_name(t) for t in range(len(self.df))]
        self.chars = np.frombuffer("".join(self.names).encode(),
                                   np.uint8).reshape(len(self.names), -1)

    def idf(self, df):
        return np.log(1.0 + (self.N - df + 0.5) / (df + 0.5))

    def postings(self, t):
        lo, hi = int(self.corpus["group_start"][t]), \
            int(self.corpus["group_start"][t + 1])
        return (self.corpus["doc_ids"][lo:hi],
                self.corpus["tf"][lo:hi].astype(np.float64))

    def has(self, terms):
        m = np.zeros(self.n, bool)
        for t in terms:
            m[self.postings(t)[0]] = True
        return m

    def has_all(self, terms):
        m = np.ones(self.n, bool)
        for t in set(terms):
            m &= self.has([t])
        return m

    def bm25(self, terms, weights=None):
        s = np.zeros(self.n, np.float64)
        for i, t in enumerate(terms):
            d, tf = self.postings(t)
            w = self.idf(self.df[t]) if weights is None else weights[i]
            s[d] += w * tf / (tf + self.norm[d])
        return s

    def tf_score(self, cand, freqs, w):
        s = np.zeros(self.n, np.float64)
        f = freqs.astype(np.float64)
        ok = f > 0
        c = cand[ok]
        s[c] = w * f[ok] / (f[ok] + self.norm[c])
        return s

    def window(self, cand, width):
        """The candidates' rows, -1 beyond their lengths, padded to at
        least ``width`` columns."""
        rows = self.tokens[cand]
        if rows.shape[1] < width:
            rows = np.pad(rows, ((0, 0), (0, width - rows.shape[1])),
                          constant_values=-1)
        return rows

    def exact_freqs(self, cand, slots):
        """Occurrences per candidate of consecutive slots, each slot a
        set of term ids (a lookup table per slot; the -1 pad reads its
        last entry, False)."""
        rows = self.window(cand, len(slots))
        n_pos = rows.shape[1] - len(slots) + 1
        hit = np.ones((len(cand), n_pos), bool)
        for j, ids in enumerate(slots):
            lut = np.zeros(len(self.df) + 1, bool)
            lut[list(ids)] = True
            hit &= lut[rows[:, j:j + n_pos]]
        return hit.sum(axis=1)

    def sloppy_freqs(self, cand, tids, slop):
        """The greedy alignment: for each position of the first term,
        each later term j takes the nearest unused position within
        ``slop`` of p0 + j (the lower one on a tie); vectorized over
        every (candidate, first-term position) pair."""
        rows = self.tokens[cand]
        lens = self.lengths[cand].astype(np.int64)
        ci, p0 = np.nonzero(rows == tids[0])
        keep = p0 < lens[ci]
        ci, p0 = ci[keep], p0[keep].astype(np.int64)
        used = [p0]
        ok = np.ones(len(ci), bool)
        order = [0] + [d for k in range(1, slop + 1) for d in (-k, k)]
        for j in range(1, len(tids)):
            best = np.full(len(ci), -1, np.int64)
            for dlt in order:
                q = p0 + j + dlt
                inb = (q >= 0) & (q < lens[ci])
                qq = np.where(inb, q, 0)
                cond = (best < 0) & inb & (rows[ci, qq] == tids[j])
                for u in used:
                    cond &= q != u
                best = np.where(cond, q, best)
            ok &= best >= 0
            used.append(best)
        return np.bincount(ci[ok], minlength=len(cand))

    def phrase(self, tids, slop=0):
        cand = np.nonzero(self.has_all(tids))[0]
        freqs = (self.exact_freqs(cand, [{t} for t in tids]) if slop == 0
                 else self.sloppy_freqs(cand, tids, slop))
        return self.tf_score(cand, freqs, float(sum(
            self.idf(self.df[t]) for t in set(tids)))), len(cand)

    @staticmethod
    def where(answer, keep):
        """An answer (column, candidates) cut to the docs of ``keep``."""
        return answer[0] * keep, answer[1]

    def expand_prefix(self, prefix, cap):
        return [t for t, nm in enumerate(self.names)
                if nm.startswith(prefix)][:cap]

    def phrase_prefix(self, fixed, prefix):
        exp = self.expand_prefix(prefix, 50)
        cand = np.nonzero(self.has_all(fixed))[0]
        freqs = self.exact_freqs(cand, [{t} for t in fixed] + [set(exp)])
        w = sum(self.idf(self.df[t]) for t in set(fixed))
        w += self.idf(max(min(self.N, int(self.df[exp].sum())), 1))
        return self.tf_score(cand, freqs, float(w)), len(cand)

    def bool_prefix(self, fixed, prefix):
        s = self.bm25(fixed)
        return s + self.has(self.expand_prefix(prefix, 50)), 0

    def constant(self, terms):
        return self.has(terms[:1024]).astype(np.float64), 0

    def osa(self, value):
        """Optimal string alignment distances of ``value`` to every
        vocabulary name (all of its length), by the full DP."""
        a = np.frombuffer(value.encode(), np.uint8)
        b = self.chars
        la, lb = len(a), b.shape[1]
        d = np.zeros((la + 1, lb + 1, len(b)), np.int32)
        d[:, 0] = np.arange(la + 1)[:, None]
        d[0, :] = np.arange(lb + 1)[:, None]
        for i in range(1, la + 1):
            for j in range(1, lb + 1):
                cost = (b[:, j - 1] != a[i - 1]).astype(np.int32)
                v = np.minimum(np.minimum(d[i - 1, j] + 1, d[i, j - 1] + 1),
                               d[i - 1, j - 1] + cost)
                if i > 1 and j > 1:
                    tr = (a[i - 1] == b[:, j - 2]) & (a[i - 2] == b[:, j - 1])
                    v = np.where(tr, np.minimum(v, d[i - 2, j - 2] + 1), v)
                d[i, j] = v
        return d[la, lb]

    def fuzzy(self, value, k):
        dist = self.osa(value)
        cands = sorted((int(dist[t]), self.names[t]) for t in
                       np.nonzero(dist <= k)[0])[:50]
        terms = [int(nm[1:]) for _, nm in cands]
        w = [self.idf(self.df[t]) * (1.0 - dd / len(value))
             if self.df[t] > 0 else 0.0 for (dd, _), t in zip(cands, terms)]
        return self.bm25(terms, w), 0

    def ordered_pair(self, t0, t1, gaps):
        """Minimal ordered intervals (t0 then t1) with at most ``gaps``
        positions between: each t1 whose nearest earlier t0 comes after
        the nearest earlier t1 (search/intervals.py match_intervals and
        all_of_intervals, ordered)."""
        cand = np.nonzero(self.has([t0, t1]))[0]
        rows = self.tokens[cand]
        idx = np.arange(rows.shape[1])[None, :]
        last0 = np.maximum.accumulate(np.where(rows == t0, idx, -1), axis=1)
        last1 = np.maximum.accumulate(np.where(rows == t1, idx, -1), axis=1)
        prev0 = np.pad(last0[:, :-1], ((0, 0), (1, 0)), constant_values=-1)
        prev1 = np.pad(last1[:, :-1], ((0, 0), (1, 0)), constant_values=-1)
        ok = (rows == t1) & (prev0 > prev1) & (idx - prev0 - 1 <= gaps)
        w = float(self.idf(self.df[t0]) + self.idf(self.df[t1]))
        return self.tf_score(cand, ok.sum(axis=1), w), len(cand)

    def any_pair(self, t0, t1):
        cand = np.nonzero(self.has([t0, t1]))[0]
        rows = self.tokens[cand]
        freqs = ((rows == t0) | (rows == t1)).sum(axis=1)
        w = float(self.idf(self.df[t0]) + self.idf(self.df[t1]))
        return self.tf_score(cand, freqs, w), len(cand)

    def expansion(self, tokens):
        s = np.zeros(self.n, np.float64)
        present = np.zeros(self.n, bool)
        for tok, w in tokens.items():
            v = self.feats.get(f"ml.tokens.{tok}")
            if v is None:
                continue
            has = ~np.isnan(v)
            s[has] += float(np.float32(w)) * v[has].astype(np.float32)
            present |= has
        return np.where(present, s, 0.0), 0

    def rank_feature(self, key, fn):
        v = self.feats[f"ml.tokens.{key}"]
        has = ~np.isnan(v)
        x = np.where(has, v.astype(np.float32).astype(np.float64), 0.0)
        if "log" in fn:
            # the column's float32 arithmetic rounds log's argument
            s = np.log((np.float32(fn["log"]["scaling_factor"])
                        + x.astype(np.float32)).astype(np.float64))
        elif "sigmoid" in fn:
            p, e = fn["sigmoid"]["pivot"], fn["sigmoid"]["exponent"]
            s = x ** e / (x ** e + p ** e)
        else:
            s = x / (x + x[has].mean())
        return np.where(has, s, 0.0), 0


def ft_topk(scores, k):
    """(top-k docids by (score desc, docid asc), their scores, total) of
    an oracle column."""
    matched = np.nonzero(scores > 0)[0]
    order = np.lexsort((matched, -scores[matched]))[:k]
    return matched[order], scores[matched[order]], len(matched)


def check_ft_answer(r, scores, what, constant=False, pinned=()):
    """A full-text answer against its oracle column: the total exact
    ("eq"); pinned ids first in order; a constant-score body's ids the
    oracle's in docid order; a scored body's served scores within rtol
    1e-5 of the oracle's and every missing oracle doc tied with the kth
    score within rtol 1e-5."""
    got = [int(h["_id"]) for h in r["hits"]["hits"]]
    pins = [p for p in pinned]
    organic = np.where(np.isin(np.arange(len(scores)), pins), 0.0, scores)
    truth, tscore, total = ft_topk(organic, FT_SIZE - len(pins))
    total += len(pins)
    check(r["hits"]["total"] == {"value": total, "relation": "eq"},
          f"{what}: total {r['hits']['total']} vs the oracle's {total}")
    check(got[:len(pins)] == pins, f"{what}: the pinned ids first")
    got = got[len(pins):]
    served = np.array([h["_score"] for h in r["hits"]["hits"]][len(pins):],
                      np.float64)
    check(len(got) == len(truth), f"{what}: {len(got)} hits vs "
                                  f"{len(truth)}")
    if constant:
        check(got == truth.tolist(), f"{what}: ids and order")
        check(bool(np.all(served == 1.0)), f"{what}: constant score 1.0")
        return
    want = scores[got]
    check(bool(np.all(np.abs(served - want) <= FT_RTOL * want)),
          f"{what}: served scores within rtol 1e-5 of the float64 oracle")
    hit = np.isin(truth, got)
    kth = tscore[-1] if len(tscore) else 0.0
    check(bool(np.all(np.abs(tscore[~hit] - kth) <= FT_RTOL * kth)),
          f"{what}: every missing oracle doc ties the kth score")


def fulltext_mix(oracle, corpus, n_keys, seed):
    """The ~96 bodies of phase 10 from ``seed``: (kind, query, oracle
    thunk or None, pinned ids)."""
    from elasticsearch_tpu_torch.corpus import term_name
    rng = np.random.default_rng(seed)
    toks, lens, df, n = (oracle.tokens, oracle.lengths, corpus["df"],
                         oracle.n)
    # the query log's bands (corpus.py make_queries) at 2M docs
    rare = np.nonzero((df > n // 10000) & (df <= n // 100))[0]
    mid = np.nonzero((df > n // 100) & (df <= n // 20))[0]

    def run(n_terms):
        while True:
            d = int(rng.integers(n))
            if lens[d] >= n_terms:
                s = int(rng.integers(0, lens[d] - n_terms + 1))
                return [int(t) for t in toks[d, s:s + n_terms]]

    def text(tids):
        return " ".join(term_name(t) for t in tids)

    def near_pair(gap):
        """Two distinct terms of the rare band within ``gap + 1``
        positions of each other in one doc, in stream order."""
        in_rare = np.zeros(len(df), bool)
        in_rare[rare] = True
        while True:
            d = int(rng.integers(n))
            row = toks[d, :lens[d]]
            pos = np.nonzero(in_rare[row])[0]
            for i in range(len(pos) - 1):
                a, b = int(row[pos[i]]), int(row[pos[i + 1]])
                if a != b and pos[i + 1] - pos[i] <= gap + 1:
                    return a, b

    mix = []

    def add(kind, query, thunk=None, pinned=()):
        mix.append((kind, query, thunk, list(pinned)))
    for i in range(16):
        tids = run(2 + i % 3)
        add("phrase", {"match_phrase": {"title": text(tids)}},
            lambda t=tids: oracle.phrase(t))
    for i in range(8):
        tids, slop = run(3 + i % 2), 1 + i % 2
        add("phrase", {"match_phrase": {"title": {"query": text(tids),
                                                  "slop": slop}}},
            lambda t=tids, s=slop: oracle.phrase(t, s))
    for i in range(6):
        tids = run(2 + i % 2)
        fixed, pre = tids[:-1], term_name(tids[-1])[:5 + i % 2]
        add("phrase_prefix", {"match_phrase_prefix": {
            "title": f"{text(fixed)} {pre}"}},
            lambda f=fixed, p=pre: oracle.phrase_prefix(f, p))
    for i in range(6):
        tids = run(2 + i % 2)
        fixed, pre = tids[:-1], term_name(tids[-1])[:5 + i % 2]
        add("bool_prefix", {"match_bool_prefix": {
            "title": f"{text(fixed)} {pre}"}},
            lambda f=fixed, p=pre: oracle.bool_prefix(f, p))
    # patterns around the names of random docs' tokens, so expansions
    # meet the Zipf skew: t0123 (100 terms), t01?4* (1000), t012[0-4][0-9]5
    # (50)
    for _ in range(6):
        pre = term_name(run(1)[0])[:5]
        add("multi_term", {"prefix": {"title": pre}},
            lambda p=pre: oracle.constant(oracle.expand_prefix(p, 1024)))
    for _ in range(6):
        nm = term_name(run(1)[0])
        pat = f"{nm[:3]}?{nm[4]}*"
        add("multi_term", {"wildcard": {"title": pat}},
            lambda p=pat: oracle.constant([
                t for t, nm in enumerate(oracle.names)
                if fnmatch.fnmatchcase(nm, p)]))
    for _ in range(6):
        nm = term_name(run(1)[0])
        pat = f"{nm[:4]}[0-4][0-9]{nm[6]}"
        add("multi_term", {"regexp": {"title": pat}},
            lambda p=pat: oracle.constant([
                t for t, nm in enumerate(oracle.names)
                if re.fullmatch(p, nm)]))
    for i in range(6):
        band = rare if i % 2 else mid
        value = term_name(int(rng.choice(band)))
        fz = 1 if i < 3 else "AUTO"
        add("fuzzy", {"fuzzy": {"title": {"value": value,
                                          "fuzziness": fz}}},
            lambda v=value, k=(1 if i < 3 else 2): oracle.fuzzy(v, k))
    for i in range(2):
        g = 1 + i
        t0, t1 = near_pair(g)
        add("intervals", {"intervals": {"title": {"match": {
            "query": text([t0, t1]), "ordered": True, "max_gaps": g}}}},
            lambda a=t0, b=t1, gg=g: oracle.ordered_pair(a, b, gg))
        t0, t1 = near_pair(g)
        add("intervals", {"intervals": {"title": {"all_of": {
            "ordered": True, "max_gaps": g, "intervals": [
                {"match": {"query": term_name(t0)}},
                {"match": {"query": term_name(t1)}}]}}}},
            lambda a=t0, b=t1, gg=g: oracle.ordered_pair(a, b, gg))
        t0, t1 = (int(x) for x in rng.choice(rare, 2, replace=False))
        add("intervals", {"intervals": {"title": {"any_of": {"intervals": [
            {"match": {"query": term_name(t0)}},
            {"match": {"query": term_name(t1)}}]}}}},
            lambda a=t0, b=t1: oracle.any_pair(a, b))
        t0, t1 = near_pair(g)
        add("intervals", {"span_near": {"clauses": [
            {"span_term": {"title": term_name(t0)}},
            {"span_term": {"title": term_name(t1)}}],
            "slop": g, "in_order": True}},
            lambda a=t0, b=t1, gg=g: oracle.ordered_pair(a, b, gg))
    a, b, c = (term_name(int(t)) for t in rng.choice(mid, 3, replace=False))
    add("query_string", {"query_string": {
        "query": f"title:{a} AND (title:{b} OR title:{c})"}})
    add("query_string", {"query_string": {"query": f'"{text(run(2))}"',
                                          "default_field": "title"}})
    add("query_string", {"query_string": {"query": f"title:{b[:5]}*"}})
    add("query_string", {"query_string": {
        "query": f"{a} {c} -{b}", "fields": ["title"]}})
    add("query_string", {"simple_query_string": {
        "query": f'"{text(run(2))}" | {c}', "fields": ["title"]}})
    add("query_string", {"simple_query_string": {
        "query": f"{a} +{b}", "fields": ["title"],
        "default_operator": "and"}})
    add("query_string", {"simple_query_string": {
        "query": f"{c[:5]}* -{a}", "fields": ["title"]}})
    like_doc = int(rng.integers(n))
    add("more_like_this", {"more_like_this": {
        "fields": ["title"], "like": text(run(12)), "min_term_freq": 1,
        "min_doc_freq": 5, "max_query_terms": 12}})
    add("more_like_this", {"more_like_this": {
        "fields": ["title"], "like": [{"_id": str(like_doc)}],
        "min_term_freq": 1, "max_query_terms": 10}})
    for _ in range(2):
        tids = run(2)
        pins = [int(x) for x in rng.choice(n, 3, replace=False)]
        add("pinned", {"pinned": {"ids": [str(p) for p in pins],
                                  "organic": {"match_phrase": {
                                      "title": text(tids)}}}},
            lambda t=tids: oracle.phrase(t), pinned=pins)
    for _ in range(4):
        keys = rng.choice(n_keys, 32, replace=False)
        tokens = {f"k{int(k):03d}": round(float(w), 4) for k, w in
                  zip(keys, rng.uniform(0.1, 2.0, 32))}
        add("features", {"text_expansion": {"ml.tokens": {
            "tokens": tokens}}}, lambda t=tokens: oracle.expansion(t))
    for fn in ({}, {"log": {"scaling_factor": 1.0}},
               {"sigmoid": {"pivot": 2.0, "exponent": 0.7}}) * 2:
        key = f"k{int(rng.integers(n_keys)):03d}"
        add("features", {"rank_feature": dict(fn, field=f"ml.tokens.{key}")},
            lambda k=key, f=fn: oracle.rank_feature(k, f))
    for _ in range(2):
        tids = run(2)
        term = int(rng.choice(mid))
        add("phrase_bool", {"bool": {
            "must": [{"match_phrase": {"title": text(tids)}}],
            "filter": [{"term": {"title": term_name(term)}}]}},
            lambda t=tids, f=term: oracle.where(oracle.phrase(t),
                                                oracle.has([f])))
        tids = run(2)
        add("phrase_bool", {"bool": {
            "must": [{"match_phrase": {"title": text(tids)}}],
            "filter": [{"range": {"views": {"gte": 25, "lt": 75}}}]}},
            lambda t=tids: oracle.where(oracle.phrase(t), (
                oracle.views >= 25) & (oracle.views < 75)))
    return mix


def first_thirds(mix):
    """The first third (at least two) of each kind and query type's
    bodies of the mix, in the mix's order (PERF.md section 4: the
    cut)."""
    groups = Counter((kind, next(iter(qb))) for kind, qb, _, _ in mix)
    seen = Counter()
    out = []
    for entry in mix:
        g = (entry[0], next(iter(entry[1])))
        if seen[g] < max(2, -(-groups[g] // 3)):
            out.append(entry)
        seen[g] += 1
    return out


def phase_fulltext(node, port, corpus, seed, conns, counters, cpu):
    """Full-text query breadth on one H100 (module docstring, phase
    10)."""
    import torch

    from elasticsearch_tpu_torch.corpus import (corpus_streams,
                                                rank_feature_columns,
                                                segment_from_corpus,
                                                stream_sources)
    from elasticsearch_tpu_torch.ops import bm25 as bm25_ops
    from elasticsearch_tpu_torch.ops.features import feature_plane_sum
    from elasticsearch_tpu_torch.telemetry.engine import TRACKER
    n = len(corpus["lens"])
    n_keys = 256
    out = {"torch": torch.__version__}
    # set-up: the corpus's token streams and a rank_features field
    free = host_free_gib()
    # streams 800 B a doc, sources about 400, each feature column 17 B a
    # doc on the host and 5 B in the CPU execution's copy
    need = n * (800 + 400 + n_keys * 22) / 2 ** 30 * 1.25
    log(f"[fulltext] host free {free:.1f} GiB before the streams and "
        f"feature columns (about {need:.1f} GiB wanted)")
    check(free > need, f"host memory for phase 10: {free:.1f} GiB free, "
                       f"{need:.1f} wanted")
    t0 = time.time()
    streams = corpus_streams(corpus)
    feats = rank_feature_columns(n, np.random.default_rng(seed))
    views = np.random.default_rng(seed + 1).integers(0, 100, n).astype(
        np.float64)
    numerics = dict(feats, views={"values": views})
    seg = segment_from_corpus(corpus, name="fulltext0", numerics=numerics,
                              streams=streams,
                              sources=stream_sources(streams))
    node.create_index("fulltext", FULLTEXT_MAPPINGS)
    svc = node.indices["fulltext"]
    svc.engine.install_segments([seg])
    dev = node.device_cache.get(seg)
    torch.cuda.synchronize()
    ts = seg.streams["title"]
    fcols = [f for f in seg.numerics if f.startswith("ml.tokens.")]
    out["bytes"] = dict(
        streams_host=int(ts.tokens.nbytes + ts.lengths.nbytes),
        streams_shape=list(ts.tokens.shape),
        features_host=int(sum(
            seg.numerics[f].values.nbytes + seg.numerics[f].missing.nbytes
            + seg.numerics[f].offsets.nbytes
            + seg.numerics[f].all_values.nbytes for f in fcols)),
        feature_columns=len(fcols),
        features_device=int(sum(dev.numerics[f].nbytes
                                + dev.numeric_missing[f].nbytes
                                for f in fcols)),
        segment_hbm=dev.hbm_bytes(),
        hbm_by_class=dev.hbm_bytes_by_class(),
        setup_s=time.time() - t0)
    check(out["bytes"]["features_device"]
          <= out["bytes"]["hbm_by_class"]["doc_values"],
          "the feature columns are charged as doc_values")
    log(f"[fulltext] {out['bytes']}")
    oracle = FulltextOracle(corpus, streams,
                            {f: seg.numerics[f].values for f in fcols},
                            views)
    mix = first_thirds(fulltext_mix(oracle, corpus, n_keys, seed + 2))
    bodies = [{"query": qb, "size": FT_SIZE, "_source": False}
              for _, qb, _, _ in mix]
    out["bodies"] = dict(Counter(kind for kind, _, _, _ in mix))
    # (a) the mix over HTTP, the kernels' counts set to 0 just before
    _, k0 = http(port, "GET", "/_kernels")
    scorings0 = TRACKER.calls("bm25_dense_scores_sorted")
    for c in counters.values():
        c.launches = 0
    res, lat, wall = drive(port, bodies, min(conns, 16), "fulltext")
    launches = {name: c.launches for name, c in counters.items()}
    dense_scorings = TRACKER.calls("bm25_dense_scores_sorted") - scorings0
    _, k1 = http(port, "GET", "/_kernels")
    calls = {name: k1["kernels"].get(name, {}).get("calls", 0)
             - k0["kernels"].get(name, {}).get("calls", 0)
             for name in counters}
    refused = [(i, st, r) for i, (st, r) in enumerate(res) if st != 200]
    check(not refused, f"no body of the mix is refused: {refused[:3]}")
    p50, p99 = p50_p99(lat)
    out["launches"] = launches
    out["kernels_calls"] = calls
    out["dense_scorings"] = dense_scorings
    # every dense BM25 scoring of the mix is one launch of the
    # contribution kernel; the plan path and the position checks launch
    # none, nor the merge
    check(calls == launches
          and launches["gather_bm25_contrib"] == dense_scorings > 0
          and launches["merge_sorted_slots"] == 0,
          f"the contribution kernel launched once per dense BM25 scoring "
          f"({dense_scorings}), the merge not at all, and /_kernels "
          f"agrees: {launches} vs {calls}")
    out["load"] = dict(requests=len(bodies), wall_s=wall,
                       qps=len(bodies) / wall, p50_ms=p50, p99_ms=p99,
                       clients=min(conns, 16))
    log(f"[fulltext] {out['load']}; launches {launches}")
    # (b) each answer against the float64 oracle
    t0 = time.time()
    cands = {}
    for i, ((kind, qb, thunk, pins), (_, r)) in enumerate(zip(mix, res)):
        what = f"fulltext body {i} ({kind}: {json.dumps(qb)[:120]})"
        check(r["hits"]["total"]["value"] > 0 or kind in (
            "phrase", "phrase_bool", "phrase_prefix", "intervals"),
            f"{what}: matches docs")
        if thunk is None:
            continue
        scores, n_cand = thunk()
        cands[i] = n_cand
        check_ft_answer(r, scores, what, constant=kind == "multi_term",
                        pinned=pins)
    out["oracle_s"] = time.time() - t0
    # (c) the first body of each kind and query type equal to the port's
    # CPU execution (PERF.md section 4: the cut; every body is held to
    # the oracle)
    t0 = time.time()
    firsts = {}
    for i, (kind, qb, _, _) in enumerate(mix):
        firsts.setdefault((kind, next(iter(qb))), i)
    for i, ((kind, qb, _, _), (_, r)) in enumerate(zip(mix, res)):
        if firsts[(kind, next(iter(qb)))] != i:
            continue
        c = cpu.search("fulltext", bodies[i])
        what = f"fulltext body {i} ({kind})"
        if "text_expansion" in qb:   # float32 sums in another order
            same_hits(r, c, what, rtol=1e-5)
        else:
            equal_to_cpu(r, c, what)
    out["cpu_s"] = time.time() - t0
    out["cpu_bodies"] = len(firsts)
    log(f"[fulltext] oracle {out['oracle_s']:.1f} s, CPU "
        f"{out['cpu_s']:.1f} s ({len(firsts)} bodies)")
    # (d) where each body's time goes: the first body of each kind and
    # query type once more, alone, with profile: true; the score stage's
    # host work from the profile's children (search/queries.py)
    per_body = []
    for i, ((kind, qb, _, _), (_, r)) in enumerate(zip(mix, res)):
        if firsts[(kind, next(iter(qb)))] != i:
            continue
        st, p = http(port, "POST", "/fulltext/_search",
                     dict(bodies[i], profile=True))
        what = f"fulltext body {i} ({kind}) with profile: true"
        check(st == 200 and p["hits"]["total"] == r["hits"]["total"]
              and [h["_id"] for h in p["hits"]["hits"]]
              == [h["_id"] for h in r["hits"]["hits"]],
              f"{what}: the same hits")
        shard = p["profile"]["shards"][0]
        q = shard["searches"][0]["query"][0]
        work = next((ch["breakdown"] for ch in
                     shard["searches"][0].get("children", [])
                     if ch["type"] == "score"), {})
        per_body.append(dict(
            body=i, kind=kind, query_ms=q["time_in_nanos"] / 1e6,
            rewrite_ms=q["breakdown"].get("rewrite", 0) / 1e6,
            score_ms=q["breakdown"].get("score", 0) / 1e6,
            **{f"{k}_ms": work.get(k, 0) / 1e6
               for k in ("expand", "select", "verify", "upload")},
            candidates=shard.get("device", {}).get("verify_candidates", 0),
            oracle_candidates=cands.get(i),
            kernels={k["kernel"]: k["calls"]
                     for k in shard.get("device", {}).get("kernels", [])}))
    out["per_body"] = per_body
    by_kind = {}
    for b in per_body:
        agg = by_kind.setdefault(b["kind"], dict(
            bodies=0, query_ms=0.0, rewrite_ms=0.0, score_ms=0.0,
            expand_ms=0.0, select_ms=0.0, verify_ms=0.0, upload_ms=0.0,
            candidates=0))
        agg["bodies"] += 1
        for k in agg:
            if k != "bodies":
                agg[k] += b[k]
    out["by_kind"] = by_kind
    log(f"[fulltext] where the time goes, by kind: {by_kind}")
    # (e) the device ms of the conjunction filter and the feature sum
    ctx = node.search_service._shard_searchers(svc)[0]._contexts()[0]
    dp = ctx.device.postings["title"]
    two = sorted((cands[i], i) for i, (kind, qb, _, _) in enumerate(mix)
                 if kind == "phrase"
                 and isinstance(qb["match_phrase"]["title"], str)
                 and len(qb["match_phrase"]["title"].split()) == 2)
    phrase_text = mix[two[len(two) // 2][1]][1]["match_phrase"]["title"]
    tids = sorted({dp.host.term_id(t) for t in phrase_text.split()})
    sels, cids = [], []
    for ci, tid in enumerate(tids):
        s, _ = dp.select_blocks([tid], [1.0])
        sels.append(s)
        cids.append(np.full(len(s), ci, np.int32))
    sel = torch.from_numpy(np.concatenate(sels)).to(dp.block_docids.device)
    cid = torch.from_numpy(np.concatenate(cids)).to(dp.block_docids.device)
    nd = ctx.n_docs_padded
    ms, host_ms = cuda_ms(lambda: bm25_ops.conjunction_mask(
        dp.block_docids, dp.block_tfs, sel, cid, len(tids), nd), 20)
    n_sel = int(sel.numel())
    bnd, by = bound_ms(n_sel * 128 * 8 + n_sel * 8 + nd, 0, "int32")
    out["conjunction_mask"] = dict(ms=ms, host_ms=host_ms, blocks=n_sel,
                                   n_docs=nd, bound_ms=bnd, bound_by=by)
    tokens = next(qb for kind, qb, _, _ in mix
                  if "text_expansion" in qb)["text_expansion"]["ml.tokens"][
                      "tokens"]
    names = [f"ml.tokens.{t}" for t in tokens]
    plane = torch.stack([ctx.device.numerics[f] for f in names])
    miss = torch.stack([ctx.device.numeric_missing[f] for f in names])
    w = torch.tensor(list(tokens.values()), dtype=torch.float32,
                     device=plane.device)
    ms, host_ms = cuda_ms(lambda: feature_plane_sum(plane, miss, w), 20)
    t = len(names)
    bnd, by = bound_ms(t * nd * 5 + t * 4 + nd * 5, 2 * t * nd, "float32")
    out["feature_plane_sum"] = dict(ms=ms, host_ms=host_ms, tokens=t,
                                    n_docs=nd, bound_ms=bnd, bound_by=by)
    log(f"[fulltext] conjunction_mask {out['conjunction_mask']}; "
        f"feature_plane_sum {out['feature_plane_sum']}")
    del plane, miss
    return out


# ---------------------------------------------------------------- phase 11
KW_EXTRA = 2000        # docs of "kw"'s bulked second segment
KW_BIG = 1 << 30       # the oracle's rank of a missing value
FETCH_SIZE = 100


def kw_extra_docs(vocab, seed):
    """The second segment of "kw": ``KW_EXTRA`` docs (ids x0 ...) with
    titles of 3-8 of the first 200 corpus terms and a ``cat``: about 30 %
    "zz-only" (a term of this segment only), 20 % none, the rest one of
    c250 ... c259."""
    from elasticsearch_tpu_torch.corpus import term_name
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(KW_EXTRA):
        d = {"title": " ".join(term_name(int(t)) for t in rng.integers(
            0, min(vocab, 200), int(rng.integers(3, 9))))}
        r = rng.random()
        if r < 0.3:
            d["cat"] = "zz-only"
        elif r >= 0.5:
            d["cat"] = f"c{250 + int(rng.integers(0, 10)):03d}"
        docs.append(d)
    return docs


class KeywordOracle:
    """numpy answers of keyword sorts over "kw"'s two segments: each
    doc's term rank in the union of the segments' terms (KW_BIG where it
    has none), segment and docid."""

    def __init__(self, ords0, terms0, extra):
        self.terms = sorted(set(terms0) | {d["cat"] for d in extra
                                           if "cat" in d})
        rank = {t: i for i, t in enumerate(self.terms)}
        r_of = np.array([rank[t] for t in terms0], np.int64)
        r0 = np.where(ords0 >= 0, r_of[np.maximum(ords0, 0)], KW_BIG)
        r1 = np.array([rank.get(d.get("cat"), KW_BIG) for d in extra],
                      np.int64)
        self.ranks = np.concatenate([r0, r1])
        self.segs = np.concatenate([np.zeros(len(r0), np.int64),
                                    np.ones(len(r1), np.int64)])
        self.docids = np.concatenate([np.arange(len(r0)),
                                      np.arange(len(r1))])
        self.ids = np.array([str(i) for i in range(len(r0))]
                            + [f"x{i}" for i in range(len(r1))])

    def key(self, order):
        """The sort key: ascending rank, or descending, missing last."""
        if order == "asc":
            return self.ranks
        return np.where(self.ranks == KW_BIG, KW_BIG, -self.ranks)

    def cursor_key(self, term, order):
        """A cursor term's key (an absent term sits between its
        neighbours)."""
        import bisect
        if term is None:
            return KW_BIG
        i = bisect.bisect_left(self.terms, term)
        fr = i if i < len(self.terms) and self.terms[i] == term else i - 0.5
        return fr if order == "asc" else -fr

    def page(self, order, size, mask=None, doc_key=False, after=None):
        """(ids, sort values, total) of a sort on ``cat`` (then ``_doc``
        with ``doc_key``): ties by (segment, docid), or by (docid,
        segment) under ``_doc``; ``after`` a search_after cursor."""
        key = self.key(order)
        sel = np.ones(len(key), bool) if mask is None else mask.copy()
        total = int(sel.sum())
        if after is not None:
            ck = self.cursor_key(after[0], order)
            if doc_key and len(after) > 1:
                sel &= (key > ck) | ((key == ck) & (self.docids > after[1]))
            else:
                sel &= key > ck
        idx = np.nonzero(sel)[0]
        if doc_key:
            o = np.lexsort((self.segs[idx], self.docids[idx], key[idx]))
        else:
            o = np.lexsort((self.docids[idx], self.segs[idx], key[idx]))
        idx = idx[o][:size]
        vals = [[None if self.ranks[i] == KW_BIG else self.terms[
            self.ranks[i]]] + ([int(self.docids[i])] if doc_key else [])
            for i in idx]
        return self.ids[idx].tolist(), vals, total


def check_kw_page(r, want, what):
    ids, vals, total = want
    check(r["hits"]["total"] == {"value": total, "relation": "eq"},
          f"{what}: total {r['hits']['total']} vs the oracle's {total}")
    check([h["_id"] for h in r["hits"]["hits"]] == ids,
          f"{what}: ids and order")
    check([h["sort"] for h in r["hits"]["hits"]] == vals,
          f"{what}: sort values")


def same_fetch(r, c, what):
    """An HTTP answer against the port's CPU execution: equal_to_cpu, and
    each hit's _source, fields and highlight equal."""
    equal_to_cpu(r, c, what)
    for a, b in zip(r["hits"]["hits"], c["hits"]["hits"]):
        for key in ("_source", "fields", "highlight", "sort"):
            check(a.get(key) == b.get(key), f"{what}: hit {a['_id']} {key}")
    check(r.get("terminated_early") == c.get("terminated_early"),
          f"{what}: terminated_early")


def profiled_split(port, index, body):
    """{query_ms, fetch_ms, device_ms, host_ms, stages: the query's
    stages in ms} of ``body`` from its profile: true answer."""
    st, p = http(port, "POST", f"/{index}/_search", dict(body, profile=True))
    check(st == 200, f"profile: true on {index}: {p}")
    sh = p["profile"]["shards"][0]
    q = sh["searches"][0]["query"][0]
    br = q["breakdown"]
    return dict(query_ms=q["time_in_nanos"] / 1e6,
                # a shard with no hit on the page fetches nothing
                fetch_ms=sh.get("fetch", {}).get("time_in_nanos", 0) / 1e6,
                device_ms=br.get("device_time_in_nanos", 0) / 1e6,
                host_ms=br.get("host_time_in_nanos", 0) / 1e6,
                stages={k: v / 1e6 for k, v in br.items()
                        if isinstance(v, (int, float)) and v
                        and not k.endswith("_in_nanos")})


def mix_load(port, bodies, index, conns, what):
    """Every body of one mix from ``conns`` Python clients: the results
    (each a 200) and qps, p50 and p99."""
    res, lat, wall = drive(port, bodies, conns, index)
    bad = [(i, st, r) for i, (st, r) in enumerate(res) if st != 200]
    check(not bad, f"{what}: no body refused: {bad[:2]}")
    p50, p99 = p50_p99(lat)
    return res, dict(requests=len(bodies), qps=len(bodies) / wall,
                     p50_ms=p50, p99_ms=p99, clients=conns)


def conversion_cohorts(node, index, bodies, k, reps=3):
    """The cohorts the PlanBatcher forms from ``bodies`` on ``index``'s
    first segment (grouped by its signature, at most 32 a launch), with
    conversion on and off: per cohort its Q, lanes, the launch's ms by
    CUDA events (``cuda_ms``, 3 launches a window: a plan launch is
    hundreds of kernels, and the host's gaps count when it cannot queue
    them ahead) and its kernels' summed device ms under torch.profiler,
    with the kernels a launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from elasticsearch_tpu_torch.ops import plan as plan_ops
    from elasticsearch_tpu_torch.search import batching
    from elasticsearch_tpu_torch.search import plan as tplan
    from elasticsearch_tpu_torch.search.plan import (bind_plan,
                                                     compile_plan,
                                                     launch_mask)
    from elasticsearch_tpu_torch.search.queries import parse_query
    from elasticsearch_tpu_torch.search.searcher import ShardSearcher
    svc = node.indices[index]
    searcher = ShardSearcher(svc.engine.segments, svc.mapper,
                             node.device_cache, svc.k1, svc.b)
    ctx = searcher._contexts()[0]
    out = {}
    saved = tplan.FILTER_CACHE_MIN_BLOCKS
    try:
        for mode, threshold in (("on", saved), ("off", 1 << 40)):
            tplan.FILTER_CACHE_MIN_BLOCKS = threshold
            groups = {}
            for b in bodies:
                bp = bind_plan(compile_plan(parse_query(b["query"]),
                                            searcher), ctx, k)
                groups.setdefault(batching.PlanBatcher._signature(
                    bp, ctx, k, svc.k1, svc.b), []).append(bp)
            rows = []
            for bps in groups.values():
                for lo in range(0, len(bps), batching.MAX_BATCH):
                    chunk = bps[lo:lo + batching.MAX_BATCH]
                    q = batching._q_bucket(len(chunk))
                    pad = chunk + [chunk[0]] * (q - len(chunk))
                    args, kw = batching.PlanBatcher.cohort_args(pad,
                                                                ctx.live)
                    kw["dense_mask"] = launch_mask(chunk[0], ctx)

                    def launch(args=args, kw=kw):
                        plan_ops.plan_topk_batch(*args, k1=svc.k1, b=svc.b,
                                                 k=k, **kw)
                    ms, _host = cuda_ms(launch, 3)
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        for _ in range(reps):
                            launch()
                        torch.cuda.synchronize()
                    kernels = kernel_rows(prof.key_averages())
                    rows.append(dict(
                        cohort=len(chunk), q_bucket=q,
                        lanes=batching.PlanBatcher._lanes(
                            [batching._Entry(bp) for bp in chunk]),
                        converted=chunk[0].n_converted, ms=ms,
                        kernel_ms=sum(self_dev(e) for e in kernels)
                        / reps / 1e3,
                        kernels=sum(e.count for e in kernels) / reps))
            out[mode] = dict(
                cohorts=rows,
                lanes_per_launch=float(np.mean([r["lanes"] for r in rows])),
                kernel_ms_per_cohort=float(np.mean([r["kernel_ms"]
                                                    for r in rows])),
                kernel_ms_total=float(sum(r["kernel_ms"] for r in rows)),
                ms_total=float(sum(r["ms"] for r in rows)))
    finally:
        tplan.FILTER_CACHE_MIN_BLOCKS = saved
    return out


def phase_fetch(node, port, corpus, queries, cols, seed, conns, counters,
                cpu):
    """The fetch and sort features and filter conversion on one H100
    (module docstring, phase 11)."""
    import torch

    from elasticsearch_tpu_torch.corpus import (bench_cat, dense_scores,
                                                keyword_postings,
                                                segment_from_corpus,
                                                term_name)
    from elasticsearch_tpu_torch.search import plan as tplan
    n = len(corpus["lens"])
    vocab = len(corpus["df"])
    rng = np.random.default_rng(seed)
    out = {}
    conns = min(conns, 16)
    # ---- set-up: "kw", the corpus with the bench's cat column (and its
    # postings, some docs without a value) and a bulked second segment
    t0 = time.time()
    ords, terms = bench_cat(n)
    ords = ords.copy()
    ords[::13] = -1
    node.create_index("kw", {"properties": {"title": {"type": "text"},
                                            "cat": {"type": "keyword"}}})
    kw = node.indices["kw"]
    kw.engine.install_segments([segment_from_corpus(
        corpus, name="kw0", keywords={"cat": {"ords": ords,
                                              "terms": terms}},
        fields={"cat": keyword_postings(ords, terms)})])
    extra = kw_extra_docs(vocab, seed + 1)
    bulk = "".join(json.dumps({"index": {"_id": f"x{i}"}}) + "\n"
                   + json.dumps(d) + "\n" for i, d in enumerate(extra))
    st, r = http(port, "POST", "/kw/_bulk", bulk, ndjson=True)
    check(st == 200 and not r["errors"], f"kw bulk: {str(r)[:200]}")
    check(http(port, "POST", "/kw/_refresh")[0] == 200, "kw _refresh")
    segs = kw.engine.segments
    check(len(segs) == 2, f"kw holds two segments: {len(segs)}")
    devs = [node.device_cache.get(s) for s in segs]
    torch.cuda.synchronize()
    ord0 = devs[0].hbm_bytes_by_class()["ordinals"]
    t1 = time.perf_counter()
    col = devs[0].keyword_ord_column("cat")
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t1) * 1e3
    out["sort_column"] = dict(
        build_ms=build_ms, bytes=int(col[0].nbytes + col[1].nbytes),
        charged=devs[0].hbm_bytes_by_class()["ordinals"] - ord0,
        n_docs=n)
    check(out["sort_column"]["charged"] == out["sort_column"]["bytes"],
          f"the sort column is charged under ordinals: {out['sort_column']}")
    out["setup_s"] = time.time() - t0
    log(f"[fetch] kw set up: {out['sort_column']}")
    orc = KeywordOracle(ords, terms, extra)

    def match_mask(t):
        m0 = np.zeros(n, bool)
        lo, hi = int(corpus["group_start"][t]), \
            int(corpus["group_start"][t + 1])
        m0[corpus["doc_ids"][lo:hi]] = True
        m1 = np.array([term_name(t) in d["title"].split() for d in extra])
        return np.concatenate([m0, m1])

    # ---- (a) keyword sorts against numpy, the kernels' counts from 0
    for c in counters.values():
        c.launches = 0
    terms_q = [int(t) for t in rng.integers(0, min(vocab, 200), 4)]
    sort_cases = []
    for order in ("asc", "desc"):
        sort_cases.append(({"sort": [{"cat": order}]}, order, None, False,
                           None))
        sort_cases.append(({"sort": [{"cat": order}, "_doc"]}, order, None,
                           True, None))
        for t in terms_q[:2]:
            sort_cases.append(({"query": {"match": {"title": term_name(t)}},
                                "sort": [{"cat": order}]}, order,
                               match_mask(t), False, None))
        for cur in (["zz-only"], ["c2505"], ["c100"], [None]):
            sort_cases.append(({"sort": [{"cat": order}],
                                "search_after": cur}, order, None, False,
                               cur))
    kw_bodies = [dict(b, size=FETCH_SIZE, _source=False)
                 for b, *_ in sort_cases]
    res, out["kw_sort_load"] = mix_load(port, kw_bodies, "kw", conns,
                                        "keyword sorts")
    for (body, order, mask, doc_key, after), (_, r) in zip(sort_cases, res):
        check_kw_page(r, orc.page(order, FETCH_SIZE, mask, doc_key, after),
                      f"keyword sort {json.dumps(body)[:120]}")
    out["kw_sort_split"] = [profiled_split(port, "kw", b) for b in kw_bodies]
    log(f"[fetch] keyword sorts, query vs fetch ms: {out['kw_sort_split']}")
    # a walk of 10 pages of 100 against one page of 1000
    walks = {}
    for order in ("asc", "desc"):
        sort = [{"cat": order}, "_doc"]
        st, whole = http(port, "POST", "/kw/_search",
                         {"sort": sort, "size": 1000, "_source": False})
        walked, after = [], None
        for _ in range(10):
            body = {"sort": sort, "size": 100, "_source": False}
            if after is not None:
                body["search_after"] = after
            st, r = http(port, "POST", "/kw/_search", body)
            check(st == 200, f"walk page: {r}")
            walked += r["hits"]["hits"]
            after = r["hits"]["hits"][-1]["sort"]
        check([h["_id"] for h in walked]
              == [h["_id"] for h in whole["hits"]["hits"]],
              f"the {order} walk of 10 pages equals one page of 1000")
        check_kw_page(whole, orc.page(order, 1000, doc_key=True),
                      f"one {order} page of 1000")
        walks[order] = dict(pages=10, docs=len(walked),
                            zz_only=sum(h["sort"][0] == "zz-only"
                                        for h in walked))
    out["walks"] = walks
    # ---- (b) collapse on cat: the first hit of each key
    collapse = []
    for t in terms_q:
        body = {"query": {"match": {"title": term_name(t)}},
                "collapse": {"field": "cat"}, "size": 10, "_source": False}
        st, r = http(port, "POST", "/kw/_search", body)
        st2, full = http(port, "POST", "/kw/_search",
                         {"query": body["query"], "size": 50,
                          "_source": False, "docvalue_fields": ["cat"]})
        check(st == st2 == 200, f"collapse body: {r}")
        seen, want = set(), []
        for h in full["hits"]["hits"]:
            key = (h.get("fields", {}).get("cat") or [None])[0]
            if key not in seen:
                seen.add(key)
                want.append((h["_id"], key))
        got = [(h["_id"], h["fields"]["cat"][0]) for h in r["hits"]["hits"]]
        check(got == want[:10], f"collapse on cat: first hit per key "
                                f"({got[:3]} vs {want[:3]})")
        same_fetch(r, cpu.search("kw", body), "collapse vs CPU")
        collapse.append(len(got))
    out["collapse_groups"] = collapse
    # ---- (c) _source filtering, fields, docvalue_fields, highlight on
    # "fulltext", each equal to the CPU execution
    ft = node.indices["fulltext"]
    fetch_bodies = []
    for i, q in enumerate(queries[:12]):
        text = " ".join(term_name(t) for t in q[:2])
        htype = ("unified", "plain", "fvh")[i % 3]
        fetch_bodies.append({
            "query": {"match": {"title": text}}, "size": FETCH_SIZE,
            "_source": [{"includes": ["title"]}, ["title"], False,
                        "ti*"][i % 4],
            "fields": ["views", "title"], "docvalue_fields": ["views"],
            "highlight": {"fields": {"title": {
                "type": htype, "fragment_size": 80,
                "number_of_fragments": 3}}}})
    res, out["fetch_load"] = mix_load(port, fetch_bodies, "fulltext", conns,
                                      "fetch bodies")
    fetch_split = []
    for i, (body, (_, r)) in enumerate(zip(fetch_bodies, res)):
        same_fetch(r, cpu.search("fulltext", body), f"fetch body {i}")
        check(all("highlight" in h for h in r["hits"]["hits"]),
              f"fetch body {i}: every hit highlighted")
        fetch_split.append(dict(
            type=body["highlight"]["fields"]["title"]["type"],
            **profiled_split(port, "fulltext", body)))
    out["fetch_split"] = fetch_split
    log(f"[fetch] highlight bodies, query vs fetch ms: {fetch_split}")
    # ---- (d) script_fields and terminate_after on "logs"
    logs = node.indices["logs"]
    b32 = np.nan_to_num(cols["bytes"]["values"], nan=0.0).astype(np.float32)
    s32 = cols["status"]["values"].astype(np.float32)
    script = "doc['bytes'].value / 1024 + doc['status'].value * 0.5"
    sbody = {"query": {"match_all": {}}, "sort": [{"@timestamp": "asc"}],
             "size": FETCH_SIZE, "_source": False,
             "script_fields": {"v": {"script": script}}}
    st, r = http(port, "POST", "/logs/_search", sbody)
    check(st == 200, f"script_fields: {r}")
    ids = np.array([int(h["_id"]) for h in r["hits"]["hits"]])
    got = np.array([h["fields"]["v"][0] for h in r["hits"]["hits"]])
    want = (b32[ids].astype(np.float64) / np.float32(1024)
            + s32[ids].astype(np.float64) * np.float32(0.5))
    check(ids.tolist() == list(range(FETCH_SIZE)),
          "script_fields: the first docs by @timestamp")
    check(np.allclose(got, want, rtol=1e-6, atol=0),
          "script_fields: the float64 oracle under float32 columns")
    same_fetch(r, cpu.search("logs", sbody), "script_fields vs CPU")
    st, r = http(port, "POST", "/logs/_search", dict(sbody, script_fields={
        "s": {"script": "double t = 0; for (int i = 0; i < 2; ++i) "
                        "{ t += doc['bytes'].value; } return t;"}}))
    check(st == 400 and r["error"]["type"] == "script_exception",
          f"a statement script field answers 400 script_exception: {r}")
    term_cases = [({"query": {"match_all": {}}, "terminate_after": 1000,
                    "sort": [{"@timestamp": "asc"}], "size": 10}, 1000),
                  ({"query": {"match": {"title": term_name(terms_q[0])}},
                    "terminate_after": 50, "size": 10}, 50)]
    for body, ta in term_cases:
        body = dict(body, _source=False)
        st, r = http(port, "POST", "/logs/_search", body)
        check(st == 200 and r["terminated_early"] is True
              and r["hits"]["total"] == {"value": ta, "relation": "gte"},
              f"terminate_after {ta}: {str(r)[:200]}")
        same_fetch(r, cpu.search("logs", body), "terminate_after")
    out["script_terminate"] = dict(script=script, checked=FETCH_SIZE)
    # ---- (e) filter conversion on "bench" (against the float64 oracle)
    # and on "kw" (a popular cat), on and off
    df = corpus["df"]
    hi = [int(t) for t in np.argsort(-df)[:4]]
    conv_bench = []
    for i, q in enumerate(queries[:12]):
        must = {"match": {"title": " ".join(term_name(t) for t in q[:3])}}
        f = {"term": {"title": term_name(hi[i % 4])}}
        shape = i % 3
        if shape == 0:
            qb = {"bool": {"must": [must], "filter": [f]}}
        elif shape == 1:
            qb = {"bool": {"must": [must], "must_not": [f]}}
        else:
            qb = {"bool": {"should": [must], "filter": [f],
                           "minimum_should_match": 1}}
        conv_bench.append((qb, list(q[:3]), hi[i % 4], shape))
    conv_kw = []
    for i, t in enumerate(terms_q):
        f = {"terms": {"cat": ["c000", "c001"][:1 + i % 2]}}
        must = {"match": {"title": term_name(t)}}
        conv_kw.append({"bool": {"must": [must], "filter": [f]}}
                       if i % 2 == 0 else
                       {"bool": {"must": [must], "must_not": [f]}})
    mixes = {"bench": [{"query": qb, "size": FETCH_SIZE, "_source": False}
                       for qb, *_ in conv_bench],
             "kw": [{"query": qb, "size": FETCH_SIZE, "_source": False}
                    for qb in conv_kw]}
    answers = {}
    cache0 = node.device_cache.cache_stats()["filter_mask"]
    saved = tplan.FILTER_CACHE_MIN_BLOCKS
    try:
        for mode, threshold in (("on", saved), ("off", 1 << 40)):
            tplan.FILTER_CACHE_MIN_BLOCKS = threshold
            for index, bodies in mixes.items():
                res, load = mix_load(port, bodies, index, conns,
                                     f"conversion {mode} on {index}")
                pr = [http(port, "POST", f"/{index}/_search",
                           dict(b, track_total_hits=10000))
                      for b in bodies]
                load["split"] = [profiled_split(port, index, b)
                                 for b in bodies]
                answers[(mode, index)] = (res, pr, load)
    finally:
        tplan.FILTER_CACHE_MIN_BLOCKS = saved
    cache1 = node.device_cache.cache_stats()["filter_mask"]
    # the phase's launches: its HTTP traffic from (a) to here
    out["launches"] = {name: c.launches for name, c in counters.items()}
    check(out["launches"]["gather_bm25_contrib"] > 0
          and out["launches"]["merge_sorted_slots"] == 0,
          f"phase 11 launched the contribution kernel and not the merge: "
          f"{out['launches']}")
    for index, bodies in mixes.items():
        (on, pon, _), (off, poff, _) = (answers[("on", index)],
                                        answers[("off", index)])
        for i in range(len(bodies)):
            what = f"conversion body {i} on {index}"
            equal_to_cpu(on[i][1], off[i][1], f"{what}: on vs off")
            # under a threshold the total is a lower bound; the hits are
            # the exact ask's
            for pruned, how in ((pon[i][1], "on"), (poff[i][1], "off")):
                check([(h["_id"], h["_score"])
                       for h in pruned["hits"]["hits"]]
                      == [(h["_id"], h["_score"])
                          for h in on[i][1]["hits"]["hits"]],
                      f"{what}: track_total_hits 10000 ({how}) answers "
                      f"the exact hits")
            if index == "kw":
                equal_to_cpu(on[i][1], cpu.search("kw", bodies[i]),
                             f"{what}: vs CPU")
    for i, (qb, qterms, f, shape) in enumerate(conv_bench):
        keep = match_mask(f)[:n]
        scores = dense_scores(corpus, qterms) * (~keep if shape == 1
                                                 else keep)
        check_ft_answer(answers[("on", "bench")][0][i][1], scores,
                        f"conversion body {i} on bench vs the oracle")
    out["conversion"] = dict(
        load={f"{mode}_{index}": answers[(mode, index)][2]
              for mode, index in answers},
        mask_cache={k: cache1[k] - cache0[k]
                    for k in ("hits", "misses", "evictions")},
        cohorts={index: conversion_cohorts(node, index, bodies, FETCH_SIZE)
                 for index, bodies in mixes.items()})
    log(f"[fetch] conversion {out['conversion']}")
    return out


# ---------------------------------------------------------------- phase 12
FIELDS_SIZE = 100
# a sixteenth of Rally geopoint's 60,844,404 documents (PERF.md section
# 4: the cut)
GEO_POINTS = 3_802_776
GEO_SEGMENTS = 4          # a segment's padded docids stay below 2^24
QA_QUESTIONS = 25_000     # the nested questions (PERF.md section 4: the cut)
ALERTS = 1_000            # the percolator index's stored queries (the cut)
# the stored queries of "alerts_small" (the first ones of "alerts"),
# which the percolations of ten documents and of a document by reference
# read (PERF.md section 4: the cut)
ALERTS_SMALL = 100
GEO_BAND = 1e-4           # the geo boundary rule against float64 (relative)
GEO_ABS_M = 1.0           # ... and its floor in meters (float32 sort keys)
GEO_CPU_REL = 1e-6        # CUDA's float32 distances against the CPU's
GEO_CPU_CAP = 16          # ... and the most docs one answer may differ by


def geo_oracle_distance(lat, lon, origin, radius):
    """(bool mask, band mask) [n] of a geo_distance body against the
    float64 haversine of the float32 columns: the band holds the docs
    within GEO_BAND (relative) of the radius, which float32 arithmetic
    may put on either side. Only points within the radius's latitude
    band are computed."""
    from elasticsearch_tpu_torch.common import geo
    olat, olon = origin
    dlat = np.degrees(radius * (1 + 2 * GEO_BAND)
                      / geo.EARTH_RADIUS_METERS) + 1e-3
    cand = np.nonzero(np.abs(lat - olat) <= dlat)[0]
    d = geo.haversine_meters(lat[cand], lon[cand], olat, olon)
    mask = np.zeros(len(lat), bool)
    band = np.zeros(len(lat), bool)
    mask[cand[d <= radius]] = True
    band[cand[np.abs(d - radius) <= GEO_BAND * radius]] = True
    return mask, band


def geo_oracle_bbox(lat32, lon32, top, left, bottom, right):
    """The box mask, float32 columns against float32 bounds (exact)."""
    f = np.float32
    ok = (lat32 <= f(top)) & (lat32 >= f(bottom))
    if left <= right:
        return ok & (lon32 >= f(left)) & (lon32 <= f(right))
    return ok & ((lon32 >= f(left)) | (lon32 <= f(right)))


def geo_oracle_polygon(lat32, lon32, plats, plons):
    """The even-odd polygon mask with the reference's float32 arithmetic
    (numpy float32 ops, each rounded as the card's), over the points of
    the polygon's box (widened by 0.01 degree) only."""
    n = len(plats)
    box = ((lat32 >= min(plats) - 0.01) & (lat32 <= max(plats) + 0.01)
           & (lon32 >= min(plons) - 0.01) & (lon32 <= max(plons) + 0.01))
    idx = np.nonzero(box)[0]
    la, lo = lat32[idx], lon32[idx]
    inside = np.zeros(len(idx), bool)
    j = n - 1
    for i in range(n):
        yi, xi, yj, xj = plats[i], plons[i], plats[j], plons[j]
        crosses = (np.float32(yi) > la) != (np.float32(yj) > la)
        denom = yj - yi
        denom = np.float32(denom if denom != 0 else 1e-300)
        with np.errstate(divide="ignore", invalid="ignore"):
            x_int = (np.float32(xj - xi) * (la - np.float32(yi)) / denom
                     + np.float32(xi))
        inside = np.where(crosses & (lo < x_int), ~inside, inside)
        j = i
    mask = np.zeros(len(lat32), bool)
    mask[idx[inside]] = True
    return mask


def check_constant_page(r, mask, band, what, size=FIELDS_SIZE,
                        ids_of=None):
    """A constant-score answer against its oracle mask: the hits are
    the first matched docs in docid order (``ids_of[docid]`` their ids,
    default the docid as text), the total exact. The docs of ``band``
    (the geo boundary rule) may fall either way: the total lies between
    the sure docs and the sure docs plus the band, every served doc is
    in the mask or the band, and every sure doc up to the page's last
    is served. Returns the band's count."""
    pos = ({i: d for d, i in enumerate(ids_of)} if ids_of is not None
           else None)
    served = [int(h["_id"]) if pos is None else pos[h["_id"]]
              for h in r["hits"]["hits"]]
    total = r["hits"]["total"]["value"]
    sure = np.nonzero(mask & ~band)[0]
    n_band = int(band.sum())
    check(len(sure) <= total <= len(sure) + n_band,
          f"{what}: total {total} vs the oracle's {len(sure)} (+{n_band} "
          f"in the band)")
    check(all(h["_score"] == 1.0 for h in r["hits"]["hits"]),
          f"{what}: constant score 1.0")
    check(served == sorted(served) and len(served) == min(size, total),
          f"{what}: {len(served)} hits in docid order")
    check(bool(np.all((mask | band)[served])),
          f"{what}: every hit in the oracle or its band")
    limit = served[-1] if len(served) == size else len(mask)
    check(set(sure[sure <= limit].tolist()) <= set(served),
          f"{what}: no oracle doc outside the band is missed")
    return n_band


def check_scored_page(r, scores, what, size=FIELDS_SIZE, ids_of=None):
    """A scored answer against a float64 oracle column (0: no match):
    total exact, served scores within rtol 1e-5, every oracle doc that
    is missing tied with the kth score."""
    matched = np.nonzero(scores > 0)[0]
    order = matched[np.lexsort((matched, -scores[matched]))][:size]
    check(r["hits"]["total"] == {"value": len(matched), "relation": "eq"},
          f"{what}: total {r['hits']['total']} vs the oracle's "
          f"{len(matched)}")
    pos = ({i: d for d, i in enumerate(ids_of)} if ids_of is not None
           else None)
    got = [int(h["_id"]) if pos is None else pos.get(h["_id"], -1)
           for h in r["hits"]["hits"]]
    check(len(got) == len(order) and -1 not in got
          and bool(np.all(scores[got] > 0)),
          f"{what}: {len(got)} hits, each an oracle match")
    served = np.array([h["_score"] for h in r["hits"]["hits"]], np.float64)
    want = scores[got]
    check(bool(np.all(np.abs(served - want) <= FT_RTOL * want)),
          f"{what}: served scores within rtol 1e-5 of the float64 oracle")
    kth = scores[order[-1]] if len(order) else 0.0
    miss = np.setdiff1d(order, got)
    check(bool(np.all(np.abs(scores[miss] - kth) <= FT_RTOL * kth)),
          f"{what}: every missing oracle doc ties the kth score")


def geo_cpu_distance(lat32, lon32, origin, ids):
    """float64 [len(ids)]: the port's float32 distances (m) of the docs
    ``ids`` on the CPU, the arithmetic the CPU execution ranks by."""
    import torch

    from elasticsearch_tpu_torch.common import geo
    ids = np.asarray(ids, np.int64)
    return geo.haversine_meters(torch.from_numpy(lat32[ids]),
                                torch.from_numpy(lon32[ids]), *origin,
                                xp=torch).double().numpy()


def geo_cpu_band(lat32, lon32, origin, radius):
    """bool [n]: the docs whose float32 distance on the CPU lies within
    GEO_CPU_REL (relative) of ``radius``, which CUDA's transcendentals
    (an ulp off the CPU's) may put on the other side. Only points
    within the radius's latitude band are computed."""
    from elasticsearch_tpu_torch.common import geo
    dlat = np.degrees(radius * (1 + 2 * GEO_BAND)
                      / geo.EARTH_RADIUS_METERS) + 1e-3
    cand = np.nonzero(np.abs(lat32 - np.float32(origin[0])) <= dlat)[0]
    d = geo_cpu_distance(lat32, lon32, origin, cand)
    band = np.zeros(len(lat32), bool)
    band[cand[np.abs(d - radius) <= GEO_CPU_REL * radius]] = True
    return band


def same_geo(r, c, what, band=None, dist=None):
    """A geopoint answer against the port's CPU execution; returns the
    docs the two differ by (at most GEO_CPU_CAP). Unsorted: ``band``
    (bool [n], ``geo_cpu_band``) holds the docs either side may count,
    so the totals differ by at most its count, and up to the shorter
    page's last doc the ids differ only by band docs. Sorted: the
    float64 sort values of every doc both serve equal, and a doc served
    by one side alone has its CPU float32 key (``dist(ids)``) within
    GEO_CPU_REL of the CPU page's last key."""
    g = [int(h["_id"]) for h in r["hits"]["hits"]]
    p = [int(h["_id"]) for h in c["hits"]["hits"]]
    if r["hits"]["hits"] and "sort" in r["hits"]["hits"][0]:
        gv = {int(h["_id"]): h["sort"][0] for h in r["hits"]["hits"]}
        pv = {int(h["_id"]): h["sort"][0] for h in c["hits"]["hits"]}
        check(all(gv[i] == pv[i] for i in set(gv) & set(pv)),
              f"{what}: sort values vs CPU")
        diff = sorted(set(g) ^ set(p))
        keys = dist(diff + [p[-1]])
        last = keys[-1]
        check(bool(np.all(np.abs(keys[:-1] - last) <= GEO_CPU_REL * last)),
              f"{what}: ids vs CPU but at the page's last key")
        differ = len(diff)
    else:
        n_band = int(band.sum())
        dt = abs(r["hits"]["total"]["value"] - c["hits"]["total"]["value"])
        check(dt <= n_band, f"{what}: totals vs CPU within the "
                            f"{GEO_CPU_REL} band ({n_band} docs)")
        limit = min(g[-1] if g else -1, p[-1] if p else -1)
        diff = {i for i in set(g) ^ set(p) if i <= limit}
        check(all(band[i] for i in diff),
              f"{what}: ids vs CPU but the band")
        differ = max(dt, len(diff))
    check(differ <= GEO_CPU_CAP,
          f"{what}: {differ} docs differ from the CPU (cap {GEO_CPU_CAP})")
    return differ


def profile_stages(port, index, body):
    """{query_ms, rewrite_ms, join_ms, topk_ms, score_ms, verify_ms} of
    ``body`` from its profile: true answer (ms)."""
    st, p = http(port, "POST", f"/{index}/_search", dict(body, profile=True))
    check(st == 200, f"profile: true on {index}: {str(p)[:200]}")
    q = p["profile"]["shards"][0]["searches"][0]
    br = q["query"][0]["breakdown"]
    kids = {c["type"]: c["breakdown"] for c in q.get("children", [])}
    return dict(query_ms=q["query"][0]["time_in_nanos"] / 1e6,
                rewrite_ms=q["rewrite_time"] / 1e6,
                join_ms=kids.get("rewrite", {}).get("join", 0) / 1e6,
                topk_ms=br.get("topk", 0) / 1e6,
                score_ms=br.get("score", 0) / 1e6,
                verify_ms=kids.get("score", {}).get("verify", 0) / 1e6)


def geo_polygon_points(center, radius, n):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = radius * (1 + 0.3 * np.cos(5 * t))
    return [{"lat": float(center[0] + r[i] * np.sin(t[i])),
             "lon": float(center[1] + 1.5 * r[i] * np.cos(t[i]))}
            for i in range(n)]


def op_counter():
    """A TorchDispatchMode counting, in ``.n``, the PyTorch operator
    calls made inside it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))
    return OpCount()


def geo_mask_timings(node, index, lat32, bodies):
    """Device ms of each geo mask over the index's segments (CUDA events,
    the masks of every segment a call), the byte and operation bounds,
    the stable top-k over a constant-score mask of every point, and the
    kernel launches a polygon costs (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from elasticsearch_tpu_torch.ops.topk import masked_topk
    from elasticsearch_tpu_torch.search.queries import parse_query
    from elasticsearch_tpu_torch.search.searcher import ShardSearcher
    svc = node.indices[index]
    ctxs = ShardSearcher(svc.engine.segments, svc.mapper,
                         node.device_cache)._contexts()
    n = len(lat32)
    out = {}
    for name, body, ops_pt in bodies:
        q = parse_query(body)

        def run(q=q):
            for ctx in ctxs:
                q.do_execute(ctx)
        ms, host_ms = cuda_ms(run, 5)
        bound, by = bound_ms(11.0 * n, ops_pt * n, "float32")
        row = dict(ms=ms, host_ms=host_ms, bound_ms=bound, bound_by=by,
                   bytes_per_point=11)
        if name.startswith("polygon"):
            # the PyTorch ops a segment's mask issues, each at least one
            # kernel launch, and the kernels torch.profiler saw
            with op_counter() as ops:
                q.do_execute(ctxs[0])
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                q.do_execute(ctxs[0])
                torch.cuda.synchronize()
            row["ops_per_segment"] = ops.n
            row["kernels_per_segment"] = sum(
                e.count for e in kernel_rows(prof.key_averages()))
        out[name] = row
    # the stable top-k over a constant-score mask of every point (the
    # dense executor's masked_topk, k = 100, per segment)
    masks = [ctx.live & ctx.all_true() for ctx in ctxs]
    ones = [m.to(torch.float32) for m in masks]

    def topk():
        for s, m in zip(ones, masks):
            masked_topk(s, m, FIELDS_SIZE)
    ms, host_ms = cuda_ms(topk, 5)
    bound, by = bound_ms(5.0 * n, 3.0 * n, "float32")
    out["masked_topk_constant"] = dict(ms=ms, host_ms=host_ms,
                                       bound_ms=bound, bound_by=by)
    log(f"[fields] geo masks at {n} points: {out}")
    return out


def qa_oracle_nested_bool(ans, n_q, user, lo, hi):
    """The nested bool (term answers.user, range answers.date [lo, hi)):
    the flattened device filter (the user among the doc's users, the
    doc's first date in range in float32) and, per answer, the
    correlated check in float64."""
    f = np.float32
    first = np.full(n_q, np.nan)
    starts = np.concatenate([[0], np.cumsum(ans["n_ans"])])[:-1]
    has = ans["n_ans"] > 0
    first[has] = ans["date"][starts[has]]
    f32 = first.astype(np.float32)
    dev = has & (f32 >= f(lo)) & (f32 < f(hi))
    one = (ans["user"] == user) & (ans["date"] >= lo) & (ans["date"] < hi)
    corr = np.zeros(n_q, bool)
    corr[ans["doc"][one]] = True
    return dev & corr


def qa_text_bm25(ans, n_q, words, k1=1.2, b=0.75):
    """float64 BM25 [n_q] of the flattened answers.text field for the
    query ``words`` (word ids), and the docs that match."""
    toks = ans["text"]
    tok_doc = np.repeat(ans["doc"], 6).reshape(-1, 6)
    valid = toks >= 0
    lens = np.bincount(tok_doc[valid], minlength=n_q).astype(np.float64)
    n_docs = int((lens > 0).sum())
    avg = lens.sum() / max(n_docs, 1)
    scores = np.zeros(n_q)
    for w in words:
        hit = (toks == w)
        tf = np.bincount(tok_doc[hit], minlength=n_q).astype(np.float64)
        df = int((tf > 0).sum())
        if df == 0:
            continue
        idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
        norm = k1 * (1.0 - b + b * lens / avg)
        scores += np.where(tf > 0, idf * tf / (tf + norm), 0.0)
    return scores


def child_bm25(ans, words, k1=1.2, b=0.75):
    """float64 BM25 [A] of each answer's own ``text`` (the join twin's
    child docs; only the children hold the field)."""
    toks = ans["text"]
    lens = ans["text_len"].astype(np.float64)
    avg = lens.sum() / len(lens)
    n = len(lens)
    scores = np.zeros(n)
    for w in words:
        tf = (toks == w).sum(axis=1).astype(np.float64)
        df = int((tf > 0).sum())
        if df == 0:
            continue
        idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5))
        scores += np.where(tf > 0, idf * tf / (tf + k1 * (1 - b + b * lens
                                                          / avg)), 0.0)
    return scores


def percolate_oracle(rules, docs):
    """For each stored rule (kind, terms, lo, hi), the slots of ``docs``
    ((set of terms, views)) it matches."""
    out = []
    for kind, terms, lo, hi in rules:
        slots = []
        for s, (dterms, views) in enumerate(docs):
            in_range = lo <= views < hi
            text = bool(terms & dterms)
            ok = (text if kind == "match" else
                  text and in_range if kind == "bool" else in_range)
            if ok:
                slots.append(s)
        out.append(slots)
    return out


def phase_fields(node, port, corpus, queries, logs, cols, n_points, n_qa,
                 n_alerts, seed, conns, counters, cpu):
    """The remaining field types and their queries on one H100 (module
    docstring, phase 12)."""
    import ipaddress

    import torch

    from elasticsearch_tpu_torch.common import geo
    from elasticsearch_tpu_torch.corpus import (
        COUNTRY_CODES, QA_T0_MS, QA_USERS, QA_WORDS, dense_scores, envelope_columns,
        geo_columns, geo_points, ip_column, keyword_postings, multi_keyword,
        multi_numeric, postings_from_pairs, qa_answer_objects, qa_answers,
        qa_user, qa_word, segment_from_corpus, term_name)
    from elasticsearch_tpu_torch.index.segment import segment_from_numpy
    from elasticsearch_tpu_torch.telemetry.engine import TRACKER
    t_phase = time.time()
    rng = np.random.default_rng(seed)
    n = len(corpus["lens"])
    vocab = len(corpus["df"])
    conns = min(conns, 16)
    cpu.indices = node.indices
    out = {"sizes": {}}

    # ---- (a) geopoint: n_points points in GEO_SEGMENTS segments
    t0 = time.time()
    lat, lon, _city = geo_points(n_points, rng)
    del _city
    node.create_index("geopoint", {"properties": {
        "location": {"type": "geo_point"}}})
    per = -(-n_points // GEO_SEGMENTS)
    segs = []
    rss0, t_ids = host_rss_bytes(), 0.0
    for i in range(GEO_SEGMENTS):
        lo_, hi_ = i * per, min(n_points, (i + 1) * per)
        t_ids -= time.time()
        ids = [str(d) for d in range(lo_, hi_)]
        t_ids += time.time()
        segs.append(segment_from_numpy(
            {"numerics": geo_columns("location", lat[lo_:hi_],
                                     lon[lo_:hi_]),
             "ids": ids}, name=f"geopoint{i}"))
        del ids
    ids_rss = host_rss_bytes() - rss0
    node.indices["geopoint"].engine.install_segments(segs)
    for s in segs:
        node.device_cache.get(s)
    torch.cuda.synchronize()
    lat32 = lat.astype(np.float32)
    lon32 = lon.astype(np.float32)
    lat64, lon64 = lat32.astype(np.float64), lon32.astype(np.float64)
    out["sizes"]["geopoint"] = dict(
        points=n_points, segments=GEO_SEGMENTS, ids_s=t_ids,
        host_rss_added=ids_rss, host_free_gib=host_free_gib(),
        device_bytes=sum(node.device_cache.resident(s.name).hbm_bytes()
                         for s in segs), setup_s=time.time() - t0)
    log(f"[fields] geopoint: {out['sizes']['geopoint']}")

    # ---- (b) geonames: the corpus as places
    t0 = time.time()
    g_lat, g_lon, g_city = geo_points(n, rng)
    half = rng.uniform(0.005, 0.05, n)
    pop = np.round(rng.lognormal(7.0, 2.0, n))
    cc = np.where(g_city < 0, len(COUNTRY_CODES) - 1,
                  g_city % (len(COUNTRY_CODES) - 1)).astype(np.int32)
    cc_terms = sorted(COUNTRY_CODES)
    cc_rank = np.argsort(np.argsort(COUNTRY_CODES))
    cc = cc_rank[cc].astype(np.int32)
    node.create_index("geonames", {"properties": {
        "title": {"type": "text"}, "location": {"type": "geo_point"},
        "population": {"type": "long"},
        "country_code": {"type": "keyword"},
        "area": {"type": "geo_shape"}}})
    gseg = segment_from_corpus(
        corpus, name="geonames0",
        numerics={**geo_columns("location", g_lat, g_lon),
                  **envelope_columns("area", g_lat, g_lon, half),
                  "population": {"values": pop}},
        keywords={"country_code": {"ords": cc, "terms": cc_terms}},
        fields={"country_code": keyword_postings(cc, cc_terms)})
    node.indices["geonames"].engine.install_segments([gseg])
    g_lat32, g_lon32 = g_lat.astype(np.float32), g_lon.astype(np.float32)
    box32 = {k: gseg.numerics[f"area.{k}"].values.astype(np.float32)
             for k in ("min_lat", "min_lon", "max_lat", "max_lon")}
    out["sizes"]["geonames"] = dict(docs=n, setup_s=time.time() - t0)

    # ---- (c) logs_ip: the logs with clientip and a date_range
    t0 = time.time()
    ip, _nets = ip_column(n, rng)
    ts = cols["@timestamp"]["values"]
    s_lo = ts - rng.integers(0, 30 * 60_000, n)
    s_hi = ts + rng.integers(0, 2 * 3_600_000, n)
    node.create_index("logs_ip", {"properties": {
        "title": {"type": "text"}, "@timestamp": {"type": "date"},
        "clientip": {"type": "ip"}, "session": {"type": "date_range"}}})
    node.indices["logs_ip"].engine.install_segments([segment_from_corpus(
        logs, name="logs_ip0",
        numerics={"@timestamp": cols["@timestamp"],
                  "clientip": {"values": ip},
                  "session.lo": {"values": s_lo.astype(np.float64)},
                  "session.hi": {"values": s_hi.astype(np.float64)}})])
    ip32 = ip.astype(np.float32)
    slo32, shi32 = s_lo.astype(np.float32), s_hi.astype(np.float32)
    out["sizes"]["logs_ip"] = dict(docs=n, setup_s=time.time() - t0)

    # ---- (d) qa (nested answers) and its join twin qa_join
    t0 = time.time()
    from elasticsearch_tpu_torch.corpus import build_corpus
    qc = build_corpus(rng, n_docs=n_qa, vocab=20_000)
    ans = qa_answers(n_qa, rng)
    objs = qa_answer_objects(ans)
    users = [qa_user(u) for u in range(QA_USERS)]
    words = [qa_word(w) for w in range(QA_WORDS)]
    tok_valid = ans["text"] >= 0
    tok_doc = np.repeat(ans["doc"], 6).reshape(-1, 6)[tok_valid]
    tok_word = ans["text"][tok_valid]
    tok_ans = np.repeat(np.arange(len(ans["doc"])), 6).reshape(-1, 6)[
        tok_valid]
    starts = np.concatenate([[0], np.cumsum(ans["n_ans"])])
    streams = qc["stream"]
    qlens = qc["lens"].astype(np.int64)
    qstart = np.concatenate([[0], np.cumsum(qlens)])
    titles = [" ".join(term_name(int(t)) for t in
                       streams[qstart[i]:qstart[i + 1]])
              for i in range(n_qa)]
    sources = []
    for i in range(n_qa):
        d = {"title": titles[i]}
        if ans["n_ans"][i]:
            d["answers"] = objs[starts[i]:starts[i + 1]]
        sources.append(json.dumps(d, separators=(",", ":")).encode())
    node.create_index("qa", {"properties": {
        "title": {"type": "text"},
        "answers": {"type": "nested", "properties": {
            "user": {"type": "keyword"}, "date": {"type": "date"},
            "score": {"type": "integer"}, "text": {"type": "text"}}}}})
    node.indices["qa"].engine.install_segments([segment_from_corpus(
        qc, name="qa0",
        numerics={"answers.date": multi_numeric(ans["doc"], ans["date"],
                                                n_qa),
                  "answers.score": multi_numeric(
                      ans["doc"], ans["score"].astype(np.float64), n_qa)},
        keywords={"answers.user": multi_keyword(ans["doc"], ans["user"],
                                                n_qa, users)},
        fields={"answers.user": postings_from_pairs(
                    ans["doc"], ans["user"], n_qa, users, keyword=True),
                "answers.text": postings_from_pairs(
                    tok_doc, tok_word, n_qa, words)},
        sources=sources)])
    # the join twin: the questions (docids 0 .. n_qa - 1) then their
    # answers as child docs
    n_ch = len(ans["doc"])
    nj = n_qa + n_ch
    ch = np.arange(n_qa, nj)
    pids = [f"q{i}" for i in range(n_qa)]
    pid_terms = sorted(pids)
    pid_rank = np.empty(n_qa, np.int64)
    pid_rank[np.array([int(p[1:]) for p in pid_terms])] = np.arange(n_qa)
    rel_ords = np.concatenate([np.ones(n_qa, np.int32),
                               np.zeros(n_ch, np.int32)])
    parent_ords = np.concatenate([np.full(n_qa, -1, np.int32),
                                  pid_rank[ans["doc"]].astype(np.int32)])
    title_pf = postings_from_pairs(
        np.repeat(np.arange(n_qa), qlens), streams.astype(np.int64), nj,
        [term_name(t) for t in range(20_000)])
    child_id = [f"a{int(d)}_{int(k)}" for d, k in zip(
        ans["doc"], np.arange(n_ch) - starts[ans["doc"]])]
    jsources = [json.dumps({"title": titles[i], "qa": "question"},
                           separators=(",", ":")).encode()
                for i in range(n_qa)]
    jsources += [json.dumps(dict(o, qa={"name": "answer",
                                        "parent": f"q{int(d)}"}),
                            separators=(",", ":")).encode()
                 for o, d in zip(objs, ans["doc"])]
    node.create_index("qa_join", {"properties": {
        "title": {"type": "text"}, "text": {"type": "text"},
        "user": {"type": "keyword"}, "score": {"type": "integer"},
        "qa": {"type": "join", "relations": {"question": "answer"}}}})
    node.indices["qa_join"].engine.install_segments([segment_from_numpy({
        "fields": {"title": title_pf,
                   "text": postings_from_pairs(tok_ans + n_qa, tok_word,
                                               nj, words)},
        "numerics": {"score": {"values": np.concatenate([
            np.full(n_qa, np.nan), ans["score"].astype(np.float64)])}},
        "keywords": {"qa": {"terms": ["answer", "question"],
                            "ords": rel_ords},
                     "qa#parent": {"terms": pid_terms,
                                   "ords": parent_ords}},
        "ids": pids + child_id,
        "sources": jsources}, name="qa_join0")])
    out["sizes"]["qa"] = dict(questions=n_qa, answers=n_ch,
                              setup_s=time.time() - t0)
    del titles, jsources

    # ---- (e) alerts: n_alerts stored queries over _bulk; inbox
    t0 = time.time()
    amap = {"properties": {"query": {"type": "percolator"},
                           "title": {"type": "text"},
                           "views": {"type": "long"}}}
    for name in ("alerts", "alerts_small", "inbox"):
        node.create_index(name, amap)
    rules, lines = [], []
    for i in range(n_alerts):
        qterms = queries[i % len(queries)]
        q = qterms[: 1 + i % min(3, len(qterms))]
        text = " ".join(term_name(t) for t in q)
        lo_v = int(rng.integers(0, 900))
        hi_v = lo_v + int(rng.integers(10, 400))
        kind = ("match", "bool", "range")[i % 3]
        if kind == "match":
            stored = {"match": {"title": text}}
        elif kind == "bool":
            stored = {"bool": {"must": [{"match": {"title": text}}],
                               "filter": [{"range": {"views": {
                                   "gte": lo_v, "lt": hi_v}}}]}}
        else:
            stored = {"range": {"views": {"gte": lo_v, "lt": hi_v}}}
        rules.append((kind, {term_name(t) for t in q}, lo_v, hi_v))
        lines.append(json.dumps({"index": {"_id": f"rule{i}"}}) + "\n"
                     + json.dumps({"query": stored}) + "\n")
    n_small = min(ALERTS_SMALL, n_alerts)
    for name, part in (("alerts", lines), ("alerts_small", lines[:n_small])):
        st, r = http(port, "POST", f"/{name}/_bulk", "".join(part),
                     ndjson=True)
        check(st == 200 and not r["errors"], f"{name} bulk: {str(r)[:200]}")
        check(http(port, "POST", f"/{name}/_refresh")[0] == 200,
              f"{name} refresh")

    def corpus_doc(d):
        lo_, hi_ = int(corpus_starts[d]), int(corpus_starts[d + 1])
        toks = [term_name(int(t)) for t in corpus["stream"][lo_:hi_]]
        return {"title": " ".join(toks), "views": int(d % 1000)}, \
            (set(toks), int(d % 1000))
    corpus_starts = np.concatenate(
        [[0], np.cumsum(corpus["lens"].astype(np.int64))])
    picks = [int(d) for d in rng.integers(0, n, 12)]
    pdocs = [corpus_doc(d) for d in picks]
    st, r = http(port, "POST", "/inbox/_bulk",
                 json.dumps({"index": {"_id": "d1"}}) + "\n"
                 + json.dumps(pdocs[11][0]) + "\n", ndjson=True)
    check(st == 200 and not r["errors"], "inbox bulk")
    check(http(port, "POST", "/inbox/_refresh")[0] == 200, "inbox refresh")
    out["sizes"]["alerts"] = dict(stored_queries=n_alerts,
                                  small_stored_queries=n_small,
                                  setup_s=time.time() - t0)
    # every segment resident before the mixes: their first request does
    # not upload one
    t0 = time.time()
    for index in ("geonames", "logs_ip", "qa", "qa_join", "alerts",
                  "alerts_small", "inbox"):
        for seg in node.indices[index].engine.segments:
            node.device_cache.get(seg)
    torch.cuda.synchronize()
    out["sizes"]["upload_s"] = time.time() - t0
    log(f"[fields] set up: {out['sizes']}")

    # ---- the bodies, family by family: (index, family, body, check)
    cases = []
    # geopoint: origins at three dense cities
    dens = np.argsort(-np.bincount(np.clip(
        ((lat64 + 90) // 1).astype(np.int64) * 360
        + ((lon64 + 180) // 1).astype(np.int64), 0, 180 * 360 - 1),
        minlength=180 * 360))[:3]
    centres = [(float(c // 360 - 90 + 0.5), float(c % 360 - 180 + 0.5))
               for c in dens]
    (c0, c1, c2) = centres

    def dist(origin, km):
        return {"geo_distance": {"distance": f"{km}km", "location": {
            "lat": origin[0], "lon": origin[1]}}}
    for km in (1, 50, 1000):
        cases.append(("geopoint", f"geo_distance_{km}km",
                      {"query": dist(c0, km)},
                      ("distance", c0, km * 1000.0)))
    cases.append(("geopoint", "distance_range",
                  {"query": {"bool": {"must": [dist(c1, 200)],
                                      "must_not": [dist(c1, 50)]}}},
                  ("ring", c1, 200e3, 50e3)))
    box = (c0[0] + 2.0, c0[1] - 3.0, c0[0] - 2.0, c0[1] + 3.0)
    cases.append(("geopoint", "bbox", {"query": {"geo_bounding_box": {
        "location": {"top": box[0], "left": box[1], "bottom": box[2],
                     "right": box[3]}}}}, ("bbox", box)))
    dl = (20.0, 170.0, -20.0, -170.0)
    cases.append(("geopoint", "bbox_dateline", {"query": {
        "geo_bounding_box": {"location": {
            "top_left": {"lat": dl[0], "lon": dl[1]},
            "bottom_right": {"lat": dl[2], "lon": dl[3]}}}}},
        ("bbox", dl)))
    for nv in (5, 64):
        pts = geo_polygon_points(c2, 1.5, nv)
        cases.append(("geopoint", f"polygon_{nv}", {"query": {
            "geo_polygon": {"location": {"points": pts}}}},
            ("polygon", [p["lat"] for p in pts], [p["lon"] for p in pts])))
    for size in (10, 100):
        cases.append(("geopoint", f"sort_{size}", {
            "query": {"match_all": {}}, "size": size,
            "sort": [{"_geo_distance": {"location": {
                "lat": c1[0], "lon": c1[1]}, "unit": "km"}}]},
            ("sort", c1, size)))
    # geonames: match + geo filters (the contribution kernel), geo_shape
    gq = [q for q in queries if 2 <= len(q) <= 4][:4]
    gbox = (c0[0] + 8.0, c0[1] - 12.0, c0[0] - 8.0, c0[1] + 12.0)
    for i, q in enumerate(gq):
        text = " ".join(term_name(t) for t in q)
        if i % 2 == 0:
            filt = {"geo_bounding_box": {"location": {
                "top": gbox[0], "left": gbox[1], "bottom": gbox[2],
                "right": gbox[3]}}}
            ok = geo_oracle_bbox(g_lat32, g_lon32, *gbox)
        else:
            pts = geo_polygon_points(c0, 10.0, 12)
            filt = {"geo_polygon": {"location": {"points": pts}}}
            ok = geo_oracle_polygon(g_lat32, g_lon32,
                                    [p["lat"] for p in pts],
                                    [p["lon"] for p in pts])
        cases.append(("geonames", f"match_geo_{i}", {"query": {"bool": {
            "must": [{"match": {"title": text}}], "filter": [filt]}}},
            ("scored", dense_scores(corpus, q) * ok)))
    sq = (c0[0] - 5.0, c0[1] - 5.0, c0[0] + 5.0, c0[1] + 5.0)
    shape = {"type": "envelope", "coordinates": [[sq[1], sq[2]],
                                                 [sq[3], sq[0]]]}
    f = np.float32
    ov = ~((box32["max_lat"] < f(sq[0])) | (box32["min_lat"] > f(sq[2]))
           | (box32["max_lon"] < f(sq[1])) | (box32["min_lon"] > f(sq[3])))
    rel_masks = {
        "intersects": ov, "disjoint": ~ov,
        "within": ((box32["min_lat"] >= f(sq[0]))
                   & (box32["max_lat"] <= f(sq[2]))
                   & (box32["min_lon"] >= f(sq[1]))
                   & (box32["max_lon"] <= f(sq[3])))}
    pt = (float(g_lat[7]), float(g_lon[7]))
    rel_masks["contains"] = ((box32["min_lat"] <= f(pt[0]))
                             & (box32["max_lat"] >= f(pt[0]))
                             & (box32["min_lon"] <= f(pt[1]))
                             & (box32["max_lon"] >= f(pt[1])))
    for rel, m in rel_masks.items():
        qshape = (shape if rel != "contains" else
                  {"type": "point", "coordinates": [pt[1], pt[0]]})
        cases.append(("geonames", f"geo_shape_{rel}", {"query": {
            "geo_shape": {"area": {"shape": qshape, "relation": rel}}}},
            ("mask", m)))
    # logs_ip: single ip, CIDR /24 and /16, ip range, date_range relations
    common = ip[int(np.argmax(np.bincount(np.searchsorted(
        np.unique(ip), ip))))]
    ipa = ipaddress.ip_address
    net16 = int(common) >> 16 << 16
    net24 = int(common) >> 8 << 8
    for name, body, m, exact in (
            ("ip_term", {"term": {"clientip": str(ipa(int(common)))}},
             ip32 == f(common), ip == common),
            ("ip_cidr24", {"term": {"clientip": f"{ipa(net24)}/24"}},
             (ip32 >= f(net24)) & (ip32 <= f(net24 + 255)),
             (ip >= net24) & (ip <= net24 + 255)),
            ("ip_cidr16", {"term": {"clientip": f"{ipa(net16)}/16"}},
             (ip32 >= f(net16)) & (ip32 <= f(net16 + 65535)),
             (ip >= net16) & (ip <= net16 + 65535)),
            ("ip_range", {"range": {"clientip": {
                "gte": str(ipa(net16)), "lt": str(ipa(net16 + 4096))}}},
             (ip32 >= f(net16)) & (ip32 < f(net16 + 4096)),
             (ip >= net16) & (ip < net16 + 4096))):
        # the float32 column's gap: docs matched for a neighbouring
        # address the column cannot tell apart
        cases.append(("logs_ip", name, {"query": body},
                      ("mask", m, int(np.sum(m & ~exact)))))
    t_q0 = float(ts[n // 3])
    t_q1 = t_q0 + 3_600_000.0
    for rel in ("intersects", "within", "contains"):
        ql, qh = f(t_q0), f(t_q1)
        if rel == "within":
            m = (slo32 >= ql) & (shi32 <= qh)
        elif rel == "contains":
            ql = qh = f(t_q0 + 600_000.0)
            m = (slo32 <= ql) & (shi32 >= qh)
        else:
            m = (slo32 <= qh) & (shi32 >= ql)
        body = {"range": {"session": {
            "gte": int(t_q0 if rel != "contains" else t_q0 + 600_000),
            "lte": int(t_q1 if rel != "contains" else t_q0 + 600_000),
            "relation": rel}}}
        cases.append(("logs_ip", f"date_range_{rel}", {"query": body},
                      ("mask", m, 0)))
    # qa: nested bool (term + range), score_mode over a match, inner_hits
    top_users = np.argsort(-np.bincount(ans["user"],
                                        minlength=QA_USERS))[:3]
    d_lo = QA_T0_MS + 200 * 86_400_000.0
    d_hi = d_lo + 400 * 86_400_000.0
    for u in top_users[:2]:
        body = {"nested": {"path": "answers", "query": {"bool": {"must": [
            {"term": {"answers.user": qa_user(int(u))}},
            {"range": {"answers.date": {"gte": int(d_lo),
                                        "lt": int(d_hi)}}}]}}}}
        cases.append(("qa", "nested_bool", {"query": body},
                      ("qa_bool", int(u), d_lo, d_hi)))
    qwords = [int(w) for w in np.argsort(-np.bincount(
        tok_word, minlength=QA_WORDS))[[3, 40]]]
    cases.append(("qa", "nested_score_mode", {"query": {"nested": {
        "path": "answers", "score_mode": "avg", "query": {"match": {
            "answers.text": " ".join(qa_word(w) for w in qwords)}}}}},
        ("qa_text", qwords)))
    cases.append(("qa", "nested_inner_hits", {"query": {"nested": {
        "path": "answers", "query": {"term": {
            "answers.user": qa_user(int(top_users[2]))}},
        "inner_hits": {"size": 3}}}}, ("cpu",)))
    # qa_join: has_child per score_mode and min_children, has_parent
    # with score, parent_id
    cw = [int(w) for w in np.argsort(-np.bincount(
        tok_word, minlength=QA_WORDS))[[5, 60]]]
    for mode in ("none", "max", "sum", "avg", "min"):
        cases.append(("qa_join", f"has_child_{mode}", {"query": {
            "has_child": {"type": "answer", "score_mode": mode, "query": {
                "match": {"text": " ".join(qa_word(w) for w in cw)}}}}},
            ("has_child", cw, mode, 1)))
    cases.append(("qa_join", "has_child_min_children", {"query": {
        "has_child": {"type": "answer", "score_mode": "sum",
                      "min_children": 2, "query": {"match": {
                          "text": qa_word(cw[0])}}}}},
        ("has_child", cw[:1], "sum", 2)))
    pq = [int(t) for t in np.argsort(-qc["df"])[[20, 300]]]
    cases.append(("qa_join", "has_parent", {"query": {"has_parent": {
        "parent_type": "question", "score": True, "query": {"match": {
            "title": " ".join(term_name(t) for t in pq)}}}}},
        ("has_parent", pq)))
    cases.append(("qa_join", "parent_id", {"query": {"parent_id": {
        "type": "answer", "id": "q17"}}}, ("parent_id", 17)))
    # alerts: one document against every stored query; ten documents
    # and a document by index/id against the first ALERTS_SMALL
    slots_docs = {"one": ("alerts", [pdocs[0]]),
                  "ten": ("alerts_small", pdocs[1:11]),
                  "ref": ("alerts_small", [pdocs[11]])}
    for case, (index, docs) in slots_docs.items():
        spec = ({"field": "query", "index": "inbox", "id": "d1"}
                if case == "ref" else
                {"field": "query", "documents": [d for d, _ in docs]})
        cases.append((index, f"percolate_{case}", {
            "query": {"percolate": spec}, "size": 10000},
            ("percolate", [k for _, k in docs],
             n_alerts if index == "alerts" else n_small)))
    bodies = [dict(b, size=b.get("size", FIELDS_SIZE), _source=False)
              if idx != "qa" else dict(b, size=b.get("size", FIELDS_SIZE))
              for idx, _fam, b, _chk in cases]

    # ---- the counted window: every body over HTTP, index by index from
    # `conns` clients, the kernels' counts set to 0 just before
    _, k0 = http(port, "GET", "/_kernels")
    scorings0 = TRACKER.calls("bm25_dense_scores_sorted")
    for c in counters.values():
        c.launches = 0
    results = [None] * len(cases)
    loads = {}
    for index in ("geopoint", "geonames", "logs_ip", "qa", "qa_join",
                  "alerts", "alerts_small"):
        pos = [i for i, c in enumerate(cases) if c[0] == index]
        if index.startswith("alerts"):
            # the percolations one at a time, each latency its own
            res, took, wall = drive(port, [bodies[i] for i in pos], 1,
                                    index)
            check(all(st == 200 for st, _ in res), "percolate answered")
            loads[index] = dict(requests=len(pos), qps=len(pos) / wall,
                                latency_ms=[t * 1e3 for t in took],
                                clients=1)
        else:
            res, loads[index] = mix_load(port, [bodies[i] for i in pos],
                                         index, conns, f"{index} mix")
        for i, rr in zip(pos, res):
            results[i] = rr[1]
    launches = {name: c.launches for name, c in counters.items()}
    dense_scorings = TRACKER.calls("bm25_dense_scores_sorted") - scorings0
    _, k1 = http(port, "GET", "/_kernels")
    calls = {name: k1["kernels"].get(name, {}).get("calls", 0)
             - k0["kernels"].get(name, {}).get("calls", 0)
             for name in counters}
    out["launches"] = launches
    out["kernels_calls"] = calls
    out["dense_scorings"] = dense_scorings
    out["load"] = loads
    check(calls == launches
          and launches["gather_bm25_contrib"] == dense_scorings > 0
          and launches["merge_sorted_slots"] == 0,
          f"phase 12: the contribution kernel launched once per dense BM25 "
          f"scoring ({dense_scorings}), the merge not at all, and "
          f"/_kernels agrees: {launches} vs {calls}")
    log(f"[fields] launches {launches}, dense scorings {dense_scorings}, "
        f"load {loads}")

    # ---- every answer against its oracle and the CPU execution
    t0 = time.time()
    held = Counter()
    bands = {}
    cpu_exempt = {}
    no_band = np.zeros(len(lat32), bool)
    # held to the oracle alone: the 64-vertex polygon (on the CPU 64 x 11
    # elementwise passes over every point), four geopoint bodies (each
    # family's other sizes: one body a family is held to the CPU, each a
    # pass over 15.2M points there), and the percolations of one document
    # (1,000 stored queries) and of a document by reference (the ten
    # documents' percolation over the small index is held to the CPU)
    cpu_skip = {"polygon_64", "geo_distance_1km", "geo_distance_1000km",
                "bbox_dateline", "sort_100", "percolate_one",
                "percolate_ref"}
    spent = Counter()
    for (index, fam, body, chk), qbody, r in zip(cases, bodies, results):
        what = f"{index} {fam} {json.dumps(body)[:100]}"
        kind = chk[0]
        cpu_band = no_band
        if kind == "distance":
            m, band = geo_oracle_distance(lat64, lon64, chk[1], chk[2])
            bands[fam] = check_constant_page(r, m, band, what)
            cpu_band = geo_cpu_band(lat32, lon32, chk[1], chk[2])
        elif kind == "ring":
            m1, b1 = geo_oracle_distance(lat64, lon64, chk[1], chk[2])
            m2, b2 = geo_oracle_distance(lat64, lon64, chk[1], chk[3])
            bands[fam] = check_constant_page(r, m1 & ~m2, b1 | b2, what)
            cpu_band = (geo_cpu_band(lat32, lon32, chk[1], chk[2])
                        | geo_cpu_band(lat32, lon32, chk[1], chk[3]))
        elif kind == "bbox":
            check_constant_page(r, geo_oracle_bbox(lat32, lon32, *chk[1]),
                                no_band, what)
        elif kind == "polygon":
            check_constant_page(r, geo_oracle_polygon(lat32, lon32, chk[1],
                                                      chk[2]), no_band, what)
        elif kind == "sort":
            (olat, olon), size = chk[1], chk[2]
            pages = [r]
            after = r["hits"]["hits"][-1]["sort"]
            for _ in range(2):
                st, rp = http(port, "POST", "/geopoint/_search",
                              dict(qbody, search_after=after))
                check(st == 200, f"{what}: a search_after page")
                pages.append(rp)
                after = rp["hits"]["hits"][-1]["sort"]
            # the sort values are float64 distances of the stored
            # (unrounded) points
            near = np.nonzero(np.abs(lat - olat) <= 3.0)[0]
            d64 = geo.haversine_meters(lat[near], lon[near], olat, olon)
            by_id = dict(zip(near.tolist(), (d64 / 1000.0).tolist()))
            # the cursor is the last hit's float64 distance, compared
            # with the float32 device keys (the reference's), so a doc
            # whose float32 key lies above its float64 value comes back
            # on the next page: counted, not refused
            seen = set()
            repeats = 0
            for pg in pages:
                ids_ = [int(h["_id"]) for h in pg["hits"]["hits"]]
                vals = np.array([h["sort"][0] for h in pg["hits"]["hits"]])
                repeats += len(seen & set(ids_))
                check(len(ids_) == size, f"{what}: pages of {size}")
                check(bool(np.allclose(vals, [by_id.get(i, np.nan)
                                              for i in ids_],
                                       rtol=1e-12, atol=0)),
                      f"{what}: sort values are the float64 km")
                tol = (GEO_ABS_M + GEO_BAND * vals * 1000.0) / 1000.0
                check(bool(np.all(np.diff(vals) >= -tol[1:])),
                      f"{what}: sort values ascend")
                seen |= set(ids_)
            last = max(by_id[i] for i in seen)
            tol = (GEO_ABS_M + GEO_BAND * last * 1000.0) / 1000.0
            sure = {i for i, v in by_id.items() if v < last - tol}
            check(sure <= seen, f"{what}: every doc nearer than the walk's "
                                f"last is on a page")
            out.setdefault("walk_repeats", {})[fam] = repeats
        elif kind == "scored":
            check_scored_page(r, chk[1], what)
        elif kind == "mask":
            check_constant_page(r, chk[1], np.zeros(len(chk[1]), bool),
                                what)
            if len(chk) > 2:
                out.setdefault("f32_gap", {})[fam] = chk[2]
        elif kind == "qa_bool":
            m = qa_oracle_nested_bool(ans, n_qa, chk[1], chk[2], chk[3])
            # the inner bool's score: the keyword term's idf/(1+k1) plus
            # the range's 1.0, on every hit
            df_u = int(np.sum(np.bincount(ans["doc"][ans["user"] == chk[1]],
                                          minlength=n_qa) > 0))
            n_users = int(np.sum(ans["n_ans"] > 0))
            s = np.log(1 + (n_users - df_u + 0.5) / (df_u + 0.5)) / 2.2 + 1
            check_scored_page(r, np.where(m, s, 0.0), what)
        elif kind == "qa_text":
            check_scored_page(r, qa_text_bm25(ans, n_qa, chk[1]), what)
        elif kind == "has_child":
            cs = child_bm25(ans, chk[1])
            hit = cs > 0
            cnt = np.bincount(ans["doc"][hit], minlength=n_qa)
            mode = chk[2]
            if mode == "none":
                ps = (cnt >= chk[3]).astype(np.float64)
            elif mode == "sum" or mode == "avg":
                ps = np.bincount(ans["doc"][hit], cs[hit], minlength=n_qa)
                if mode == "avg":
                    ps = np.where(cnt > 0, ps / np.maximum(cnt, 1), 0.0)
            else:
                ps = np.full(n_qa, -np.inf if mode == "max" else np.inf)
                (np.maximum if mode == "max" else np.minimum).at(
                    ps, ans["doc"][hit], cs[hit])
                ps = np.where(cnt > 0, ps, 0.0)
            ps = np.where(cnt >= chk[3], ps, 0.0)
            check_scored_page(r, ps, what, ids_of=pids)
        elif kind == "has_parent":
            psc = dense_scores(qc, chk[1])
            check_scored_page(r, psc[ans["doc"]], what, ids_of=child_id)
        elif kind == "parent_id":
            m = ans["doc"] == chk[1]
            check_constant_page(r, m, np.zeros(len(m), bool), what,
                                ids_of=child_id)
        elif kind == "percolate":
            want = percolate_oracle(rules[:chk[2]], chk[1])
            hit_ids = [f"rule{i}" for i, s in enumerate(want) if s]
            check([h["_id"] for h in r["hits"]["hits"]] == hit_ids
                  and r["hits"]["total"]["value"] == len(hit_ids),
                  f"{what}: the matching stored queries in docid order")
            check([h["fields"]["_percolator_document_slot"]
                   for h in r["hits"]["hits"]]
                  == [s for s in want if s], f"{what}: the slots")
        held[index] += 1
        spent[index] -= time.time()
        if fam in cpu_skip:
            spent[index] += time.time()
            continue
        c = cpu.search(index, qbody)
        if index == "geopoint":
            origin = chk[1] if kind == "sort" else None
            cpu_exempt[fam] = (int(cpu_band.sum()), same_geo(
                r, c, what, cpu_band,
                lambda ids: geo_cpu_distance(lat32, lon32, origin, ids)))
        else:
            same_fetch(r, c, what)
            for a, b in zip(r["hits"]["hits"], c["hits"]["hits"]):
                check(a.get("inner_hits") == b.get("inner_hits"),
                      f"{what}: inner_hits vs CPU")
        if fam == "nested_inner_hits":
            for h in r["hits"]["hits"]:
                src = h["_source"]["answers"]
                for ih in h["inner_hits"]["answers"]["hits"]["hits"]:
                    check(src[ih["_nested"]["offset"]] == ih["_source"],
                          f"{what}: an inner hit's offset indexes _source")
        spent[index] += time.time()
    out["checked"] = dict(held)
    out["geo_band_docs"] = bands
    out["geo_cpu_band_differ"] = cpu_exempt
    out["oracle_cpu_s"] = dict(spent, total=time.time() - t0)
    log(f"[fields] held to the oracles and the CPU in "
        f"{out['oracle_cpu_s']} s: {dict(held)}, band docs {bands}, "
        f"vs CPU (band docs, docs that differ) {cpu_exempt}")

    # ---- profiles, device timings
    prof = {}
    index_of = {fam: index for index, fam, _b, _c in cases}
    for (index, fam, _b, _c), qbody in zip(cases, bodies):
        if not index.startswith("alerts"):   # a percolation's time is
            prof[fam] = profile_stages(port, index, qbody)   # its latency
    out["profile"] = prof
    out["percolate_ms_per_stored_query"] = [
        ms / n for index, n in (("alerts", n_alerts),
                                ("alerts_small", n_small))
        for ms in loads[index]["latency_ms"]]
    out["join_rewrite_host_ms"] = {f: p["join_ms"] for f, p in prof.items()
                                   if f.startswith(("has_", "parent_id"))}
    out["topk_share"] = {f: p["topk_ms"] / max(p["query_ms"], 1e-9)
                         for f, p in prof.items()
                         if index_of[f] == "geopoint"}
    out["geo_masks"] = geo_mask_timings(node, "geopoint", lat32, [
        ("distance", {"geo_distance": {"distance": "50km", "location": {
            "lat": c0[0], "lon": c0[1]}}}, 30.0),
        ("bbox", {"geo_bounding_box": {"location": {
            "top": box[0], "left": box[1], "bottom": box[2],
            "right": box[3]}}}, 6.0),
        ("polygon_5", {"geo_polygon": {"location": {
            "points": geo_polygon_points(c2, 1.5, 5)}}}, 5 * 10.0),
        ("polygon_64", {"geo_polygon": {"location": {
            "points": geo_polygon_points(c2, 1.5, 64)}}}, 64 * 10.0)])
    out["wall_s"] = time.time() - t_phase
    log(f"[fields] profile {prof}")
    return out


# ---------------------------------------------------------------- phase 13
SHARDS = 5          # Rally geonames' number_of_shards default
ROUTE_SAMPLE = 200_000      # the ids whose shard_for is checked
SHARD_K = 1000
# the depth of phase 13 (PERF.md section 4: the cuts): phase 4's first
# SHARD_MATCH queries, SHARD_FILTERS of its bool+filters mix, SHARD_DFS
# dfs bodies, SHARD_MULTI multi-index bodies, SHARD_SAMPLE bodies a kind
# held to the CPU execution
SHARD_MATCH = 16
SHARD_FILTERS = 8
SHARD_DFS = 8
SHARD_MULTI = 8
SHARD_SAMPLE = 2
DFS = "?search_type=dfs_query_then_fetch"


def routing_oracle(n, shards):
    """``abs(murmur3(str(d))) % shards`` for every docid d below ``n``,
    in numpy: the reference's routing formula (murmur3 x86 32, seed 0,
    over the UTF-16LE bytes of the id; a decimal digit is its code unit
    and a zero byte), vectorized over the ids of one length at a time."""
    m32 = np.uint64(0xFFFFFFFF)

    def rotl(x, r):
        return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & m32

    def mix_k(k):
        k = (k * np.uint64(0xCC9E2D51)) & m32
        k = rotl(k, 15)
        return (k * np.uint64(0x1B873593)) & m32

    d = np.arange(n, dtype=np.int64)
    width = np.ones(n, np.int64)
    for p in range(1, 19):
        width += d >= 10 ** p
    out = np.empty(n, np.int64)
    for w in np.unique(width):
        sel = np.nonzero(width == w)[0]
        units = np.stack([(d[sel] // 10 ** (w - 1 - j)) % 10 + 48
                          for j in range(w)], axis=1).astype(np.uint64)
        h = np.zeros(len(sel), np.uint64)
        for b in range(w // 2):
            h ^= mix_k(units[:, 2 * b] | (units[:, 2 * b + 1]
                                          << np.uint64(16)))
            h = rotl(h, 13)
            h = (h * np.uint64(5) + np.uint64(0xE6546B64)) & m32
        if w % 2:
            h ^= mix_k(units[:, w - 1])
        h ^= np.uint64(2 * w)
        h ^= h >> np.uint64(16)
        h = (h * np.uint64(0x85EBCA6B)) & m32
        h ^= h >> np.uint64(13)
        h = (h * np.uint64(0xC2B2AE35)) & m32
        h ^= h >> np.uint64(16)
        signed = h.astype(np.int64) - (h >= np.uint64(1 << 31)).astype(
            np.int64) * (1 << 32)
        out[sel] = np.abs(signed) % shards
    return out


class ShardOracle:
    """float64 answers over "bench5": each shard scores with its own
    statistics (doc count, df, average length), as the default search
    type does; ``dfs`` answers are the whole corpus's (phase 4's
    oracles)."""

    def __init__(self, corpus, subs, docs_of):
        self.corpus = corpus
        self.subs = subs
        self.docs_of = docs_of
        self.n = len(corpus["lens"])

    def scores(self, terms):
        from elasticsearch_tpu_torch.corpus import dense_scores
        out = np.zeros(self.n, np.float64)
        for sub, docs in zip(self.subs, self.docs_of):
            out[docs] = dense_scores(sub, terms)
        return out

    def topk(self, terms, k, keep=None):
        from elasticsearch_tpu_torch.corpus import topk_of_scores
        s = self.scores(terms)
        if keep is not None:
            s = np.where(keep, s, 0.0)
        return topk_of_scores(s, k)


def check_shards(r, what, total=SHARDS):
    check(r.get("_shards") == {"total": total, "successful": total,
                               "skipped": 0, "failed": 0},
          f"{what}: _shards {r.get('_shards')} (every shard answered)")


def check_pairs(r, cands, k, total, what):
    """A multi-index answer against its float64 oracle ``cands`` ([(score,
    index, id)] of every index's top k): the total exact, and every
    oracle pair it lacks ties the kth score within rtol 1e-5."""
    check(r["hits"]["total"] == {"value": total, "relation": "eq"},
          f"{what}: total {r['hits']['total']} vs {total}")
    cands = sorted(cands, key=lambda c: -c[0])[:k]
    got = {(h["_index"], h["_id"]) for h in r["hits"]["hits"]}
    check(len(got) == len(cands), f"{what}: hit count")
    kth = cands[-1][0] if cands else 0.0
    check(all(abs(sc - kth) <= 1e-5 * kth
              for sc, i, d in cands if (i, d) not in got),
          f"{what}: the missing oracle pairs tie the kth score within "
          f"rtol 1e-5")


def phase_shards(node, port, corpus, queries, oracles, filt_pool, seed,
                 conns, counters, cpu, hbm_log):
    """An index of 5 shards on one H100 (module docstring, phase 13)."""
    import torch

    from elasticsearch_tpu_torch.corpus import (bench_cat, docs_with_all,
                                                segment_from_corpus,
                                                shard_corpus, term_name)
    from elasticsearch_tpu_torch.rest.native_http import loadgen
    from elasticsearch_tpu_torch.telemetry.engine import TRACKER
    n = len(corpus["lens"])
    out = {}
    # ---- routing: the port's shard_for against numpy, then the shards
    t0 = time.time()
    svc = node.create_index("bench5", {"properties": {
        "title": {"type": "text"}, "cat": {"type": "keyword"},
        "rank": {"type": "long"}}},
        {"index": {"number_of_shards": SHARDS}})
    # the port's shard_for on an even sample of the ids (PERF.md
    # section 4: the cut), the shards filled by numpy's murmur3
    assign = routing_oracle(n, SHARDS)
    sample = np.unique(np.linspace(0, n - 1, min(n, ROUTE_SAMPLE))
                       .astype(np.int64))
    t1 = time.time()
    got = np.fromiter((svc.shard_for(str(d)) for d in sample), np.int64,
                      len(sample))
    route_s = time.time() - t1
    counts = np.bincount(assign, minlength=SHARDS)
    check(np.array_equal(got, assign[sample]),
          f"bench5: the port's routing equals numpy's murmur3 on "
          f"{len(sample)} ids ({counts.tolist()})")
    ords, terms = bench_cat(n)
    subs, docs_of = [], []
    for sh in range(SHARDS):
        docs = np.nonzero(assign == sh)[0]
        sub = shard_corpus(corpus, docs)
        svc.shards[sh].install_segments([segment_from_corpus(
            sub, name=f"bench5[{sh}]_0",
            keywords={"cat": {"ords": ords[docs], "terms": terms}},
            numerics={"rank": {"values": docs.astype(np.float64)}},
            ids=sub["ids"])])
        sub.pop("ids")
        subs.append(sub)
        docs_of.append(docs)
    check([len(e.segments) for e in svc.shards] == [1] * SHARDS
          and [e.segments[0].n_docs for e in svc.shards] == counts.tolist(),
          "bench5: one segment a shard, each of its routed docs")
    # _bulk routes as shard_for: 2,000 docs through HTTP into "route5"
    node.create_index("route5", {"properties": {"title": {"type": "text"}}},
                      {"index": {"number_of_shards": SHARDS}})
    bulk = "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                   + json.dumps({"title": term_name(i % 97)}) + "\n"
                   for i in range(2000))
    st, r = http(port, "POST", "/route5/_bulk", bulk, ndjson=True)
    check(st == 200 and not r["errors"], f"route5 bulk: {str(r)[:200]}")
    st, r = http(port, "POST", "/route5/_refresh")
    check(st == 200 and r["_shards"]["total"] == SHARDS,
          f"route5 _refresh counts the shards: {r}")
    got = [sum(s.n_docs for s in e.segments)
           for e in node.indices["route5"].shards]
    check(got == np.bincount(routing_oracle(2000, SHARDS),
                             minlength=SHARDS).tolist(),
          f"route5: each shard holds the docs numpy routes to it: {got}")
    orc = ShardOracle(corpus, subs, docs_of)
    out["setup"] = dict(docs=n, shards=SHARDS, shard_docs=counts.tolist(),
                        routing_s=route_s, routed_ids=len(sample),
                        setup_s=time.time() - t0,
                        route5_shard_docs=got)
    log(f"[shards] set up: {out['setup']}")

    # ---- the bodies
    texts = [" ".join(term_name(t) for t in q) for q in queries]
    match = [match_body(q, SHARD_K) for q in queries[:SHARD_MATCH]]
    frng = np.random.default_rng(777)
    pool = frng.choice(filt_pool, size=min(8, len(filt_pool)), replace=False)
    filt_terms, filters = [], []
    for i, q in enumerate(queries[:SHARD_FILTERS]):
        f1, f2 = (int(x) for x in frng.choice(pool, size=2, replace=False))
        filt_terms.append((f1, f2))
        filters.append({"query": {"bool": {
            "must": [{"match": {"title": texts[i]}}],
            "filter": [{"match": {"title": term_name(f1)}},
                       {"match": {"title": term_name(f2)}}]}},
            "size": SHARD_K, "_source": False})
    aggs = [{"query": {"match": {"title": t}}, "size": 0,
             "aggs": {"cats": {"terms": {"field": "cat"}}}}
            for t in texts[:32]]
    sort = [{"cat": "asc"}, "_doc"]
    collapse = [{"query": {"match": {"title": t}}, "sort": [{"rank": "asc"}],
                 "collapse": {"field": "cat"}, "size": 10, "_source": False}
                for t in texts[:16]]
    tth = [dict(match_body(q, 100), track_total_hits=10000)
           for q in queries[:16]]
    tth_true = [match_body(q, 100) for q in queries[:16]]
    dfs = match[:SHARD_DFS]

    # ---- the counted window: every bench5 body over HTTP, the kernels'
    # counts set to 0 just before
    batcher = node.search_service.plan_batcher
    p0 = batcher.stats()
    front0 = node.http_stats()
    _, k0 = http(port, "GET", "/_kernels")
    scorings0 = TRACKER.calls("bm25_dense_scores_sorted")
    for c in counters.values():
        c.launches = 0
    res = {}
    load = {}
    # one request at a time first, once the shards are resident: a
    # body's latency without contention
    for b in match[:5]:
        t1 = time.perf_counter()
        check(http(port, "POST", "/bench5/_search", b)[0] == 200,
              "bench5 match alone")
        load.setdefault("alone_ms", []).append(
            (time.perf_counter() - t1) * 1e3)
    load["threads"] = threading.active_count()
    res["match"], load["match"] = mix_load(port, match, "bench5", conns,
                                           "bench5 match")
    res["filters"], load["filters"] = mix_load(port, filters, "bench5",
                                               conns, "bench5 filters")
    res["aggs"], load["aggs"] = mix_load(port, aggs, "bench5", 16,
                                         "bench5 aggs")
    st, whole = http(port, "POST", "/bench5/_search",
                     {"sort": sort, "size": 1000, "_source": False})
    check(st == 200, f"bench5 sort page: {whole}")
    walked, after, pages = [], None, []
    for _ in range(10):
        body = {"sort": sort, "size": 100, "_source": False}
        if after is not None:
            body["search_after"] = after
        st, r = http(port, "POST", "/bench5/_search", body)
        check(st == 200, f"bench5 walk page: {r}")
        pages.append(r)
        walked += r["hits"]["hits"]
        after = r["hits"]["hits"][-1]["sort"]
    res["collapse"], load["collapse"] = mix_load(port, collapse, "bench5",
                                                 16, "bench5 collapse")
    res["tth"], load["tth"] = mix_load(port, tth, "bench5", 16,
                                       "bench5 track_total_hits 10000")
    res["tth_true"], _ = mix_load(port, tth_true, "bench5", 16,
                                  "bench5 track_total_hits true")
    st, prof = http(port, "POST", "/bench5/_search",
                    dict(match[0], profile=True))
    check(st == 200, f"bench5 profile: {prof}")
    # dfs before and after its default twins
    res["dfs"], load["dfs"] = drive(port, dfs, conns, "bench5", DFS)[0], None
    res["dfs_twins"], _ = mix_load(port, dfs, "bench5", conns,
                                   "bench5 default twins")
    res["dfs_after"], t_dfs, w_dfs = drive(port, dfs, conns, "bench5", DFS)
    p50, p99 = p50_p99(t_dfs)
    load["dfs"] = dict(requests=len(dfs), qps=len(dfs) / w_dfs, p50_ms=p50,
                       p99_ms=p99, clients=conns)
    multi, t_multi, w_multi = drive(port, match[:SHARD_MULTI], 16,
                                    "bench,bench5", method="GET")
    res["multi"] = multi
    p50, p99 = p50_p99(t_multi)
    load["multi"] = dict(requests=SHARD_MULTI, qps=SHARD_MULTI / w_multi,
                         p50_ms=p50, p99_ms=p99, clients=16)
    # the load generator on bench5's match bodies: 1 round
    lg = loadgen(port, "/bench5/_search", match, conns, len(match))
    check(lg["done"] == len(match) and lg["non2xx"] == 0,
          f"bench5 load generator: {lg['done']} done, {lg['non2xx']} non-2xx")
    p1 = batcher.stats()
    out["plan_batcher"] = dict(
        launches=p1["launches"] - p0["launches"],
        batched_queries=p1["batched_queries"] - p0["batched_queries"],
        lat_ema_s=batcher._lat_ema)
    launches = {name: c.launches for name, c in counters.items()}
    dense_scorings = TRACKER.calls("bm25_dense_scores_sorted") - scorings0
    _, k1 = http(port, "GET", "/_kernels")
    front = front_since(node, front0)
    calls = {name: k1["kernels"].get(name, {}).get("calls", 0)
             - k0["kernels"].get(name, {}).get("calls", 0)
             for name in counters}
    sent = sum(len(v) for v in res.values()) + 5 + 1 + 10 + 1 + lg["done"]
    out["front"] = front
    check(front["fast"] == 0 and front["fallback"] >= sent,
          f"bench5: the front sent every request to the fallback workers "
          f"({sent} sent): {front}")
    out["launches"] = launches
    out["kernels_calls"] = calls
    out["dense_scorings"] = dense_scorings
    dense_bodies = len(aggs) + len(collapse)
    out["launches_per_dense_body"] = (launches["gather_bm25_contrib"]
                                      / dense_bodies)
    check(calls == launches
          and launches["gather_bm25_contrib"] == dense_scorings > 0
          and launches["merge_sorted_slots"] == 0,
          f"phase 13: the contribution kernel launched once per dense BM25 "
          f"scoring ({dense_scorings}), the merge not at all, and "
          f"/_kernels agrees: {launches} vs {calls}")
    p50, p99 = p50_p99(lg["lat_s"])
    load["loadgen_bench5"] = dict(requests=lg["done"],
                                  qps=lg["done"] / lg["wall_s"],
                                  p50_ms=p50, p99_ms=p99, conns=conns)
    # beside it, the one-shard "bench" through the same fallback workers
    # (_source: true bodies, which the C++ grammar refuses)
    src = [match_body(q, SHARD_K, source=True)
           for q in queries[:SHARD_MATCH]]
    lg1 = loadgen(port, "/bench/_search", src, conns, len(src))
    check(lg1["done"] == len(src) and lg1["non2xx"] == 0,
          f"bench load generator: {lg1['done']} done")
    p50, p99 = p50_p99(lg1["lat_s"])
    load["loadgen_bench"] = dict(requests=lg1["done"],
                                 qps=lg1["done"] / lg1["wall_s"],
                                 p50_ms=p50, p99_ms=p99, conns=conns)
    out["load"] = load
    log(f"[shards] launches {launches}, dense scorings {dense_scorings}, "
        f"load {load}")

    # ---- every answer against its oracle
    t0 = time.time()
    for kind, rs in res.items():
        for i, (st, r) in enumerate(rs):
            check(st == 200, f"bench5 {kind} body {i} -> {st} {str(r)[:200]}")
            check_shards(r, f"bench5 {kind} body {i}",
                         SHARDS + 1 if kind == "multi" else SHARDS)
    for i, (_, r) in enumerate(res["match"]):
        check_answer(r, orc.topk(queries[i], SHARD_K), "plan",
                     f"bench5 match body {i}")
    for i, (_, r) in enumerate(res["filters"]):
        keep = docs_with_all(corpus, list(filt_terms[i]))
        check_answer(r, orc.topk(queries[i], SHARD_K, keep), "plan",
                     f"bench5 filters body {i}")
    cat_terms = np.array(terms)
    for i, (_, r) in enumerate(res["aggs"]):
        m = orc.scores(queries[i]) > 0
        cnt = np.bincount(ords[m], minlength=len(terms))
        order = np.lexsort((np.arange(len(terms)), -cnt))
        top = [int(o) for o in order[:10] if cnt[o] > 0]
        agg_equal(r["aggregations"], {"cats": {
            "doc_count_error_upper_bound": 0,
            "sum_other_doc_count": int(cnt.sum() - cnt[top].sum()),
            "buckets": [{"key": str(cat_terms[o]), "doc_count": int(cnt[o])}
                        for o in top]}}, f"bench5 aggs body {i}")
        check(r["hits"]["total"] == {"value": int(m.sum()),
                                     "relation": "eq"},
              f"bench5 aggs body {i}: total")
    # the sort: cat ascending, then _doc (the shard-local docid), then
    # shard order; a cursor (term, docid) keeps, on every shard, the docs
    # after it in that shard's order, so a doc of a later shard that ties
    # the cursor on both keys is skipped (the reference's rule; counted)
    local = np.empty(n, np.int64)
    for docs in docs_of:
        local[docs] = np.arange(len(docs))
    merged = np.lexsort((assign, local, ords))
    by_sort = merged[:1000]
    check([int(h["_id"]) for h in whole["hits"]["hits"]] == by_sort.tolist()
          and [h["sort"] for h in whole["hits"]["hits"]]
          == [[str(cat_terms[ords[d]]), int(local[d])] for d in by_sort],
          "bench5: a cat sort over 5 shards equals numpy's")
    rank_in = np.empty(n, np.int64)
    rank_in[merged] = np.arange(n)
    want_walk, cur = [], None
    for _ in range(10):
        if cur is None:
            nxt = merged[:100]
        else:
            c, d = cur
            after_cur = (ords > c) | ((ords == c) & (local > d))
            cand = np.nonzero(after_cur)[0]
            nxt = cand[np.argsort(rank_in[cand], kind="stable")[:100]]
        want_walk += nxt.tolist()
        cur = (int(ords[nxt[-1]]), int(local[nxt[-1]]))
    check([int(h["_id"]) for h in walked] == want_walk,
          "bench5: each of the 10 walked pages equals numpy's cursor rule")
    out["walk"] = dict(pages=10, docs=len(walked), skipped_ties=len(
        set(by_sort.tolist()[:len(walked)]) - set(want_walk)))
    for i, (_, r) in enumerate(res["collapse"]):
        # each shard's first 50 matched docs by rank, merged by rank,
        # then the first doc of each cat
        m = np.nonzero(orc.scores(queries[i]) > 0)[0]
        m = np.sort(np.concatenate([m[assign[m] == sh][:50]
                                    for sh in range(SHARDS)]))
        seen, want_c = set(), []
        for d in m:
            if ords[d] not in seen:
                seen.add(ords[d])
                want_c.append(int(d))
        check([int(h["_id"]) for h in r["hits"]["hits"]] == want_c[:10]
              and [h["fields"]["cat"] for h in r["hits"]["hits"]]
              == [[str(cat_terms[ords[d]])] for d in want_c[:10]],
              f"bench5 collapse body {i}: ids and keys as numpy's")
    for i, ((_, r), (_, t)) in enumerate(zip(res["tth"], res["tth_true"])):
        exact = oracles[i][2]
        check([h["_id"] for h in r["hits"]["hits"]]
              == [h["_id"] for h in t["hits"]["hits"]],
              f"bench5 track_total_hits body {i}: the hits of the true ask")
        tot = r["hits"]["total"]
        check(tot["value"] <= min(exact, 10000)
              and (tot["relation"] == "gte" or tot["value"] == exact),
              f"bench5 track_total_hits body {i}: {tot} vs exact {exact}")
        check(t["hits"]["total"] == {"value": exact, "relation": "eq"},
              f"bench5 track_total_hits true body {i}: exact")
    entries = prof["profile"]["shards"]
    check([e["id"] for e in entries]
          == [f"[bench5][{i}]" for i in range(SHARDS)],
          f"bench5 profile: one entry a shard: {[e['id'] for e in entries]}")
    same_hits(prof, res["match"][0][1], "bench5 profile vs plain", 1e-6)
    phases = prof["profile"]["coordinator"]["phases"]
    out["profile"] = dict(
        shard_query_ms=[e["searches"][0]["query"][0]["time_in_nanos"] / 1e6
                        for e in entries],
        shard_fetch_ms=[e.get("fetch", {}).get("time_in_nanos", 0) / 1e6
                        for e in entries],
        query_ms=phases["query_ns"] / 1e6,
        merge_ms=phases.get("merge_ns", 0) / 1e6,
        fetch_ms=phases["fetch_ns"] / 1e6)
    # dfs: the whole corpus's statistics, the one-shard bench's answers,
    # the same whichever side of its default twin it was sent
    for i in range(len(dfs)):
        _, r = res["dfs"][i]
        _, again = res["dfs_after"][i]
        _, twin = res["dfs_twins"][i]
        check_answer(r, oracles[i], "plan", f"bench5 dfs body {i}")
        same_hits(r, again, f"bench5 dfs body {i} after its default twin",
                  1e-6)
        same_hits(twin, res["match"][i][1],
                  f"bench5 default twin {i} between dfs asks", 1e-6)
    bench_dfs = drive(port, [plan_body(q, SHARD_K)
                             for q in queries[:SHARD_DFS]], conns, "bench")[0]
    for i, (st, b) in enumerate(bench_dfs):
        check(st == 200, f"bench plan body {i}")
        same_hits(res["dfs"][i][1], b, f"bench5 dfs body {i} vs bench")
    for i, (_, r) in enumerate(res["multi"]):
        truth, sc, total = oracles[i]
        t5, s5, total5 = orc.topk(queries[i], SHARD_K)
        cands = ([(float(x), "bench", str(d)) for d, x in zip(truth, sc)]
                 + [(float(x), "bench5", str(d)) for d, x in zip(t5, s5)])
        check_pairs(r, cands, SHARD_K, total + total5,
                    f"bench,bench5 body {i}")
    out["oracle_s"] = time.time() - t0

    # ---- a sample of each kind against the port's CPU execution
    t0 = time.time()
    sample = dict(match=("bench5", match, None), filters=("bench5", filters,
                                                          None),
                  aggs=("bench5", aggs, None),
                  collapse=("bench5", collapse, None),
                  tth=("bench5", tth, None),
                  dfs=("bench5", dfs, "dfs_query_then_fetch"),
                  multi=("bench,bench5", match, None))
    for kind, (index, bodies, stype) in sample.items():
        for i in range(min(SHARD_SAMPLE, len(bodies))):
            c = cpu.search(index, bodies[i], stype)
            r = res[kind][i][1]
            what = f"bench5 {kind} body {i} vs CPU"
            equal_to_cpu(r, c, what)
            if kind == "aggs":
                agg_equal(r["aggregations"], c["aggregations"], what)
    c = cpu.search("bench5", {"sort": sort, "size": 1000, "_source": False})
    equal_to_cpu(whole, c, "bench5 sort page vs CPU")
    out["cpu_s"] = time.time() - t0
    hbm_agrees(node, "shards", hbm_log)
    out["hbm"] = hbm_log[-1]
    torch.cuda.synchronize()
    log(f"[shards] profile {out['profile']}, oracles {out['oracle_s']:.1f} "
        f"s, CPU {out['cpu_s']:.1f} s")
    # phase 15 sends the match and filter bodies again (main pops this)
    out["_carry"] = dict(
        match=match, filters=filters,
        match_answers=[r for _, r in res["match"]],
        filter_answers=[r for _, r in res["filters"]])
    return out


# ---------------------------------------------------------------- phase 14
# the 35 aggregation types earlier slices of the port deferred
DEFERRED_TYPES = (
    "adjacency_matrix", "auto_date_histogram", "boxplot", "bucket_script",
    "bucket_selector", "children", "composite", "cumulative_cardinality",
    "diversified_sampler", "geo_bounds", "geo_centroid", "geo_distance",
    "geohash_grid", "geotile_grid", "ip_range", "matrix_stats",
    "median_absolute_deviation", "moving_avg", "moving_fn",
    "moving_percentiles", "multi_terms", "nested", "normalize", "parent",
    "rare_terms", "sampler", "scripted_metric", "serial_diff",
    "significant_terms", "significant_text", "string_stats", "t_test",
    "top_hits", "top_metrics", "variable_width_histogram")
DEFERRED_RTOL = 1e-6
COMPOSITE_PAGE = 1000
SCRIPTED_DOCS = 20_000      # the scripted_metric body's bounded filter
# Kibana Maps' viewport (Europe) and its tile precision
VIEWPORT = {"top_left": {"lat": 60.0, "lon": -10.0},
            "bottom_right": {"lat": 35.0, "lon": 30.0}}
PARIS = {"lat": 48.8566, "lon": 2.3522}


def agg_types(aggs):
    """Every aggregation type named anywhere in an aggs tree."""
    out = set()
    for node in (aggs or {}).values():
        for k, v in node.items():
            if k in ("aggs", "aggregations"):
                out |= agg_types(v)
            elif k != "meta":
                out.add(k)
    return out


def deferred_bodies(texts, logs_terms, t0_ms, scripted_to):
    """(name, index, body) of phase 14: each deferred type at least
    once, at the sizes Kibana sends, a ``match`` where the type is
    scored."""
    m = [{"match": {"title": t}} for t in texts]
    inc = {"match": {"title": logs_terms}}
    day = {"field": "@timestamp", "fixed_interval": "30m"}
    rank_min = {"date_histogram": {"field": "rank", "fixed_interval": "4m"}}
    return [
        # TSVB: a time series with its parent pipelines
        ("tsvb", "logs", {"size": 0, "query": {"range": {"@timestamp": {
            "gte": t0_ms, "lt": t0_ms + 12 * HOUR_MS}}},
            "aggs": {"h": {"date_histogram": day, "aggs": {
                "b": {"sum": {"field": "bytes"}},
                "mx": {"max": {"field": "bytes"}},
                "card": {"cardinality": {"field": "status"}},
                "pc": {"percentiles": {"field": "bytes",
                                       "percents": [50, 95]}},
                "mf": {"moving_fn": {
                    "buckets_path": "b", "window": 5,
                    "script": "MovingFunctions.unweightedAvg(values)"}},
                "ma": {"moving_avg": {"buckets_path": "b", "window": 5}},
                "sd": {"serial_diff": {"buckets_path": "mx", "lag": 1}},
                "mp": {"moving_percentiles": {"buckets_path": "pc",
                                              "window": 4}},
                "nz": {"normalize": {"buckets_path": "b",
                                     "method": "percent_of_sum"}},
                "cc": {"cumulative_cardinality": {"buckets_path": "card"}},
                "avg_b": {"bucket_script": {
                    "buckets_path": {"b": "b", "n": "_count"},
                    "script": "params.b / params.n"}},
                "busy": {"bucket_selector": {
                    "buckets_path": {"n": "_count"},
                    "script": "params.n > 100"}}}}}}),
        ("tsvb_match", "logs", {"size": 0, "query": inc, "aggs": {
            "h": {"date_histogram": {"field": "@timestamp",
                                     "fixed_interval": "1h"}, "aggs": {
                "b": {"max": {"field": "bytes"}},
                "d": {"serial_diff": {"buckets_path": "b", "lag": 2}},
                "r": {"bucket_script": {
                    "buckets_path": {"b": "b"},
                    "script": "params.b * 8 / 1024"}}}}}}),
        ("auto_date", "logs", {"size": 0, "aggs": {"a": {
            "auto_date_histogram": {"field": "@timestamp", "buckets": 30},
            "aggs": {"b": {"avg": {"field": "bytes"}}}}}}),
        ("vwh", "logs", {"size": 0, "query": m[1], "aggs": {"v": {
            "variable_width_histogram": {"field": "bytes",
                                         "buckets": 10}}}}),
        ("latest", "logs", {"size": 0, "aggs": {"s": {
            "terms": {"field": "status"}, "aggs": {"t": {"top_metrics": {
                "metrics": [{"field": "bytes"}],
                "sort": {"@timestamp": "desc"}, "size": 3}}}}}}),
        ("stats", "logs", {"size": 0, "query": m[2], "aggs": {
            "tt": {"t_test": {
                "a": {"field": "bytes", "filter": {"term": {"status": 200}}},
                "b": {"field": "bytes", "filter": {"term": {"status": 500}}},
                "type": "heteroscedastic"}},
            "ms": {"matrix_stats": {"fields": ["bytes", "status"]}},
            "bx": {"boxplot": {"field": "bytes"}},
            "mad": {"median_absolute_deviation": {"field": "bytes"}}}}),
        ("adjacency", "logs", {"size": 0, "aggs": {"adj": {
            "adjacency_matrix": {"filters": {
                "err": {"term": {"status": 500}},
                "incident": inc,
                "big": {"range": {"bytes": {"gte": 10000}}}}}}}}),
        ("samplers", "logs", {"size": 0, "query": m[3], "aggs": {
            "s": {"sampler": {"shard_size": 1000},
                  "aggs": {"st": {"terms": {"field": "status"}}}},
            "d": {"diversified_sampler": {"field": "status",
                                          "shard_size": 200,
                                          "max_docs_per_value": 50},
                  "aggs": {"b": {"stats": {"field": "bytes"}}}}}}),
        ("scripted", "logs", {"size": 0, "query": {"range": {
            "@timestamp": {"lt": scripted_to}}}, "aggs": {"sm": {
                "scripted_metric": {
                    "init_script": "state.n = 0; state.b = 0.0",
                    "map_script": "if (!doc['bytes'].empty) "
                                  "{ state.n += 1; "
                                  "state.b += doc['bytes'].value }",
                    "combine_script": "return state",
                    "reduce_script": "double b = 0; long n = 0; "
                                     "for (def s : states) { b += s.b; "
                                     "n += s.n } return n == 0 ? 0 "
                                     ": b / n"}}}}),
        # hybrid: the bench's skewed cat
        ("rare", "hybrid", {"size": 0, "query": m[4], "aggs": {
            "r": {"rare_terms": {"field": "cat", "max_doc_count": 3}},
            "ss": {"string_stats": {"field": "cat"}}}}),
        # bench5: 5 shards
        ("significant", "bench5", {"size": 0, "query": m[0], "aggs": {
            "s": {"significant_terms": {"field": "cat",
                                        "min_doc_count": 3}}}}),
        ("composite_bench5", "bench5", {"size": 0, "aggs": {"c": {
            "composite": {"size": COMPOSITE_PAGE, "sources": [
                {"cat": {"terms": {"field": "cat"}}},
                {"t": rank_min}]}}}}),
        ("composite_hybrid", "hybrid", {"size": 0, "aggs": {"c": {
            "composite": {"size": COMPOSITE_PAGE, "sources": [
                {"cat": {"terms": {"field": "cat"}}},
                {"f": {"histogram": {"field": "feat",
                                     "interval": 0.2}}}]}}}}),
        # geopoint: Kibana Maps
        ("maps", "geopoint", {"size": 0, "query": {"geo_bounding_box": {
            "location": VIEWPORT}}, "aggs": {
                "grid": {"geotile_grid": {"field": "location",
                                          "precision": 7, "size": 10000},
                         "aggs": {"c": {"geo_centroid": {
                             "field": "location"}}}},
                "hash": {"geohash_grid": {"field": "location",
                                          "precision": 5, "size": 100}},
                "b": {"geo_bounds": {"field": "location"}},
                "rings": {"geo_distance": {
                    "field": "location", "unit": "km", "origin": PARIS,
                    "ranges": [{"to": 100}, {"from": 100, "to": 500},
                               {"from": 500}]}}}}),
        ("world", "geopoint", {"size": 0, "aggs": {
            "grid": {"geohash_grid": {"field": "location", "precision": 3,
                                      "size": 10000}},
            "b": {"geo_bounds": {"field": "location"}},
            "c": {"geo_centroid": {"field": "location"}}}}),
        ("rings", "geopoint", {"size": 0, "aggs": {"rings": {
            "geo_distance": {"field": "location", "unit": "km",
                             "origin": PARIS,
                             "ranges": [{"to": 100},
                                        {"from": 100, "to": 500},
                                        {"from": 500, "to": 2000},
                                        {"from": 2000}]}}}}),
        # logs_ip
        ("ip", "logs_ip", {"size": 0, "query": m[5], "aggs": {"ip": {
            "ip_range": {"field": "clientip", "ranges": [
                {"to": "10.0.0.0"}, {"mask": "10.0.0.0/8"},
                {"from": "11.0.0.0", "to": "172.16.0.0"},
                {"mask": "192.168.0.0/16"}, {"from": "192.169.0.0"}]}}}}),
        # qa: nested answers; its join twin
        ("nested", "qa", {"size": 0, "aggs": {"n": {
            "nested": {"path": "answers"}, "aggs": {
                "u": {"terms": {"field": "answers.user", "size": 10}},
                "s": {"stats": {"field": "answers.score"}}}}}}),
        ("qa_latest", "qa", {"size": 0, "aggs": {"u": {
            "terms": {"field": "answers.user", "size": 5}, "aggs": {
                "top": {"top_hits": {"size": 1, "sort": [
                    {"answers.date": {"order": "desc"}}]}}}}}}),
        ("lens", "qa", {"size": 0, "aggs": {"mt": {"multi_terms": {
            "terms": [{"field": "answers.user"},
                      {"field": "answers.score"}], "size": 10}}}}),
        ("children", "qa_join", {"size": 0, "aggs": {"a": {
            "children": {"type": "answer"},
            "aggs": {"s": {"stats": {"field": "score"}}}}}}),
        ("parent", "qa_join", {"size": 0, "query": {"range": {
            "score": {"gte": 40}}}, "aggs": {"q": {
                "parent": {"type": "answer"}}}}),
        # fulltext: the _source the text and hits aggs read
        ("sig_text", "fulltext", {"size": 0, "query": m[6], "aggs": {
            "st": {"significant_text": {"field": "title",
                                        "min_doc_count": 2}}}}),
        ("hits", "fulltext", {"size": 0, "query": m[7], "aggs": {
            "top": {"top_hits": {"size": 5, "sort": [{"views": "desc"}]}},
            "first": {"top_hits": {"size": 3}}}}),
    ]


def composite_walk(port, index, body, what):
    """Every page of a composite body through ``after_key``: (buckets
    in order, pages, ms a page)."""
    walked, after, pages, took = [], None, 0, []
    for _ in range(1000):
        b = json.loads(json.dumps(body))
        if after is not None:
            b["aggs"]["c"]["composite"]["after"] = after
        t0 = time.perf_counter()
        st, r = http(port, "POST", f"/{index}/_search", b)
        took.append((time.perf_counter() - t0) * 1e3)
        check(st == 200 and r["_shards"]["failed"] == 0,
              f"{what} page {pages}: {str(r)[:200]}")
        c = r["aggregations"]["c"]
        if not c["buckets"]:
            check("after_key" not in c, f"{what}: an empty page's after_key")
            break
        walked += c["buckets"]
        after = c["after_key"]
        pages += 1
    return walked, pages, took


def o_composite(cat_terms, cat_ords, key2):
    """The composite's buckets from one grouped pass: (cat, second key)
    ascending, doc counts."""
    u2, inv2 = np.unique(key2, return_inverse=True)
    code = cat_ords.astype(np.int64) * len(u2) + inv2.reshape(-1)
    uc, cnt = np.unique(code, return_counts=True)
    return [(cat_terms[int(c // len(u2))], float(u2[int(c % len(u2))]),
             int(n)) for c, n in zip(uc, cnt)]


def tile_xy(lat, lon, zoom):
    """Web-mercator tile of float64 points by asinh (the reference
    takes log(tan + sec)); and whether each point lies within 1e-9 of a
    tile edge (in tile units), where the two may disagree."""
    n = 1 << zoom
    fx = (lon + 180.0) / 360.0 * n
    la = np.radians(np.clip(lat, -85.05112878, 85.05112878))
    fy = (1.0 - np.arcsinh(np.tan(la)) / np.pi) / 2.0 * n
    edge = (np.abs(fx - np.round(fx)) < 1e-9) \
        | (np.abs(fy - np.round(fy)) < 1e-9)
    x = np.clip(np.floor(fx), 0, n - 1).astype(np.int64)
    y = np.clip(np.floor(fy), 0, n - 1).astype(np.int64)
    return x, y, edge


def geohash_keys(lat, lon, precision):
    """float64 points' geohash cells by bisection of each axis into
    2^bits equal steps, spelled in base32; and whether each point lies
    within 1e-9 of a cell edge (in steps)."""
    nbits = 5 * precision
    lon_bits, lat_bits = (nbits + 1) // 2, nbits // 2
    fx = (lon + 180.0) / 360.0 * (1 << lon_bits)
    fy = (lat + 90.0) / 180.0 * (1 << lat_bits)
    edge = (np.abs(fx - np.round(fx)) < 1e-9) \
        | (np.abs(fy - np.round(fy)) < 1e-9)
    qx = np.clip(np.floor(fx), 0, (1 << lon_bits) - 1).astype(np.int64)
    qy = np.clip(np.floor(fy), 0, (1 << lat_bits) - 1).astype(np.int64)
    code = np.zeros(len(lat), np.int64)
    for i in range(nbits):       # lon takes the even bits
        src = (qx >> (lon_bits - 1 - i // 2)) if i % 2 == 0 \
            else (qy >> (lat_bits - 1 - i // 2))
        code = (code << 1) | (src & 1)
    return code, edge


def b32(code, precision):
    alphabet = "0123456789bcdefghjkmnpqrstuvwxyz"
    return "".join(alphabet[(int(code) >> (5 * (precision - 1 - i))) & 31]
                   for i in range(precision))


def check_grid(got_buckets, codes, edge, spell, size, what):
    """Grid bucket counts against the oracle's cells (integer codes,
    ``spell`` giving a code's key): exact, but a point within 1e-9 of a
    cell edge may fall on either side (counted and exempt); the
    ``size`` best cells by count, then key. Returns the exempt count."""
    u, c = np.unique(codes[~edge], return_counts=True)
    want = {spell(k): v for k, v in zip(u.tolist(), c.tolist())}
    n_edge = int(edge.sum())
    got = {b["key"]: b["doc_count"] for b in got_buckets}
    bad = [k for k in got if not 0 <= got[k] - want.get(k, 0) <= n_edge]
    check(not bad, f"{what}: counts equal numpy's ({n_edge} edge points "
                   f"exempt): {bad[:5]}")
    rest = [v for k, v in want.items() if k not in got]
    check(len(got) == min(size, len(got) + len(rest))
          and (not rest or max(rest) <= min(got.values()) + n_edge)
          and (rest or sum(got.values()) == len(codes)),
          f"{what}: the {len(got)} best cells of {len(got) + len(rest)}")
    keys = [b["key"] for b in got_buckets]
    counts = [b["doc_count"] for b in got_buckets]
    check(all(a > b or (a == b and ka < kb) for a, b, ka, kb in zip(
        counts, counts[1:], keys, keys[1:])),
        f"{what}: ordered by count, then key")
    return n_edge


def haversine_m(lat, lon, lat0, lon0):
    """Great-circle meters from (lat0, lon0), float64 numpy."""
    p1, l1 = np.radians(lat), np.radians(lon)
    p2, l2 = np.radians(lat0), np.radians(lon0)
    h = np.sin((p2 - p1) / 2) ** 2 + np.cos(p1) * np.cos(p2) \
        * np.sin((l2 - l1) / 2) ** 2
    return 2 * 6371008.7714 * np.arcsin(np.sqrt(np.clip(h, 0, 1)))


def near(got, want, what, rtol=DEFERRED_RTOL):
    check(got is not None and np.isclose(got, want, rtol=rtol, atol=0),
          f"{what}: {got!r} vs {want!r} (rtol {rtol})")


def jlh(fg, bg, fg_total, bg_total):
    fr, br = fg / fg_total, bg / bg_total
    return (fr - br) * (fr / br)


def phase_aggs_deferred(node, port, corpus, queries, logs, cols, feat,
                        conns, counters, cpu, hbm_log):
    """The 35 deferred aggregation types on one H100 (module docstring,
    phase 14)."""
    import scipy.stats

    from elasticsearch_tpu_torch.corpus import (DAY_MS, LOGS_T0_MS,
                                                bench_cat, dense_scores,
                                                term_name)
    from elasticsearch_tpu_torch.telemetry.engine import TRACKER
    t_phase = time.time()
    n = len(corpus["lens"])
    out = {}
    texts = [" ".join(term_name(t) for t in q) for q in queries[:8]]
    vocab = len(corpus["df"])
    inc_terms = " ".join(term_name(vocab + i) for i in range(2))
    # the scripted_metric's bounded filter: the first docs of the day
    n_scripted = min(SCRIPTED_DOCS, n // 10)
    scripted_to = LOGS_T0_MS + n_scripted * (DAY_MS // n)
    cases = deferred_bodies(texts, inc_terms, LOGS_T0_MS, scripted_to)
    covered = set().union(*(agg_types(b["aggs"]) for _, _, b in cases))
    check(set(DEFERRED_TYPES) <= covered,
          f"phase 14 sends every deferred type: missing "
          f"{sorted(set(DEFERRED_TYPES) - covered)}")
    shard_total = {"bench5": SHARDS}

    # ---- the counted window: each body once with profile: true, the
    # composite walks, the dashboard mix; the kernels' counts set to 0
    # just before
    _, k0 = http(port, "GET", "/_kernels")
    scorings0 = TRACKER.calls("bm25_dense_scores_sorted")
    for c in counters.values():
        c.launches = 0
    res, took = {}, {}
    for name, index, body in cases:
        t0 = time.perf_counter()
        st, r = http(port, "POST", f"/{index}/_search",
                     dict(body, profile=True))
        took[name] = (time.perf_counter() - t0) * 1e3
        check(st == 200, f"phase 14 {name} -> {st} {str(r)[:300]}")
        check(r["_shards"]["failed"] == 0
              and r["_shards"]["total"] == shard_total.get(index, 1),
              f"phase 14 {name}: _shards {r['_shards']}")
        res[name] = r
    walks = {}
    for name in ("composite_bench5", "composite_hybrid"):
        index, body = next((i, b) for nm, i, b in cases if nm == name)
        walks[name] = composite_walk(port, index, body, name)
    mix_names = ("maps", "tsvb", "latest", "significant", "lens",
                 "composite_bench5", "nested", "tsvb_match")
    # two rounds of the dashboard (PERF.md section 4: the cut)
    mix = [(i, b) for nm, i, b in cases if nm in mix_names] * 2
    mres, mlat, mwall = drive(port, [b for _, b in mix], min(conns, 8),
                              [i for i, _ in mix])
    check(all(st == 200 and r["_shards"]["failed"] == 0 for st, r in mres),
          "phase 14 dashboard mix: every answer 200 with no failed shard")
    launches = {name: c.launches for name, c in counters.items()}
    dense_scorings = TRACKER.calls("bm25_dense_scores_sorted") - scorings0
    _, k1 = http(port, "GET", "/_kernels")
    calls = {name: k1["kernels"].get(name, {}).get("calls", 0)
             - k0["kernels"].get(name, {}).get("calls", 0)
             for name in counters}
    out["launches"] = launches
    out["kernels_calls"] = calls
    out["dense_scorings"] = dense_scorings
    check(calls == launches
          and launches["gather_bm25_contrib"] == dense_scorings > 0
          and launches["merge_sorted_slots"] == 0,
          f"phase 14: the contribution kernel launched once per dense BM25 "
          f"scoring ({dense_scorings}), the merge not at all, and "
          f"/_kernels agrees: {launches} vs {calls}")
    p50, p99 = p50_p99(mlat)
    out["mix"] = dict(bodies=len(mix), clients=min(conns, 8),
                      qps=len(mix) / mwall, p50_ms=p50, p99_ms=p99)
    # each body's query and aggregation ms from its profile (the profile
    # folds the aggregation into the first shard's query entry)
    out["bodies"] = {}
    for name, _index, body in cases:
        ph = res[name]["profile"]["coordinator"]["phases"]
        out["bodies"][name] = dict(
            types=sorted(agg_types(body["aggs"])), http_ms=took[name],
            query_ms=(ph["query_ns"] - ph["aggs_ns"]) / 1e6,
            aggs_ms=ph["aggs_ns"] / 1e6)
    out["window_s"] = time.time() - t_phase
    log(f"[deferred] launches {launches}, dense scorings {dense_scorings}, "
        f"mix {out['mix']}, window {out['window_s']:.1f} s, walks "
        f"{ {k: (w[1], sum(w[2]) / 1e3) for k, w in walks.items()} }")
    log("[deferred] bodies (http, query, aggs ms): " + ", ".join(
        f"{k} {v['http_ms']:.0f}/{v['query_ms']:.0f}/{v['aggs_ms']:.0f}"
        for k, v in out["bodies"].items()))

    # ---- the oracles
    t0 = time.time()
    a = {name: r["aggregations"] for name, r in res.items()}
    # composites: every page, concatenated, against one grouped pass
    cat_ords, cat_terms = bench_cat(n)
    for name, key2, index in (
            ("composite_bench5",
             np.floor(np.arange(n, dtype=np.float64) / 240000.0) * 240000.0,
             "bench5"),
            ("composite_hybrid", np.floor(feat / 0.2) * 0.2, "hybrid")):
        walked, pages, ms = walks[name]
        want = o_composite(cat_terms, cat_ords, key2)
        got = [(b["key"]["cat"], b["key"][list(b["key"])[1]],
                b["doc_count"]) for b in walked]
        check(got == want, f"{name}: {pages} pages, concatenated, equal "
                           f"one grouped pass ({len(got)} vs {len(want)})")
        check(a[name]["c"]["buckets"] == walked[:COMPOSITE_PAGE],
              f"{name}: the first page as walked")
        out.setdefault("composite", {})[index] = dict(
            pages=pages, buckets=len(walked), ms_a_page=float(np.mean(ms)),
            page_ms=ms)
    # significant_terms on bench5: foreground and background counts
    fg_mask = dense_scores(corpus, queries[0]) > 0
    fg = np.bincount(cat_ords[fg_mask], minlength=len(cat_terms))
    bg = np.bincount(cat_ords, minlength=len(cat_terms))
    sig = a["significant"]["s"]
    check(sig["doc_count"] == int(fg_mask.sum()) and sig["bg_count"] == n,
          "significant_terms: foreground and background totals")
    for b in sig["buckets"]:
        o = cat_terms.index(b["key"])
        check(b["doc_count"] == int(fg[o]) and b["bg_count"] == int(bg[o]),
              f"significant_terms {b['key']}: counts")
        near(b["score"], jlh(fg[o], bg[o], fg_mask.sum(), n),
             f"significant_terms {b['key']}: JLH")
    # rare_terms and string_stats on hybrid under a match
    hm = dense_scores(corpus, queries[4]) > 0
    hc = np.bincount(cat_ords[hm], minlength=len(cat_terms))
    want_rare = sorted((int(hc[o]), cat_terms[o]) for o in range(len(hc))
                       if 0 < hc[o] <= 3)
    check([(b["doc_count"], b["key"]) for b in a["rare"]["r"]["buckets"]]
          == want_rare, "rare_terms: counts and order")
    ss = a["rare"]["ss"]
    lens_ = np.array([len(cat_terms[o]) for o in cat_ords[hm]])
    chars = Counter()
    for o in np.nonzero(hc)[0]:
        for ch in cat_terms[o]:
            chars[ch] += int(hc[o])
    p = np.array(list(chars.values()), np.float64) / sum(chars.values())
    check(ss["count"] == int(hm.sum()) and ss["min_length"] == lens_.min()
          and ss["max_length"] == lens_.max(), "string_stats: counts")
    near(ss["avg_length"], lens_.mean(), "string_stats: avg_length")
    near(ss["entropy"], float(-(p * np.log2(p)).sum()), "string_stats: entropy")
    # logs: t_test, matrix_stats, adjacency and the samplers
    by = cols["bytes"]["values"]
    status = cols["status"]["values"]
    m2 = dense_scores(logs, queries[2]) > 0
    xa = by[m2 & (status == 200) & ~np.isnan(by)]
    xb = by[m2 & (status == 500) & ~np.isnan(by)]
    near(a["stats"]["tt"]["value"],
         float(scipy.stats.ttest_ind(xa, xb, equal_var=False).pvalue),
         "t_test")
    both = m2 & ~np.isnan(by)
    mat = np.stack([by[both], status[both]])
    cov = np.cov(mat)           # the sample (n - 1) covariance
    ms = a["stats"]["ms"]
    check(ms["doc_count"] == int(both.sum()), "matrix_stats: doc_count")
    for i, f in enumerate(("bytes", "status")):
        fs = next(x for x in ms["fields"] if x["name"] == f)
        d = mat[i] - mat[i].mean()
        sd = np.sqrt(cov[i, i])
        near(fs["mean"], mat[i].mean(), f"matrix_stats {f} mean")
        near(fs["variance"], cov[i, i], f"matrix_stats {f} variance")
        # the moments over the sample standard deviation
        near(fs["skewness"], float(np.mean(d ** 3) / sd ** 3),
             f"matrix_stats {f} skewness")
        near(fs["kurtosis"], float(np.mean(d ** 4) / sd ** 4),
             f"matrix_stats {f} kurtosis")
        near(fs["correlation"]["bytes" if i else "status"],
             float(np.corrcoef(mat)[0, 1]), f"matrix_stats {f} correlation")
    inc_mask = dense_scores(logs, [vocab, vocab + 1]) > 0
    big = ~np.isnan(by) & (by.astype(np.float32) >= np.float32(10000))
    masks = {"err": status == 500, "incident": inc_mask, "big": big}
    want_adj = []
    names = sorted(masks)
    for i, x in enumerate(names):
        want_adj.append((x, int(masks[x].sum())))
        for y in names[i + 1:]:
            want_adj.append((f"{x}&{y}", int((masks[x] & masks[y]).sum())))
    check([(b["key"], b["doc_count"]) for b in a["adjacency"]["adj"]["buckets"]]
          == [kv for kv in want_adj if kv[1]], "adjacency_matrix: counts")
    m3 = np.nonzero(dense_scores(logs, queries[3]) > 0)[0]
    first = m3[:1000]
    got_s = {b["key"]: b["doc_count"]
             for b in a["samplers"]["s"]["st"]["buckets"]}
    u, c = np.unique(status[first], return_counts=True)
    check(a["samplers"]["s"]["doc_count"] == len(first)
          and got_s == {int(k): int(v) for k, v in zip(u, c)},
          "sampler: the first 1000 matched docs by docid")
    # scripted_metric: the bounded filter's count and its mean bytes
    ts32 = cols["@timestamp"]["values"].astype(np.float32)
    sm_docs = ts32 < np.float32(scripted_to)
    sv = by[sm_docs & ~np.isnan(by)]
    near(a["scripted"]["sm"]["value"], float(sv.mean()),
         "scripted_metric: mean bytes")
    sm_ms = out["bodies"]["scripted"]["aggs_ms"]
    out["scripted_metric"] = dict(docs=int(sm_docs.sum()), aggs_ms=sm_ms,
                                  us_per_doc=sm_ms * 1e3 / sm_docs.sum())
    # geopoint: bounds, centroid, the grids, the rings
    segs = node.indices["geopoint"].engine.segments
    lat = np.concatenate([s.numerics["location.lat"].values for s in segs])
    lon = np.concatenate([s.numerics["location.lon"].values for s in segs])
    wb = a["world"]["b"]["bounds"]
    check(wb == {"top_left": {"lat": float(lat.max()),
                              "lon": float(lon.min())},
                 "bottom_right": {"lat": float(lat.min()),
                                  "lon": float(lon.max())}},
          f"geo_bounds: exact {wb}")
    wc = a["world"]["c"]
    check(wc["count"] == len(lat), "geo_centroid: count")
    near(wc["location"]["lat"], lat.mean(), "geo_centroid lat")
    near(wc["location"]["lon"], lon.mean(), "geo_centroid lon")
    t1 = time.time()
    code, edge = geohash_keys(lat, lon, 3)
    n_edge = check_grid(a["world"]["grid"]["buckets"], code, edge,
                        lambda c: b32(c, 3), 10000,
                        "geohash_grid precision 3")
    lat32, lon32 = lat.astype(np.float32), lon.astype(np.float32)
    inbox = (lat32 <= np.float32(60.0)) & (lat32 >= np.float32(35.0)) \
        & (lon32 >= np.float32(-10.0)) & (lon32 <= np.float32(30.0))
    vlat, vlon = lat[inbox], lon[inbox]
    x, y, e7 = tile_xy(vlat, vlon, 7)
    tcode = x * 128 + y
    n_edge += check_grid(a["maps"]["grid"]["buckets"], tcode, e7,
                         lambda c: f"7/{c // 128}/{c % 128}", 10000,
                         "geotile_grid precision 7 in the viewport")
    vb = a["maps"]["b"]["bounds"]
    check(vb == {"top_left": {"lat": float(vlat.max()),
                              "lon": float(vlon.min())},
                 "bottom_right": {"lat": float(vlat.min()),
                                  "lon": float(vlon.max())}},
          "geo_bounds of the viewport")
    for b in a["maps"]["grid"]["buckets"][:50]:
        _z, bx, by_ = (int(v) for v in b["key"].split("/"))
        sel = tcode == bx * 128 + by_
        if not e7[sel].any():
            check(b["c"]["count"] == int(sel.sum()),
                  f"{b['key']} centroid count")
            near(b["c"]["location"]["lat"], vlat[sel].mean(),
                 f"{b['key']} centroid lat")
            near(b["c"]["location"]["lon"], vlon[sel].mean(),
                 f"{b['key']} centroid lon")
    out["grid"] = dict(points=len(lat), viewport_points=int(inbox.sum()),
                       edge_exempt=n_edge, oracle_s=time.time() - t1,
                       world_aggs_s=out["bodies"]["world"]["aggs_ms"] / 1e3,
                       maps_aggs_s=out["bodies"]["maps"]["aggs_ms"] / 1e3,
                       maps_buckets=len(a["maps"]["grid"]["buckets"]),
                       world_buckets=len(a["world"]["grid"]["buckets"]))
    for key, sub, edges in (
            ("rings", (lat, lon), ((None, 100), (100, 500), (500, 2000),
                                  (2000, None))),
            ("maps", (vlat, vlon), ((None, 100), (100, 500),
                                    (500, None)))):
        dist = haversine_m(*sub, PARIS["lat"], PARIS["lon"])
        for b, (lo, hi) in zip(a[key]["rings"]["buckets"], edges):
            sel = np.ones(len(dist), bool)
            if lo is not None:
                sel &= dist >= lo * 1000.0
            if hi is not None:
                sel &= dist < hi * 1000.0
            check(b["doc_count"] == int(sel.sum()),
                  f"geo_distance ring {b['key']} ({key}): {b['doc_count']} "
                  f"vs {int(sel.sum())}")
    hcode, hedge = geohash_keys(vlat, vlon, 5)
    n_edge += check_grid(a["maps"]["hash"]["buckets"], hcode, hedge,
                         lambda c: b32(c, 5), 100,
                         "geohash_grid precision 5 in the viewport")
    del lat, lon, lat32, lon32, vlat, vlon, dist, code
    # qa: multi_terms over the first values; nested objects
    qseg = node.indices["qa"].engine.segments[0]
    ukv = qseg.keywords["answers.user"]
    snv = qseg.numerics["answers.score"]
    okq = (ukv.ords >= 0) & ~snv.missing
    # (user ord, score) as one code; scores lie in [-5, 50), offset by
    # 500 so the code orders and decodes them, negative ones too
    pair = ukv.ords[okq].astype(np.int64) * 1000 + (
        snv.values[okq].astype(np.int64) + 500)
    up, cp = np.unique(pair, return_counts=True)
    top = np.lexsort((up, -cp))[:10]
    want_mt = [([ukv.terms[int(up[i] // 1000)], float(up[i] % 1000 - 500)],
                int(cp[i])) for i in top]
    check([(b["key"], b["doc_count"]) for b in a["lens"]["mt"]["buckets"]]
          == want_mt, "multi_terms: counts and order")
    # the objects of a doc: the most values any answers.* column holds
    nobj = int(np.maximum.reduce([
        np.diff(col.offsets) for cols_ in (qseg.numerics, qseg.keywords)
        for f, col in cols_.items() if f.startswith("answers.")]).sum())
    check(a["nested"]["n"]["doc_count"] == nobj,
          f"nested: {a['nested']['n']['doc_count']} objects vs {nobj}")
    jseg = node.indices["qa_join"].engine.segments[0]
    rel = jseg.keywords["qa"]
    is_answer = rel.ords == rel.terms.index("answer")
    check(a["children"]["a"]["doc_count"] == int(is_answer.sum()),
          "children: every answer of every question")
    sc = jseg.numerics["score"]
    hi = is_answer & ~sc.missing \
        & (sc.values.astype(np.float32) >= np.float32(40))
    parents = np.unique(jseg.keywords["qa#parent"].ords[hi])
    check(a["parent"]["q"]["doc_count"] == int((parents >= 0).sum()),
          "parent: the questions of the answers scored 40 and up")
    out["oracle_s"] = time.time() - t0
    log(f"[deferred] the oracles held in {out['oracle_s']:.1f} s")

    # ---- the first body of each type against the port's CPU execution
    t0 = time.time()
    seen = set()
    for name, index, body in cases:
        types = agg_types(body["aggs"])
        if types <= seen:
            continue
        seen |= types
        c = cpu.search(index, body)
        check(c["hits"]["total"] == res[name]["hits"]["total"],
              f"phase 14 {name}: total vs the CPU")
        agg_equal(res[name]["aggregations"], c["aggregations"],
                  f"phase 14 {name} vs the CPU")
    out["cpu_s"] = time.time() - t0
    hbm_agrees(node, "aggs_deferred", hbm_log)
    out["hbm"] = hbm_log[-1]
    out["phase_s"] = time.time() - t_phase
    log(f"[deferred] {json.dumps(out)[:2000]}")
    return out


# ---------------------------------------------------------------- phase 15
MESH_KNN_QUERIES = 4
MESH_KNN_K = 1000
MESH_KNN_NC = 3000
MESH_TIMED = 2            # bodies whose mesh launch is profiled
MESH_REPS = 3             # profiled calls a body
# the host calls that wait for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def sync_profiled(fn, reps):
    """``fn()`` (a launch and its readback) under torch.profiler, once
    warm, then ``reps`` times: (the kernels' summed device ms a call,
    kernels a call, host ms a call, host calls that wait for the card a
    call: the slope between a window of ``reps`` calls and one of
    ``2 * reps``, so the profiler's own waits do not count). A launch
    the host cannot queue ahead of the card has no device time of its
    own worth timing by events: the kernels' sums say what the card
    did, the host ms what it took."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])

    def window(call, n):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            host = (time.perf_counter() - t0) * 1e3 / max(1, n)
        events = prof.key_averages()
        return (events, host,
                sum(e.count for e in events if e.key in SYNC_CALLS))

    fn()
    torch.cuda.synchronize()
    events, host, syncs = window(fn, reps)
    _, _, syncs2 = window(fn, 2 * reps)
    kernels = kernel_rows(events)
    return (sum(self_dev(e) for e in kernels) / reps / 1e3,
            sum(e.count for e in kernels) / reps, host,
            (syncs2 - syncs) / reps)


def hits_equal(a, b, what):
    """Two answers bit for bit: ids, order, float32 scores, totals and
    max_score equal."""
    check([(h["_id"], h["_score"]) for h in a["hits"]["hits"]]
          == [(h["_id"], h["_score"]) for h in b["hits"]["hits"]]
          and a["hits"]["total"] == b["hits"]["total"]
          and a["hits"]["max_score"] == b["hits"]["max_score"],
          f"{what}: ids, order, scores, totals and max_score equal")


def knn_views_loop(views, live, hosts, q, nd, k, nc, cut):
    """The per-shard dense kNN loop over row-range views (KnnQuery's
    steps a shard: the slab scores, the top-``nc`` nomination, the host
    exact re-rank patched in, the cut to ``cut`` with its ties, the live
    mask, the shard's top k) and the coordinator's merge by (score,
    shard, docid): ([(score, shard, docid)], total)."""
    import torch

    from elasticsearch_tpu_torch.ops import vector as vec_ops
    from elasticsearch_tpu_torch.ops.topk import stable_topk
    rows, total = [], 0
    for s, (v, sqn, hv) in enumerate(views):
        dev = v.device
        qt = torch.from_numpy(q).to(dev)[None]
        scores = torch.where(hv, vec_ops.similarity_scores(
            qt, v, sqn, "cosine")[0], 0.0)
        ids = torch.arange(nd, dtype=torch.int32, device=dev)
        _, top = stable_topk(scores[None], ids[None], nc)
        cand = top[0].cpu().numpy()
        cand = cand[cand < hosts[s].shape[0]]
        exact = vec_ops.exact_rerank_scores(hosts[s][cand], q, "cosine")
        scores = scores.index_put(
            (torch.from_numpy(cand.astype(np.int64)).to(dev),),
            torch.from_numpy(exact).to(dev))
        kth = torch.kthvalue(torch.where(hv, scores, float("-inf")),
                             nd - cut + 1).values
        mask = hv & (scores >= kth) & live[s]
        total += int(mask.sum())
        vals, top = stable_topk(
            torch.where(mask, scores, float("-inf"))[None], ids[None], k)
        rows += [(x, s, d) for x, d in zip(vals[0].tolist(),
                                           top[0].tolist())
                 if x > float("-inf")]
    rows.sort(key=lambda r: (-r[0], r[1], r[2]))
    return rows[:k], total


def phase_mesh(node, port, corpus, queries, carry, seed, iters, counters,
               hbm_log):
    """The mesh on one H100 (module docstring, phase 15): (a) the node's
    fallback, (b) the mesh programs over a grid of 5 x cuda:0, (c) the
    replica fan-out over 2 x cuda:0."""
    import torch

    from elasticsearch_tpu_torch.corpus import knn_query_vectors, term_name
    from elasticsearch_tpu_torch.ops import plan as plan_ops
    from elasticsearch_tpu_torch.ops import vector as vec_ops
    from elasticsearch_tpu_torch.ops.device import readback
    from elasticsearch_tpu_torch.parallel import mesh_executor as mx
    from elasticsearch_tpu_torch.parallel import sharded
    from elasticsearch_tpu_torch.search import fastpath as srv
    from elasticsearch_tpu_torch.search.batching import PlanBatcher, _Entry
    from elasticsearch_tpu_torch.search.plan import bind_plan, compile_plan
    from elasticsearch_tpu_torch.search.queries import parse_query
    from elasticsearch_tpu_torch.search.service import (SearchService,
                                                        _dfs_searchers)
    from elasticsearch_tpu_torch.telemetry.engine import TRACKER
    t_phase = time.time()
    dev = node.device
    out = {}
    bodies = carry["match"] + carry["filters"]
    answers = carry["match_answers"] + carry["filter_answers"]
    for c in counters.values():
        c.launches = 0
    _, k0 = http(port, "GET", "/_kernels")

    # ---- (a) the node's own mesh: one card, five shards, the loop
    be_node = node.search_service.mesh_executor
    c0 = dict(be_node.counters)
    check(be_node.available_devices() == torch.cuda.device_count(),
          "the node's device list is every visible card")
    res, lat, wall = drive(port, bodies, 16, "bench5")
    c1 = dict(be_node.counters)
    delta = {k: c1.get(k, 0) - c0.get(k, 0) for k in set(c0) | set(c1)}
    check(delta.get("fallback.not_enough_devices") == len(bodies)
          and not any(v for k, v in delta.items()
                      if k.startswith("dispatch."))
          and c1.get("fallback.error", 0) == 0,
          f"phase 15 (a): every bench5 body fell back for want of devices "
          f"({len(bodies)}), none dispatched, no error: {delta}")
    for i, ((st, r), old) in enumerate(zip(res, answers)):
        check(st == 200, f"mesh (a) body {i} -> {st}")
        hits_equal(r, old, f"mesh (a) body {i} against phase 13's answer")
    p50, p99 = p50_p99(lat)
    out["fallback"] = dict(bodies=len(bodies), counters=delta,
                           qps=len(bodies) / wall, p50_ms=p50, p99_ms=p99)
    log(f"[mesh] (a) {out['fallback']}")

    # ---- (b) the programs over a grid of 5 x cuda:0
    grid = SearchService(node.device_cache, node.indices,
                         devices=[dev] * SHARDS)
    be = grid.mesh_executor
    searchers = grid._shard_searchers(node.indices["bench5"])
    t0 = time.time()
    mcorpus = be.corpus_for(searchers)
    torch.cuda.synchronize()
    out["corpus_s"] = time.time() - t0
    check(all(c.device is node.device_cache.resident(c.segment.name)
              for c in mcorpus.contexts) and be.residency() == {},
          "phase 15 (b): the grid's shards read the node's resident "
          "segments, no second copy")
    got = [grid.search("bench5", dict(b)) for b in bodies]
    check(be.mesh_searches == len(bodies)
          and be.counters == {"dispatch.shard": len(bodies)},
          f"phase 15 (b): every body on the 5-device mesh: {be.counters}")
    for i, (r, old) in enumerate(zip(got, answers)):
        hits_equal(r, old, f"mesh (b) body {i} against the per-shard loop")
    # a mesh query through MeshSearchBackend.execute (each shard's
    # compile and bind, the uploads, the launch and its one readback),
    # profiled: the kernels' device ms, the host's ms, and the host calls
    # that wait for the card (the readback's alone: the uploads wait for
    # nothing and no shard waits for another)
    launch_ms, host_ms, kernels, syncs = [], [], [], []
    for body in bodies[:MESH_TIMED]:
        q = parse_query(body["query"])
        ms, n_k, hms, n_sync = sync_profiled(
            lambda: be.execute(searchers, q, SHARD_K), MESH_REPS)
        launch_ms.append(ms)
        host_ms.append(hms)
        kernels.append(n_k)
        syncs.append(n_sync)
    check(max(syncs) <= 1,
          f"phase 15 (b): a mesh query waits for the card once, at its "
          f"readback ({syncs} a query)")
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = [torch.sort(torch.rand(SHARD_K, device=dev, generator=g),
                       descending=True).values for _ in range(SHARDS)]
    gids = [torch.arange(SHARD_K, device=dev, dtype=torch.int64)
            + s * mcorpus.n_docs_padded for s in range(SHARDS)]
    tots = [torch.full((1,), 7, dtype=torch.int32, device=dev)
            for _ in range(SHARDS)]
    merge_ms, _ = cuda_ms(lambda: plan_ops.mesh_merge(
        vals, gids, tots, dev, SHARD_K), iters)
    out["plan_topk_mesh"] = dict(
        bodies=len(bodies), kernel_ms=launch_ms, host_ms=host_ms,
        kernels=kernels, syncs=syncs,
        mean_kernel_ms=float(np.mean(launch_ms)),
        mean_host_ms=float(np.mean(host_ms)),
        gather_merge_ms=merge_ms, shards=SHARDS,
        n_docs_padded=mcorpus.n_docs_padded)
    # the dfs phase's statistics on the mesh (the reference's builder,
    # bench5's title field stacked on the grid) against the pooled ones
    mesh5 = sharded.make_mesh(n_shards=SHARDS, devices=[dev] * SHARDS)
    t0 = time.time()
    sidx, pfs = sharded.build_sharded_index(
        mesh5, [s.segments[0] for s in searchers], "title")
    torch.cuda.synchronize()
    out["sharded_build_s"] = time.time() - t0
    pooled = _dfs_searchers([("bench5", s) for s in searchers])[0][1].stats
    terms_checked = 0
    for qterms in queries[:SHARD_DFS]:
        for t in qterms:
            name = term_name(t)
            per = []
            for pf in pfs:
                tid = pf.term_id(name)
                st_ = int(pf.term_block_start[tid]) if tid >= 0 else 0
                per.append(list(range(st_, st_ + (
                    int(pf.term_block_count[tid]) if tid >= 0 else 0))))
            nb = max(1, max(len(p) for p in per))
            sel = np.array([p + [sidx.zero_blocks[s]] * (nb - len(p))
                            for s, p in enumerate(per)], np.int64)
            df = int(sharded.sharded_dfs_stats(sidx, sel).sum())
            want = pooled.doc_freq("title", name)
            check(df == want == int(corpus["df"][t]),
                  f"phase 15 (b): sharded_dfs_stats of {name} equals the "
                  f"dfs phase's pooled doc freq ({df} vs {want})")
            terms_checked += 1
    out["dfs_terms_checked"] = terms_checked
    # the mesh kNN programs over config 4's slab as five row ranges
    kseg = node.indices["knn"].engine.segments[0]
    t0 = time.time()
    kdev = node.device_cache.get(kseg)
    torch.cuda.synchronize()
    out["knn_slab_get_s"] = time.time() - t0
    dv = kdev.vectors["vec"]
    host = kseg.vectors["vec"].vectors
    rows = kseg.n_docs // SHARDS
    views = [(dv.vectors[s * rows:(s + 1) * rows],
              dv.sq_norms[s * rows:(s + 1) * rows],
              dv.has_value[s * rows:(s + 1) * rows]) for s in range(SHARDS)]
    check(all(v.data_ptr() == dv.vectors.data_ptr() + s * rows
              * dv.vectors.shape[1] * dv.vectors.element_size()
              for s, (v, _, _) in enumerate(views)),
          "the five row ranges are views of the slab")
    live = [kdev.live[s * rows:(s + 1) * rows] for s in range(SHARDS)]
    hosts = [host[s * rows:(s + 1) * rows] for s in range(SHARDS)]
    qs = knn_query_vectors(host, MESH_KNN_QUERIES,
                           np.random.default_rng(seed + 1))
    knn_ms = {"nominate": [], "step": [], "step_host": [],
              "step_syncs": []}
    for i, q in enumerate(qs):
        # the query on the card first: a host copy inside a timed call
        # would wait for the stream
        qt = torch.from_numpy(q).to(dev)
        nominate = lambda: mx._mesh_knn_nominate(   # noqa: E731
            [v for v, _, _ in views], [s for _, s, _ in views],
            [h for _, _, h in views], qt, dev, "cosine", MESH_KNN_NC)
        ids = nominate().cpu().numpy()
        patches = []
        for s in range(SHARDS):
            cand = ids[s][ids[s] < rows]
            exact = vec_ops.exact_rerank_scores(hosts[s][cand], q,
                                                "cosine")
            patches.append((torch.from_numpy(cand.astype(np.int64)).to(dev),
                            torch.from_numpy(exact).to(dev)))
        step = lambda: mx._mesh_knn_step(   # noqa: E731
            [v for v, _, _ in views], [s for _, s, _ in views],
            [h for _, _, h in views], live, qt, patches, dev, rows,
            "cosine", 1.0, MESH_KNN_K, MESH_KNN_K)
        packed = step().cpu().numpy()
        want, total = knn_views_loop(views, live, hosts, q, rows,
                                     MESH_KNN_K, MESH_KNN_NC, MESH_KNN_K)
        k = MESH_KNN_K
        gids = packed[k:2 * k].astype(np.int64)
        check(int(packed[2 * k]) == total
              and [(int(x) // rows, int(x) % rows) for x in gids]
              == [(s, d) for _, s, d in want]
              and np.allclose(packed[:k], [x for x, _, _ in want],
                              rtol=1e-6, atol=0),
              f"phase 15 (b): mesh kNN query {i} equals the per-shard "
              f"loop over the views (ids, order, total {total})")
        if i < 2:
            knn_ms["nominate"].append(cuda_ms(nominate, 3, 1)[0])
            ms, _, hms, n_sync = sync_profiled(
                lambda: readback("chip_smoke.mesh_knn", step()), 2)
            knn_ms["step"].append(ms)
            knn_ms["step_host"].append(hms)
            knn_ms["step_syncs"].append(n_sync)
    out["knn"] = dict(queries=len(qs), rows_a_shard=rows, k=MESH_KNN_K,
                      num_candidates=MESH_KNN_NC, device_ms=knn_ms)
    log(f"[mesh] (b) {out['plan_topk_mesh']}, knn {out['knn']}")

    # ---- (c) the replica fan-out over 2 x cuda:0
    be2 = mx.MeshSearchBackend([dev] * 2)
    bseg = node.indices["bench"].engine.segments[0]
    fp = srv.FastPathServer(dev, node.device_cache, mesh_backend=be2)
    bsvc = node.indices["bench"]
    reg = fp.register("bench", bseg, "title", bsvc.k1, bsvc.b)
    check(reg["rmesh"] is not None and reg["rmesh"].devices.size == 2,
          "phase 15 (c): the v1 registration binds a 2-device replica mesh")
    pf = reg["dp"].host
    fits = []
    for qterms in queries:
        tids = [pf.term_id(term_name(t)) for t in qterms]
        if fp.route(reg, tids) is not None:
            fits.append((qterms, tids))
        if len(fits) == srv.Q_BATCH:
            break
    bsearcher = node.search_service._shard_searchers(node.indices["bench"])[0]
    ctx = bsearcher._contexts()[0]
    bps = [bind_plan(compile_plan(parse_query(plan_body(qt, SHARD_K)["query"])
                                  .rewrite(bsearcher), bsearcher), ctx,
                     SHARD_K) for qt, _ in fits]
    whole = PlanBatcher()
    e1 = [_Entry(bp) for bp in bps]
    t0 = time.perf_counter()
    whole._run(e1, ctx, SHARD_K, bsearcher.k1, bsearcher.b)
    whole_s = time.perf_counter() - t0
    split = PlanBatcher()
    split.mesh = be2
    e2 = [_Entry(bp) for bp in bps]
    t0 = time.perf_counter()
    split._run(e2, ctx, SHARD_K, bsearcher.k1, bsearcher.b)
    split_s = time.perf_counter() - t0
    check(split.mesh_cohorts == 1 and whole.mesh_cohorts == 0
          and all(a.result[0].tobytes() == c.result[0].tobytes()
                  and a.result[1].tobytes() == c.result[1].tobytes()
                  and a.result[2] == c.result[2] for a, c in zip(e1, e2)),
          f"phase 15 (c): the PlanBatcher cohort of {len(bps)} split over "
          f"2 devices equals the unsplit launch byte for byte")

    def v1_cohort(rmesh):
        reg["rmesh"] = rmesh
        items = [srv._Pending(reg, tids, (), SHARD_K, "v1",
                              srv.NB_BUCKETS[-1]) for _, tids in fits]
        n0 = counters["gather_bm25_contrib"].launches
        c0_ = TRACKER.calls("gather_bm25_contrib")
        t1 = time.perf_counter()
        fp._launch_cohort("v1", reg, srv.NB_BUCKETS[-1], items, {})
        torch.cuda.synchronize()
        return ([p.result for p in items], time.perf_counter() - t1,
                counters["gather_bm25_contrib"].launches - n0,
                TRACKER.calls("gather_bm25_contrib") - c0_)

    rmesh = be2.replica_mesh_for(srv.Q_BATCH)
    v_whole, vw_s, n_whole, c_whole = v1_cohort(None)
    v_split, vs_s, n_split, c_split = v1_cohort(rmesh)
    check((n_whole, n_split) == (1, 2) and (c_whole, c_split) == (1, 2)
          and fp.stats["mesh_cohorts"] == 1
          and be2.counters == {"dispatch.replica": 2 * len(fits)}
          and all(a[0].tobytes() == c[0].tobytes()
                  and a[1].tobytes() == c[1].tobytes() and a[2] == c[2]
                  for a, c in zip(v_whole, v_split)),
          f"phase 15 (c): the v1 cohort of {len(fits)} split over 2 devices "
          f"equals the unsplit launch byte for byte and launches the "
          f"contribution kernel once a replica device ({n_whole}, "
          f"{n_split}; tracker {c_whole}, {c_split})")
    out["replica"] = dict(
        plan_cohort=len(bps), plan_whole_s=whole_s, plan_split_s=split_s,
        v1_cohort=len(fits), v1_whole_s=vw_s, v1_split_s=vs_s,
        v1_contrib_launches=dict(whole=n_whole, split=n_split),
        replica_corpus_bytes=be2.stats()["replica_corpus_bytes"])

    # ---- (d) the phase's launches, /_kernels, fallback.error
    launches = {name: c.launches for name, c in counters.items()}
    _, k1_ = http(port, "GET", "/_kernels")
    calls = {name: k1_["kernels"].get(name, {}).get("calls", 0)
             - k0["kernels"].get(name, {}).get("calls", 0)
             for name in counters}
    check(calls == launches and launches["gather_bm25_contrib"] == 3
          and launches["merge_sorted_slots"] == 0,
          f"phase 15: the contribution kernel launched 3 times (1 + 2), the "
          f"merge not at all, and /_kernels agrees: {launches} vs {calls}")
    check(k1_["mesh"]["counters"].get("fallback.error", 0) == 0,
          f"phase 15: no mesh error in the run: {k1_['mesh']['counters']}")
    out["launches"] = launches
    out["node_mesh"] = k1_["mesh"]
    # drop the second copies and the registration: the accounting of the
    # node's own resident segments stands
    fp.retire([bseg.name])
    be.clear()
    be2.clear()
    del mcorpus, sidx, views, live, e1, e2, bps, reg
    hbm_agrees(node, "mesh", hbm_log)
    out["hbm"] = hbm_log[-1]
    out["phase_s"] = time.time() - t_phase
    log(f"[mesh] {json.dumps(out)[:2000]}")
    return out


# ---------------------------------------------------------------- phase 16
DUR_DOCS = 25_000         # phase 16 (a): the docs written through _bulk
DUR_BULK = 5_000          # Rally's default bulk_size
DUR_OPS = 1_250           # single-doc requests after the bulk
DUR_TRANSLOG_OPS = 2_500  # (b): the ops only the translog holds
DUR_QUERIES = 8
DUR_K = 100
DUR_BENCH_BODIES = 64     # (c): phase 4's first match bodies
DUR_CLIENTS = 8


class CopyOracle:
    """float64 BM25 over the copies a shard's segments hold (each
    document version written, live or deleted): the statistics count
    every copy, as the shard's do until a merge drops the deleted ones;
    only the live copies score."""

    def __init__(self, copies, k1=1.2, b=0.75):
        ids = [i for i, _t, _live in copies]
        toks = [t for _i, t, _live in copies]
        self.ids = np.asarray([int(i) for i in ids], np.int64)
        self.live = np.asarray([live for _i, _t, live in copies], bool)
        lens = np.asarray([len(t) for t in toks], np.int64)
        copy_of = np.repeat(np.arange(len(toks), dtype=np.int64), lens)
        flat = np.concatenate(toks).astype(np.int64)
        keys = flat * len(toks) + copy_of
        uniq, tf = np.unique(keys, return_counts=True)
        self.term_of = uniq // len(toks)
        self.copy_of = uniq % len(toks)
        self.tf = tf.astype(np.float64)
        self.starts = np.searchsorted(self.term_of,
                                      np.arange(int(flat.max()) + 2))
        self.lens = lens.astype(np.float64)
        self.avg = float(lens.sum()) / len(lens)
        self.n, self.k1, self.b = len(lens), k1, b

    def scores(self, terms):
        out = np.zeros(self.n, np.float64)
        for t in terms:
            lo, hi = self.starts[t], self.starts[t + 1]
            c, f = self.copy_of[lo:hi], self.tf[lo:hi]
            df = hi - lo
            w = np.log(1.0 + (self.n - df + 0.5) / (df + 0.5))
            norm = self.k1 * (1.0 - self.b + self.b * self.lens[c] / self.avg)
            out[c] += w * f / (f + norm)
        return np.where(self.live, out, 0.0)

    def topk(self, terms, k):
        """(ids of the top k live copies, their scores, the live
        matches, {id: score} of every live match)."""
        s = self.scores(terms)
        matched = np.nonzero(s > 0)[0]
        order = matched[np.lexsort((self.ids[matched], -s[matched]))][:k]
        return (self.ids[order], s[order], len(matched),
                dict(zip(self.ids[matched].tolist(), s[matched].tolist())))


def check_scored(r, oracle, terms, k, what):
    """The page against the oracle: the total exact, each served score
    within rtol 1e-5 of its doc's float64 score, every oracle doc above
    the kth score's ties served (check_answer's plan rule)."""
    truth, scores, total, by_id = oracle.topk(terms, k)
    check_answer(r, (truth, scores, total), "plan", what)
    for h in r["hits"]["hits"]:
        want = by_id.get(int(h["_id"]))
        check(want is not None and abs(h["_score"] - want) <= 1e-5 * want,
              f"{what}: doc {h['_id']} scored {h['_score']} vs {want}")


def ask_many(port, requests, clients):
    """(status, body) of each (method, path, body) request, sent by
    ``clients`` threads over one kept-alive connection each; answers in
    request order."""
    import http.client
    from concurrent.futures import ThreadPoolExecutor
    local = threading.local()
    conns = []

    def one(q):
        method, path, body = q
        conn = getattr(local, "conn", None)
        if conn is None:
            conn = local.conn = http.client.HTTPConnection(
                "127.0.0.1", port, timeout=300)
            conns.append(conn)
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers=(
            {"Content-Type": "application/json"} if data else {}))
        r = conn.getresponse()
        return r.status, json.loads(r.read())

    try:
        with ThreadPoolExecutor(clients) as pool:
            return list(pool.map(one, requests))
    finally:
        for conn in conns:
            conn.close()


def launches_since(counters, before):
    return {n: c.launches - before[n] for n, c in counters.items()}


def tracker_calls(names):
    """The launch tracker's calls of each kernel (``GET /_kernels``)."""
    from elasticsearch_tpu_torch.telemetry.engine import TRACKER
    table = TRACKER.to_dict()
    return {n: table.get(n, {}).get("calls", 0) for n in names}


def tree_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def same_pages(a, b, what):
    """Two answers bit-equal: totals, ids, order and float32 scores (the
    C++ front prints a float32 score's shortest text, the fallback its
    float64 value: both parse to the same float32)."""
    def page(r):
        return [(h["_id"], np.float32(h["_score"]).tobytes())
                for h in r["hits"]["hits"]]
    check(a["hits"]["total"] == b["hits"]["total"] and page(a) == page(b),
          f"{what}: the same answer ({str(a)[:300]} vs {str(b)[:300]})")


def phase_durability(corpus_seg, queries, seed, counters, hbm_log):
    """Documents, versions and the translog on one H100 (module
    docstring, phase 16), on a node of its own on a temporary data
    path."""
    import shutil
    import tempfile

    import torch

    from elasticsearch_tpu_torch.corpus import build_corpus, term_name
    from elasticsearch_tpu_torch.node import Node
    t_phase = time.time()
    out = {}
    steps = {}
    t_step = [time.time()]

    def lap(name):
        """The seconds since the last lap, as ``steps_s[name]``."""
        now = time.time()
        steps[name] = now - t_step[0]
        t_step[0] = now
    path = tempfile.mkdtemp(prefix="estpu-durability-")
    settings = {"indices.breaker.hbm.limit":
                int(0.5 * torch.cuda.mem_get_info()[1])}
    rng = np.random.default_rng(seed)
    for c in counters.values():
        c.launches = 0
    calls0 = tracker_calls(counters)

    def open_node(upload=None):
        """(node, port, seconds to open it, seconds to upload index
        ``upload``'s segment to the card): opening recovers every index
        under the path; the upload is timed before ``start``, whose
        front registration would make it."""
        t0 = time.time()
        n = Node(device="cuda", settings=settings, data_path=path)
        opened = time.time() - t0
        upload_s = None
        if upload is not None:
            torch.cuda.synchronize()
            t0 = time.time()
            n.device_cache.get(n.indices[upload].engine.segments[0])
            torch.cuda.synchronize()
            upload_s = time.time() - t0
        return n, n.start(0), opened, upload_s

    # the documents: corpus.py's text (seed 0), a keyword, a long
    dc = build_corpus(np.random.default_rng(0), n_docs=DUR_DOCS)
    ends = np.cumsum(dc["lens"].astype(np.int64))
    toks = np.split(dc["stream"], ends[:-1])

    names = [term_name(t) for t in range(int(dc["stream"].max()) + 1)]

    def text(t):
        return " ".join([names[x] for x in t.tolist()])

    tags = ["alpha", "beta", "gamma"]
    docs = {str(i): {"body": text(toks[i]), "tag": tags[i % 3], "n": i}
            for i in range(DUR_DOCS)}
    tok_of = {str(i): toks[i] for i in range(DUR_DOCS)}
    node, port, _, _ = open_node()
    lap("a_setup")
    try:
        # ---- (a) "docs": _bulk at Rally's bulk_size, then single ops
        before = {n: c.launches for n, c in counters.items()}
        st, _ = http(port, "PUT", "/docs", {"mappings": {"properties": {
            "body": {"type": "text"}, "tag": {"type": "keyword"},
            "n": {"type": "long"}}}})
        check(st == 200, "phase 16: PUT /docs")
        acks = {}
        ids = list(docs)
        t0 = time.time()
        for lo in range(0, DUR_DOCS, DUR_BULK):
            lines = "".join(
                json.dumps({"index": {"_id": i}}) + "\n"
                + json.dumps(docs[i]) + "\n" for i in ids[lo:lo + DUR_BULK])
            st, r = http(port, "POST", "/docs/_bulk", lines, ndjson=True)
            check(st == 200 and not r["errors"],
                  f"phase 16 (a): bulk at {lo}: {str(r)[:300]}")
            for it in r["items"]:
                it = it["index"]
                acks[it["_id"]] = (it["_version"], it["_seq_no"])
        bulk_s = time.time() - t0
        t0 = time.time()
        st, _ = http(port, "POST", "/docs/_refresh")
        refresh_s = time.time() - t0
        check(st == 200, "phase 16 (a): _refresh")
        qrng = np.random.default_rng(seed + 1)
        qterms = [sorted(set(int(t) for t in qrng.integers(
            5, 3000, int(qrng.integers(1, 4))))) for _ in range(DUR_QUERIES)]
        dense = [{"query": {"match": {"body": " ".join(
            term_name(t) for t in q)}}, "min_score": 1e-12, "size": DUR_K}
            for q in qterms]
        plan = [{"query": {"match": {"body": {"query": " ".join(
            term_name(t) for t in q), "boost": 1.0}}}, "size": DUR_K}
            for q in qterms]
        first = ask_many(port, [("POST", "/docs/_search", b)
                                for b in dense + plan], DUR_CLIENTS)
        lap("a_bulk_refresh_search")
        copies = [(i, tok_of[i], True) for i in ids]
        oracle = CopyOracle(copies)
        lap("a_oracle")
        for j, (st, r) in enumerate(first):
            check(st == 200, f"phase 16 (a): search {j}: {str(r)[:200]}")
            check_scored(r, oracle, qterms[j % DUR_QUERIES], DUR_K,
                         f"phase 16 (a) after the bulk, body {j}")
        # DUR_OPS single-doc requests through the REST routes, 8 clients,
        # one request an id: updates by doc (half with a new body),
        # scripted updates, deletes, new docs; then, one at a time, a
        # _create conflict, a CAS that succeeds and one that conflicts,
        # and a search before _refresh
        perm = rng.permutation(DUR_DOCS)
        n_doc, n_script, n_del = (2 * DUR_OPS // 5, DUR_OPS // 5,
                                  DUR_OPS // 5)
        n_new = DUR_OPS - n_doc - n_script - n_del - 4
        reqs, kinds = [], []
        for j, d in enumerate(perm[:n_doc]):
            i = str(int(d))
            upd = {"tag": tags[(int(d) + 1) % 3]}
            if j % 2:
                src = str(int(perm[-1 - j]))
                upd["body"] = docs[src]["body"]
                tok_of[i] = tok_of[src]
            docs[i] = dict(docs[i], **upd)
            reqs.append(("POST", f"/docs/_update/{i}", {"doc": upd}))
            kinds.append(("update", i))
        for d in perm[n_doc:n_doc + n_script]:
            i = str(int(d))
            docs[i] = dict(docs[i], n=docs[i]["n"] + 7)
            reqs.append(("POST", f"/docs/_update/{i}", {"script": {
                "source": "ctx._source.n += params.d",
                "params": {"d": 7}}}))
            kinds.append(("update", i))
        for d in perm[n_doc + n_script:n_doc + n_script + n_del]:
            i = str(int(d))
            reqs.append(("DELETE", f"/docs/_doc/{i}", None))
            kinds.append(("delete", i))
        for j in range(n_new):
            i = str(DUR_DOCS + j)
            src = str(int(perm[j]))
            docs[i] = {"body": docs[src]["body"], "tag": "new",
                       "n": DUR_DOCS + j}
            tok_of[i] = tok_of[src]
            reqs.append(("PUT", f"/docs/_doc/{i}", docs[i]))
            kinds.append(("create", i))
        lap("a_checks_and_requests_built")
        t0 = time.time()
        answers = ask_many(port, reqs, DUR_CLIENTS)
        ops_s = time.time() - t0
        deleted = set()
        for (kind, i), (st, r) in zip(kinds, answers):
            want = {"update": (200, "updated"), "delete": (200, "deleted"),
                    "create": (201, "created")}[kind]
            check((st, r.get("result")) == want,
                  f"phase 16 (a): {kind} {i}: {st} {str(r)[:200]}")
            acks[i] = (r["_version"], r["_seq_no"])
            if kind == "delete":
                deleted.add(i)
                docs.pop(i)
        live_id = str(int(perm[-1]))
        st, r = http(port, "PUT", f"/docs/_create/{live_id}", {"n": 0})
        check(st == 409 and r["error"]["type"]
              == "version_conflict_engine_exception",
              f"phase 16 (a): _create on a live id is a 409: {st} {r}")
        st, g = http(port, "GET", f"/docs/_doc/{live_id}")
        check(st == 200 and g["_seq_no"] == acks[live_id][1],
              f"phase 16 (a): GET {live_id} answers its seq_no: {g}")
        cas = dict(docs[live_id], n=-1)
        q = f"if_seq_no={g['_seq_no']}&if_primary_term={g['_primary_term']}"
        st, r = http(port, "PUT", f"/docs/_doc/{live_id}?{q}", cas)
        check(st == 200 and r["_version"] == g["_version"] + 1,
              f"phase 16 (a): the CAS at the current seq_no succeeds: {r}")
        docs[live_id] = cas
        acks[live_id] = (r["_version"], r["_seq_no"])
        st, r = http(port, "PUT", f"/docs/_doc/{live_id}?{q}", cas)
        check(st == 409, f"phase 16 (a): the stale CAS is a 409: {st} {r}")
        # the NRT rule: before _refresh every search answers as before
        # the 5,000 requests (old copies kept, new ones unseen)
        nrt = ask_many(port, [("POST", "/docs/_search", b)
                              for b in dense + plan], DUR_CLIENTS)
        for j, ((_, a), (_, b)) in enumerate(zip(first, nrt)):
            same_pages(a, b, f"phase 16 (a): NRT, body {j} before _refresh")
        lap("a_single_ops_and_nrt")
        st, _ = http(port, "POST", "/docs/_refresh")
        check(st == 200, "phase 16 (a): the second _refresh")
        lap("a_second_refresh")
        # the segments: the bulk's copies (the updated and deleted ones
        # dead) and the new copies
        touched = {i for _k, i in kinds} | {live_id}
        copies = [(i, toks[int(i)], i not in touched) for i in ids]
        copies += [(i, tok_of[i], True) for _k, i in kinds
                   if i not in deleted and i != live_id]
        copies.append((live_id, tok_of[live_id], True))
        oracle = CopyOracle(copies)
        c_dense = {n: c.launches for n, c in counters.items()}
        second = ask_many(port, [("POST", "/docs/_search", b)
                                 for b in dense + plan], DUR_CLIENTS)
        dense_launches = launches_since(counters, c_dense)
        for j, (st, r) in enumerate(second):
            check(st == 200, f"phase 16 (a): search {j}: {str(r)[:200]}")
            check_scored(r, oracle, qterms[j % DUR_QUERIES], DUR_K,
                         f"phase 16 (a) after the ops, body {j}")
        check(dense_launches["gather_bm25_contrib"] >= len(dense),
              f"phase 16 (a): the dense bodies launched the contribution "
              f"kernel: {dense_launches}")
        # _forcemerge: one segment of the live docs, served by v2m
        lap("a_oracle_and_checks_after_refresh")
        st, _ = http(port, "POST", "/docs/_forcemerge")
        check(st == 200, "phase 16 (a): _forcemerge")
        lap("a_forcemerge")
        oracle = CopyOracle([(i, tok_of[i], True) for i in sorted(
            docs, key=int)])
        fast = [{"query": {"match": {"body": " ".join(
            term_name(t) for t in q)}}, "size": DUR_K, "_source": False}
            for q in qterms]
        fp = node.fastpath
        d0 = dict(fp.serving_stats()["dispatch"])
        c_fast = {n: c.launches for n, c in counters.items()}
        third = ask_many(port, [("POST", "/docs/_search", b) for b in fast],
                         DUR_CLIENTS)
        fast_launches = launches_since(counters, c_fast)
        d1 = fp.serving_stats()["dispatch"]
        v2m = sum(v - d0.get(k, 0) for k, v in d1.items()
                  if k.startswith("v2m"))
        for j, (st, r) in enumerate(third):
            check(st == 200, f"phase 16 (a): fast body {j}: {str(r)[:200]}")
            check_scored(r, oracle, qterms[j], DUR_K,
                         f"phase 16 (a) after _forcemerge, body {j}")
        check(v2m == len(fast) and fast_launches["merge_sorted_slots"] > 0
              and fast_launches["gather_bm25_contrib"] > 0,
              f"phase 16 (a): every merged-index body on v2m ({v2m}), "
              f"both kernels launched: {fast_launches}")

        def read_back(port, what):
            """Every acknowledged write through _mget: a live doc's
            source, _version and _seq_no as acknowledged; a deleted one
            not found."""
            every = sorted(acks, key=int)
            for lo in range(0, len(every), 10_000):
                chunk = every[lo:lo + 10_000]
                st, r = http(port, "POST", "/docs/_mget", {"ids": chunk})
                check(st == 200, f"{what}: _mget at {lo}")
                for i, d in zip(chunk, r["docs"]):
                    if i in docs:
                        check(d["found"] and (d["_version"], d["_seq_no"])
                              == acks[i] and d["_source"] == docs[i],
                              f"{what}: doc {i}: {str(d)[:200]} vs "
                              f"{acks[i]}")
                    else:
                        check(not d["found"], f"{what}: doc {i} deleted")
            return len(every)

        lap("a_fast_checks")
        out["docs"] = dict(
            docs=DUR_DOCS, bulk_requests=DUR_DOCS // DUR_BULK,
            bulk_s=bulk_s, bulk_docs_per_s=DUR_DOCS / bulk_s,
            refresh_s=refresh_s, single_requests=DUR_OPS,
            single_s=ops_s, single_per_s=len(reqs) / ops_s,
            read_back=read_back(port, "phase 16 (a)"),
            launches=launches_since(counters, before),
            launches_dense=dense_launches, launches_fast=fast_launches)
        lap("a_read_back")
        log(f"[durability] (a) {out['docs']}")

        # ---- (b) restart from the translog
        before = {n: c.launches for n, c in counters.items()}
        st, _ = http(port, "POST", "/docs/_flush")
        check(st == 200, "phase 16 (b): _flush")
        # every fifth op a delete, the others updates by doc
        ops = []
        tl_ids = [str(i) for i in rng.permutation(
            sorted(docs, key=int))[:DUR_TRANSLOG_OPS]]
        for j, i in enumerate(tl_ids):
            if j % 5 == 4:
                ops.append(json.dumps({"delete": {"_id": i}}) + "\n")
            else:
                upd = {"n": docs[i]["n"] + 1, "tag": "tl"}
                ops.append(json.dumps({"update": {"_id": i}}) + "\n"
                           + json.dumps({"doc": upd}) + "\n")
                docs[i] = dict(docs[i], **upd)
        t0 = time.time()
        for lo in range(0, len(ops), DUR_BULK):
            st, r = http(port, "POST", "/docs/_bulk",
                         "".join(ops[lo:lo + DUR_BULK]), ndjson=True)
            check(st == 200 and not r["errors"],
                  f"phase 16 (b): bulk at {lo}: {str(r)[:300]}")
            for it in r["items"]:
                (op, it), = it.items()
                if op == "delete":
                    check(it["result"] == "deleted", f"(b) delete {it}")
                    docs.pop(it["_id"])
                else:
                    acks[it["_id"]] = (it["_version"], it["_seq_no"])
        tl_s = time.time() - t0
        st, _ = http(port, "POST", "/docs/_refresh")
        pre = ask_many(port, [("POST", "/docs/_search", b)
                              for b in dense + plan + fast], DUR_CLIENTS)
        lap("b_flush_ops_refresh_search")
        node.close()
        node, port, opened, _ = open_node()
        lap("b_close_open")
        rec = node.indices["docs"].stats()["recovery"][0]
        check(rec["replay_ops"] == DUR_TRANSLOG_OPS,
              f"phase 16 (b): the translog replayed {rec['replay_ops']} "
              f"ops ({DUR_TRANSLOG_OPS} sent after the flush)")
        read_back(port, "phase 16 (b) after the restart")
        st, _ = http(port, "POST", "/docs/_refresh")
        post = ask_many(port, [("POST", "/docs/_search", b)
                               for b in dense + plan + fast], DUR_CLIENTS)
        for j, ((_, a), (_, b)) in enumerate(zip(pre, post)):
            same_pages(a, b, f"phase 16 (b): body {j} across the restart")
        # committed, so (c)'s restart replays nothing of docs
        st, _ = http(port, "POST", "/docs/_flush")
        check(st == 200, "phase 16 (b): _flush after the restart")
        out["restart"] = dict(
            translog_ops=DUR_TRANSLOG_OPS, translog_bulk_s=tl_s,
            open_s=opened, recovery=rec,
            replay_ops_per_s=rec["replay_ops"] / max(rec["replay_s"], 1e-9),
            bytes_on_disk=tree_bytes(path),
            launches=launches_since(counters, before))
        lap("b_read_back_refresh_search")
        log(f"[durability] (b) {out['restart']}")

        # ---- (c) "bench": the 2M-doc corpus flushed and restarted
        before = {n: c.launches for n, c in counters.items()}
        node.create_index("bench", {"properties": {"title":
                                                   {"type": "text"}}})
        node.indices["bench"].engine.install_segments([corpus_seg])
        bodies = [match_body(q, 1000) for q in queries[:DUR_BENCH_BODIES]]

        def ask_front(port, what):
            """The bodies through the C++ front, which serves bench (the
            largest index of one segment: docs holds two)."""
            node.refresh_front()
            f0 = node.http_stats()["fast"]
            res = ask_many(port, [("POST", "/bench/_search", b)
                                  for b in bodies], DUR_CLIENTS)
            check(node.http_stats()["fast"] - f0 == len(bodies),
                  f"{what}: the front served every bench body")
            for j, (st, r) in enumerate(res):
                check(st == 200, f"{what}: body {j}: {str(r)[:200]}")
            return res

        lap("c_install")
        pre = ask_front(port, "phase 16 (c) before the restart")
        lap("c_bodies")
        t0 = time.time()
        st, _ = http(port, "POST", "/bench/_flush")
        flush_s = time.time() - t0
        check(st == 200, "phase 16 (c): _flush")
        bench_bytes = tree_bytes(node.indices["bench"].path)
        lap("c_flush")
        node.close()
        node, port, opened, upload_s = open_node(upload="bench")
        lap("c_close_open")
        rec = node.indices["bench"].stats()["recovery"][0]
        seg = node.indices["bench"].engine.segments[0]
        post = ask_front(port, "phase 16 (c) after the restart")
        for j, ((_, a), (_, b)) in enumerate(zip(pre, post)):
            same_pages(a, b, f"phase 16 (c): bench body {j} across the "
                       f"restart")
        out["bench"] = dict(
            docs=seg.n_docs, bodies=len(bodies), flush_s=flush_s,
            bytes_on_disk=bench_bytes, open_s=opened,
            segment_load_s=rec["segment_load_s"],
            version_map_s=rec["version_map_s"], upload_s=upload_s,
            recover_s=(rec["segment_load_s"] + rec["version_map_s"]
                       + upload_s),
            launches=launches_since(counters, before))
        lap("c_upload_bodies")
        log(f"[durability] (c) {out['bench']}")
        hbm_agrees(node, "durability", hbm_log)
    finally:
        node.close()
        shutil.rmtree(path, ignore_errors=True)
    launches = {n: c.launches for n, c in counters.items()}
    calls = {n: v - calls0[n] for n, v in tracker_calls(counters).items()}
    check(all(v > 0 for v in launches.values()) and calls == launches,
          f"phase 16: both kernels launched, the tracker agreeing: "
          f"{launches} vs {calls}")
    lap("close")
    out["launches"] = launches
    out["steps_s"] = steps
    out["phase_s"] = time.time() - t_phase
    log(f"[durability] {json.dumps(out)[:2000]}")
    return out


# ---------------------------------------------------------------------------
# phase 17: index metadata and the search contexts
# ---------------------------------------------------------------------------

CTX_PAGE = 1000       # a scroll page of phase 17
CTX_PAGES = 10        # its pages a body
CTX_SLICES = 4        # the sliced scroll's max
PIT_DOCS = 100_000    # the PIT index of phase 17
DS_DOCS = 10_000      # a data stream's docs a generation
RESIZE_DOCS = 25_000  # the resize source


def ctx_terms(corpus, queries, n=4):
    """``n`` terms of the bench's queries (else of its vocabulary) with
    the most docs at most ``CTX_PAGE * CTX_PAGES``: a single-term match
    of each scrolls in at most 10 pages."""
    df = corpus["df"]
    cap = CTX_PAGE * CTX_PAGES
    seen = sorted({int(t) for q in queries for t in q if df[t] <= cap},
                  key=lambda t: (-int(df[t]), t))
    rest = [int(t) for t in np.argsort(-np.where(df <= cap, df, 0),
                                       kind="stable")[:4 * n]
            if t not in seen]
    return (seen + rest)[:n]


def scroll_all(port, path, body, keep="1m"):
    """Every page of a scroll of ``body`` on ``path`` (the first page,
    then ``_search/scroll`` until an empty page): (pages, scroll id)."""
    st, r = http(port, "POST", f"{path}?scroll={keep}", body)
    check(st == 200 and "_scroll_id" in r, f"scroll {path}: {str(r)[:300]}")
    pages = [r]
    while pages[-1]["hits"]["hits"]:
        st, r = http(port, "POST", "/_search/scroll",
                     {"scroll_id": pages[0]["_scroll_id"], "scroll": keep})
        check(st == 200 and r["_shards"]["failed"] == 0,
              f"scroll page of {path}: {str(r)[:300]}")
        pages.append(r)
    return pages, pages[0]["_scroll_id"]


def same_answer(a, b, what, front=False):
    """Two answers of one body: totals, ids and order equal, scores
    equal; with ``front`` (one side answered by the C++ front, which
    prints a score as ``%.6g``) equal in that print."""
    check(a["hits"].get("total") == b["hits"].get("total"),
          f"{what}: totals {a['hits'].get('total')} vs "
          f"{b['hits'].get('total')}")
    check([h["_id"] for h in a["hits"]["hits"]]
          == [h["_id"] for h in b["hits"]["hits"]], f"{what}: ids")
    sa = [h["_score"] for h in a["hits"]["hits"]]
    sb = [h["_score"] for h in b["hits"]["hits"]]
    if front:
        sa = ["%.6g" % x for x in sa]
        sb = ["%.6g" % x for x in sb]
    check(sa == sb, f"{what}: scores")


def phase_contexts(node, port, corpus, queries, oracles, logs, cols,
                   kw_seed, seed, counters, hbm_log):
    """Index metadata and the search contexts on one H100 (module
    docstring, phase 17)."""
    import math

    import torch

    from elasticsearch_tpu_torch.corpus import (LOGS_T0_MS, bench_cat,
                                                build_corpus, dense_scores,
                                                exact_topk, make_queries,
                                                segment_from_corpus,
                                                term_name)
    from elasticsearch_tpu_torch.index.mapper import murmur3_hash
    from elasticsearch_tpu_torch.search.queries import slice_column
    t_phase = time.time()
    out = {}
    steps = {}
    t_step = [time.time()]

    def lap(name):
        now = time.time()
        steps[name] = now - t_step[0]
        t_step[0] = now
    import gc

    from elasticsearch_tpu_torch.search.service import SearchService
    # the earlier phases leave tens of millions of the harness's objects
    # (corpora, oracles, bodies) on the heap: frozen out of the
    # collector's scans, so the collections this phase's bulk bodies
    # trigger walk what the server allocates (on an H100 host, phase 17
    # alone took 39.2 s; after phases 2-15 unfrozen, 57.7 s, its write
    # steps 2-3x slower)
    gc.freeze()
    gc_s = [0.0, 0]

    def gc_timer(phase, info, t=[0.0]):
        if phase == "start":
            t[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - t[0]
            gc_s[1] += 1
    gc.callbacks.append(gc_timer)
    rng = np.random.default_rng(seed)
    svc = node.search_service
    svc.REQUEST_CACHE_MAX_ENTRIES = SearchService.REQUEST_CACHE_MAX_ENTRIES
    contrib = counters["gather_bm25_contrib"]
    for c in counters.values():
        c.launches = 0
    bench_seg = node.indices["bench"].engine.segments
    check(len(bench_seg) == 1, "bench holds one segment")
    bench_seg = bench_seg[0]

    # ---- (a) scroll: four single-term BM25 bodies, pages of 1000
    terms = ctx_terms(corpus, queries)
    bodies = [{"query": {"match": {"title": term_name(t)}},
               "size": CTX_PAGE, "_source": False} for t in terms]
    scroll = []
    unsliced = None
    for t, body in zip(terms, bodies):
        total = exact_topk(corpus, [t], 1)[2]
        l0 = contrib.launches
        t0 = time.perf_counter()
        pages, sid = scroll_all(port, "/bench/_search", body)
        wall = time.perf_counter() - t0
        page_launches = contrib.launches - l0
        n_pages = math.ceil(total / CTX_PAGE)
        check(len(pages) == n_pages + 1 and not pages[-1]["hits"]["hits"],
              f"(a) {term_name(t)}: {len(pages)} pages for {total} hits")
        for p in pages:
            check(p["hits"]["total"] == {"value": total, "relation": "eq"},
                  f"(a) {term_name(t)}: every page's total is the float64 "
                  f"oracle's {total}: {p['hits']['total']}")
        hits = [h for p in pages for h in p["hits"]["hits"]]
        ids = [h["_id"] for h in hits]
        check(len(ids) == len(set(ids)) == total,
              f"(a) {term_name(t)}: the pages are disjoint and hold every "
              f"match")
        check(page_launches == len(pages),
              f"(a) {term_name(t)}: one contribution launch a page of the "
              f"one segment: {page_launches} for {len(pages)} pages")
        # one dense-executor page of every match (min_score keeps the
        # plan path away): bit-equal ids, order and float32 scores
        st, whole = http(port, "POST", "/bench/_search",
                         dict(body, size=CTX_PAGE * CTX_PAGES,
                              min_score=0.0))
        check(st == 200, f"(a) the dense page: {str(whole)[:200]}")
        same_answer({"hits": {"total": whole["hits"]["total"],
                              "hits": hits}}, whole,
                    f"(a) {term_name(t)}: the pages against one dense page")
        st, r = http(port, "DELETE", "/_search/scroll", {"scroll_id": sid})
        check(st == 200 and r["num_freed"] == 1, f"(a) clear: {r}")
        if unsliced is None:
            unsliced = (body, set(ids))
        scroll.append(dict(term=term_name(t), total=total,
                           pages=len(pages), wall_s=wall,
                           ms_a_page=wall * 1e3 / len(pages),
                           launches=page_launches))
    out["scroll"] = scroll
    lap("a_scroll")
    # the keyword-sorted scroll over "kw" (two segments), against the
    # numpy oracle of phase 11 (KeywordOracle): ids, order, sort values
    n = len(corpus["lens"])
    ords, kterms = bench_cat(n)
    ords = ords.copy()
    ords[::13] = -1
    orc = KeywordOracle(ords, kterms, kw_extra_docs(len(corpus["df"]),
                                                   kw_seed))
    want_ids, want_vals, want_total = orc.page("asc", CTX_PAGE * CTX_PAGES)
    st, r = http(port, "POST", "/kw/_search?scroll=1m",
                 {"sort": [{"cat": "asc"}], "size": CTX_PAGE,
                  "_source": False})
    check(st == 200, f"(a) kw scroll: {str(r)[:200]}")
    pages = [r]
    t0 = time.perf_counter()
    while len(pages) < CTX_PAGES:
        st, r = http(port, "POST", "/_search/scroll",
                     {"scroll_id": pages[0]["_scroll_id"]})
        check(st == 200, f"(a) kw page: {str(r)[:200]}")
        pages.append(r)
    kw_wall = time.perf_counter() - t0
    hits = [h for p in pages for h in p["hits"]["hits"]]
    check(all(p["hits"]["total"] == {"value": want_total, "relation": "eq"}
              for p in pages), "(a) kw: every page's total")
    check([h["_id"] for h in hits] == want_ids,
          "(a) kw: ten pages equal the oracle's first 10,000 by (term, "
          "segment, docid)")
    check([h["sort"] for h in hits] == [v[:1] for v in want_vals],
          "(a) kw: sort values")
    http(port, "DELETE", "/_search/scroll",
         {"scroll_id": pages[0]["_scroll_id"]})
    out["kw_scroll"] = dict(pages=len(pages), ms_a_page=kw_wall * 1e3
                            / (len(pages) - 1), total=want_total)
    lap("a_kw_scroll")

    # ---- (b) sliced scroll, max 4, of the first body
    body, whole_ids = unsliced
    if hasattr(bench_seg, "_slice_column"):
        del bench_seg._slice_column
    padded = node.device_cache.get(bench_seg).n_docs_padded
    t0 = time.perf_counter()
    slice_column(bench_seg, CTX_SLICES, padded)
    build_s = time.perf_counter() - t0
    seen = []
    t0 = time.perf_counter()
    for sid in range(CTX_SLICES):
        pages, scroll_id = scroll_all(
            port, "/bench/_search",
            dict(body, slice={"id": sid, "max": CTX_SLICES}))
        ids = [h["_id"] for p in pages for h in p["hits"]["hits"]]
        check(all(abs(murmur3_hash(i)) % CTX_SLICES == sid for i in ids),
              f"(b) every hit of slice {sid} hashes to it")
        seen.extend(ids)
        http(port, "DELETE", "/_search/scroll", {"scroll_id": scroll_id})
    slice_wall = time.perf_counter() - t0
    check(len(seen) == len(set(seen)) and set(seen) == whole_ids,
          "(b) the slices are disjoint and their union is the unsliced "
          "scroll's ids")
    out["sliced"] = dict(max=CTX_SLICES, docs=len(seen),
                         hash_build_s=build_s, hash_ids=bench_seg.n_docs,
                         wall_s=slice_wall)
    lap("b_sliced")

    # ---- (c) a point in time on an index of the phase's own
    pc = build_corpus(np.random.default_rng(seed + 1), n_docs=PIT_DOCS,
                      vocab=20_000)
    pq = make_queries(np.random.default_rng(seed + 2), pc["df"],
                      n_docs=PIT_DOCS, n_queries=4)
    node.create_index("pit17", {"properties": {"title": {"type": "text"}}})
    node.indices["pit17"].engine.install_segments(
        [segment_from_corpus(pc, name="pit17_0")])
    st, r = http(port, "POST", "/pit17/_pit?keep_alive=1m")
    check(st == 200, f"(c) open PIT: {r}")
    pit = r["id"]
    pbodies = [{"query": {"match": {"title": " ".join(
        term_name(t) for t in q)}}, "size": 100, "_source": False,
        "pit": {"id": pit}} for q in pq]

    def pit_answers():
        got = []
        for b in pbodies:
            st, r = http(port, "POST", "/_search", b)
            check(st == 200 and r.get("pit_id") == pit,
                  f"(c) PIT search: {str(r)[:300]}")
            got.append(r)
        return got
    lap("c_setup")
    t0 = time.perf_counter()
    first = pit_answers()
    pit_ms = (time.perf_counter() - t0) * 1e3 / len(pbodies)
    for q, r in zip(pq, first):
        check(r["hits"]["total"]["value"] == exact_topk(pc, q, 1)[2],
              "(c) PIT totals against the float64 oracle")
    # new documents that match every body, written and refreshed
    words = sorted({term_name(t) for q in pq for t in q})
    lines = "".join(json.dumps(x) + "\n" for i in range(500) for x in (
        {"index": {"_id": f"late{i}"}}, {"title": " ".join(words)}))
    st, r = http(port, "POST", "/pit17/_bulk?refresh=true", lines,
                 ndjson=True)
    check(st == 200 and not r["errors"], "(c) the late writes")
    t0 = time.perf_counter()
    later = pit_answers()
    pit_warm_ms = (time.perf_counter() - t0) * 1e3 / len(pbodies)
    for a, b in zip(later, first):
        same_answer(a, b, "(c) the PIT after later writes")
    st, r = http(port, "POST", "/pit17/_search",
                 {k: v for k, v in pbodies[0].items() if k != "pit"})
    check(st == 200 and r["hits"]["total"]["value"]
          == first[0]["hits"]["total"]["value"] + 500,
          "(c) outside the PIT the late docs are seen")
    lap("c_late_writes")
    # deletes refreshed after the PIT opened are seen (the reference's
    # PIT reads the pinned segments' live masks)
    gone = {r["hits"]["hits"][0]["_id"] for r in first}
    for i in gone:
        check(http(port, "DELETE", f"/pit17/_doc/{i}")[0] == 200,
              f"(c) delete {i}")
    check(http(port, "POST", "/pit17/_refresh")[0] == 200, "(c) refresh")
    for q, a, b in zip(pq, pit_answers(), first):
        kept = [h["_id"] for h in b["hits"]["hits"] if h["_id"] not in gone]
        matched = dense_scores(pc, q)
        lost = sum(1 for i in gone if matched[int(i)] > 0)
        check([h["_id"] for h in a["hits"]["hits"]][:len(kept)] == kept
              and a["hits"]["total"]["value"]
              == b["hits"]["total"]["value"] - lost,
              "(c) the PIT sees the deletes refreshed after it opened")
    st, r = http(port, "DELETE", "/_pit", {"id": pit})
    check(st == 200 and r["succeeded"] and svc.open_pit_count() == 0,
          f"(c) close: {r}, open {svc.open_pit_count()}")
    out["pit"] = dict(docs=PIT_DOCS, bodies=len(pbodies),
                      first_ms_a_search=pit_ms,
                      warm_ms_a_search=pit_warm_ms, deleted=len(gone))
    lap("c_pit")

    # ---- (f) metadata (before (d) writes to "logs")
    meta = {}
    text = term_name(int(terms[0]))
    st, r = http(port, "POST", "/_aliases", {"actions": [{"add": {
        "index": "logs", "alias": "logs_5xx",
        "filter": {"range": {"status": {"gte": 500}}}}}]})
    check(st == 200, f"(f) alias: {r}")
    lo, hi = int(logs["group_start"][terms[0]]), \
        int(logs["group_start"][terms[0] + 1])
    hit = np.zeros(len(logs["lens"]), bool)
    hit[logs["doc_ids"][lo:hi]] = True
    want = int((hit & (cols["status"]["values"] >= 500)).sum())
    q = {"query": {"match": {"title": text}}, "size": 100,
         "_source": False}
    st, a = http(port, "POST", "/logs_5xx/_search", q)
    st2, b = http(port, "POST", "/logs/_search", {
        "query": {"bool": {"must": [q["query"]], "filter": [
            {"range": {"status": {"gte": 500}}}]}}, "size": 100,
        "_source": False})
    check(st == st2 == 200, f"(f) filtered alias: {str(a)[:200]}")
    same_answer(a, b, "(f) the filtered alias answers the filtered body")
    check(a["hits"]["total"]["value"] == want,
          f"(f) the filtered alias's total against numpy: "
          f"{a['hits']['total']} vs {want}")
    meta["filtered_alias_total"] = want
    lap("f_alias")
    st, r = http(port, "PUT", "/_index_template/auto17", {
        "index_patterns": ["auto17-*"], "priority": 3, "template": {
            "settings": {"index.number_of_shards": 2},
            "mappings": {"properties": {"level": {"type": "keyword"}}}}})
    check(st == 200, f"(f) template: {r}")
    st, r = http(port, "PUT", "/auto17-a/_doc/1?refresh=true",
                 {"level": "warn", "msg": "disk"})
    check(st == 201, f"(f) auto-create: {r}")
    st, m = http(port, "GET", "/auto17-a/_mapping")
    check(m["auto17-a"]["mappings"]["properties"]["level"]
          == {"type": "keyword"}
          and node.indices["auto17-a"].num_shards == 2,
          f"(f) the template mapped the auto-created index: {m}")
    lap("f_template")
    # a data stream: DS_DOCS by _bulk create, a rollover at max_docs, DS_DOCS
    st, r = http(port, "PUT", "/_index_template/ds17", {
        "index_patterns": ["ds17-*"], "data_stream": {}, "priority": 3,
        "template": {"mappings": {"properties": {
            "title": {"type": "text"}, "n": {"type": "long"}}}}})
    check(st == 200, f"(f) stream template: {r}")
    check(http(port, "PUT", "/_data_stream/ds17-logs")[0] == 200,
          "(f) create the data stream")
    vocab = [term_name(t) for t in range(50)]
    picks = rng.integers(0, 50, (2 * DS_DOCS, 4))
    t0 = time.perf_counter()
    for gen in range(2):
        for lo in range(gen * DS_DOCS, (gen + 1) * DS_DOCS, 5000):
            lines = "".join(
                json.dumps({"create": {}}) + "\n" + json.dumps({
                    "@timestamp": LOGS_T0_MS + i * 1000,
                    "title": " ".join(vocab[j] for j in picks[i]),
                    "n": i}) + "\n" for i in range(lo, lo + 5000))
            st, r = http(port, "POST", "/ds17-logs/_bulk", lines,
                         ndjson=True)
            check(st == 200 and not r["errors"], f"(f) stream bulk: "
                  f"{str(r)[:200]}")
        check(http(port, "POST", "/ds17-logs/_refresh")[0] == 200,
              "(f) stream refresh")
        if gen == 0:
            st, r = http(port, "POST", "/ds17-logs/_rollover",
                         {"conditions": {"max_docs": DS_DOCS}})
            check(st == 200 and r["rolled_over"], f"(f) rollover: {r}")
    ds_bulk_s = time.perf_counter() - t0
    lap("f_stream_bulk")
    st, r = http(port, "GET", "/_data_stream/ds17-logs")
    backing = [i["index_name"] for i in r["data_streams"][0]["indices"]]
    check(len(backing) == 2 and r["data_streams"][0]["generation"] == 2,
          f"(f) two backing indices: {r}")
    word = vocab[7]
    sbody = {"query": {"match": {"title": word}}, "sort": [{"n": "asc"}],
             "size": 200, "_source": False}
    st, a = http(port, "POST", "/ds17-logs/_search", sbody)
    st2, b = http(port, "POST", f"/{','.join(backing)}/_search", sbody)
    check(st == st2 == 200, f"(f) stream search: {str(a)[:200]}")
    same_answer(a, b, "(f) the stream answers the union of its backing "
                      "indices")
    want = int((picks == 7).any(axis=1).sum())
    check(a["hits"]["total"]["value"] == want
          and [h["sort"][0] for h in a["hits"]["hits"]]
          == np.nonzero((picks == 7).any(axis=1))[0][:200].tolist(),
          f"(f) the stream's hits against numpy: {a['hits']['total']}")
    lap("f_stream_checks")
    # a write alias
    for name in ("wa17-1", "wa17-2"):
        check(http(port, "PUT", f"/{name}", {})[0] == 200, "(f) create")
    check(http(port, "POST", "/_aliases", {"actions": [
        {"add": {"index": "wa17-1", "alias": "wa17",
                 "is_write_index": True}},
        {"add": {"index": "wa17-2", "alias": "wa17"}}]})[0] == 200,
        "(f) write alias")
    st, r = http(port, "PUT", "/wa17/_doc/w1", {"v": 1})
    check(st == 201, f"(f) write through the alias: {r}")
    check(http(port, "GET", "/wa17-1/_doc/w1")[0] == 200
          and http(port, "GET", "/wa17-2/_doc/w1")[0] == 404,
          "(f) the write landed in the write index")
    meta.update(stream_docs=2 * DS_DOCS, stream_bulk_s=ds_bulk_s,
                stream_docs_a_s=2 * DS_DOCS / ds_bulk_s, backing=backing)
    out["metadata"] = meta
    lap("f_write_alias")

    # ---- (d) _count and the request cache
    t0 = time.perf_counter()
    for i, q in enumerate(queries[:32]):
        st, r = http(port, "POST", "/bench/_count", {"query": {"match": {
            "title": " ".join(term_name(t) for t in q)}}})
        check(st == 200 and r["count"] == oracles[i][2],
              f"(d) _count {i}: {r} vs {oracles[i][2]}")
    count_ms = (time.perf_counter() - t0) * 1e3 / 32
    abody = {"size": 0, "query": {"match": {"title": text}},
             "aggs": {"status": {"terms": {"field": "status"}}}}
    s0 = dict(svc.request_cache_stats)
    st, a = http(port, "POST", "/logs/_search", abody)
    launches0 = {k: c.launches for k, c in counters.items()}
    t0 = time.perf_counter()
    st2, b = http(port, "POST", "/logs/_search", abody)
    hit_ms = (time.perf_counter() - t0) * 1e3
    s1 = dict(svc.request_cache_stats)
    a.pop("took"), b.pop("took")
    check(st == st2 == 200 and a == b
          and s1["hit_count"] == s0["hit_count"] + 1
          and s1["miss_count"] == s0["miss_count"] + 1
          and {k: c.launches for k, c in counters.items()} == launches0,
          f"(d) the repeat is a cache hit, equal, with no launch: {s0} "
          f"{s1}")
    st, r = http(port, "PUT", "/logs/_doc/late17?refresh=true",
                 {"title": text, "status": 503, "bytes": 1,
                  "@timestamp": LOGS_T0_MS})
    check(st == 201, f"(d) write: {r}")
    st, c3 = http(port, "POST", "/logs/_search", abody)
    s2 = dict(svc.request_cache_stats)
    check(s2["miss_count"] == s1["miss_count"] + 1
          and c3["hits"]["total"]["value"]
          == a["hits"]["total"]["value"] + 1,
          f"(d) after a write and a refresh, a miss and the new count: "
          f"{s2}")
    out["count"] = dict(bodies=32, ms_a_count=count_ms, cache_hit_ms=hit_ms,
                        cache=s2)
    lap("d_count_cache")

    # ---- (e) _msearch: 32 fast-lane and 32 plan-path bodies on "bench"
    fp = node.fastpath
    batcher = svc.plan_batcher
    # the plan bodies share a cohort signature: one term each, of one
    # block tier (search/batching.py ``_nb_tier``)
    from elasticsearch_tpu_torch.search.batching import _nb_tier
    by_tier = {}
    for t in sorted({int(t) for q in queries for t in q}
                    | set(range(len(corpus["df"])))):
        if corpus["df"][t] > 0:
            by_tier.setdefault(_nb_tier(int(corpus["nb"][t])), []).append(t)
    tier_terms = max(by_tier.values(), key=len)[:32]
    mbodies = ([plan_body([t], 100) for t in tier_terms]
               + [match_body(q, 100) for q in queries[:32]])
    nd = "".join(json.dumps({"index": "bench"}) + "\n" + json.dumps(b)
                 + "\n" for b in mbodies)
    d0 = dict(fp.serving_stats()["dispatch"])
    p0 = batcher.stats()
    l0 = {k: c.launches for k, c in counters.items()}
    t0 = time.perf_counter()
    st, r = http(port, "POST", "/_msearch", nd, ndjson=True)
    ms_wall = time.perf_counter() - t0
    check(st == 200 and len(r["responses"]) == 64,
          f"(e) _msearch: {str(r)[:300]}")
    p1 = batcher.stats()
    d1 = fp.serving_stats()["dispatch"]
    ms_launch = {k: c.launches - l0[k] for k, c in counters.items()}
    t0 = time.perf_counter()
    alone = [http(port, "POST", "/bench/_search", b) for b in mbodies]
    seq_wall = time.perf_counter() - t0
    for i, (got, (st, want)) in enumerate(zip(r["responses"], alone)):
        check(st == 200 and "hits" in got, f"(e) body {i}: {str(got)[:200]}")
        same_answer(got, want, f"(e) body {i} in the _msearch and alone",
                    front=i >= len(tier_terms))
    hist = {k: p1["batch_hist"].get(k, 0) - p0["batch_hist"].get(k, 0)
            for k in p1["batch_hist"]}
    hist = {k: v for k, v in hist.items() if v}
    check(any(int(k) > 1 for k in hist),
          f"(e) the plan bodies met in shared cohorts: {hist}")
    out["msearch"] = dict(
        bodies=64, wall_s=ms_wall, sequential_s=seq_wall,
        plan_cohorts=p1["launches"] - p0["launches"], cohort_widths=hist,
        fast_dispatch={k: v - d0.get(k, 0) for k, v in d1.items()
                       if v - d0.get(k, 0)},
        launches=ms_launch)
    lap("e_msearch")

    # ---- (g) resize: RESIZE_DOCS docs of 2 shards, clone, split, shrink
    check(http(port, "PUT", "/rs17", {
        "settings": {"index": {"number_of_shards": 2}},
        "mappings": {"properties": {"title": {"type": "text"},
                                    "n": {"type": "long"}}}})[0] == 200,
          "(g) source")
    picks = rng.integers(0, 50, (RESIZE_DOCS, 5))
    t0 = time.perf_counter()
    for lo in range(0, RESIZE_DOCS, 10000):
        lines = "".join(
            json.dumps({"index": {"_id": f"r{i}"}}) + "\n" + json.dumps({
                "title": " ".join(vocab[j] for j in picks[i]), "n": i})
            + "\n" for i in range(lo, min(lo + 10000, RESIZE_DOCS)))
        st, r = http(port, "POST", "/rs17/_bulk", lines, ndjson=True)
        check(st == 200 and not r["errors"], "(g) source bulk")
    check(http(port, "POST", "/rs17/_refresh")[0] == 200, "(g) refresh")
    src_bulk_s = time.perf_counter() - t0
    lap("g_source")
    rbodies = ([{"query": {"match": {"title": vocab[j]}}, "size": 0}
                for j in range(6)]
               + [{"query": {"range": {"n": {"gte": 1000, "lt": 30000}}},
                   "size": 0}, {"size": 0}])
    ids = [f"r{i}" for i in rng.choice(RESIZE_DOCS, 100, replace=False)]

    def snapshot(index):
        tots = [http(port, "POST", f"/{index}/_search", b)[1]["hits"][
            "total"] for b in rbodies]
        st, mg = http(port, "POST", f"/{index}/_mget", {"ids": ids})
        check(st == 200, f"(g) mget {index}")
        return tots, [{k: d.get(k) for k in ("_id", "found", "_source",
                                             "_version")}
                      for d in mg["docs"]]
    want = snapshot("rs17")
    lap("g_source_snapshot")
    resize = {}
    for action, target, shards in (("_clone", "rs17c", 2),
                                   ("_split", "rs17s", 4),
                                   ("_shrink", "rs17k", 1)):
        t0 = time.perf_counter()
        st, r = http(port, "PUT", f"/rs17/{action}/{target}",
                     {"settings": {"index.number_of_shards": shards}})
        resize[action[1:]] = time.perf_counter() - t0
        check(st == 200 and node.indices[target].num_shards == shards,
              f"(g) {action}: {r}")
        got = snapshot(target)
        check(got == want, f"(g) {target}: totals of 8 bodies and the _mget "
                           f"of 100 ids equal the source's")
        lap(f"g_{action[1:]}")
    check(http(port, "DELETE", "/rs17c,rs17s,rs17k")[0] == 200,
          "(g) delete the targets")
    lap("g_delete")
    hbm_agrees(node, "contexts resize", hbm_log)
    out["resize"] = dict(docs=RESIZE_DOCS, source_bulk_s=src_bulk_s,
                         seconds=resize)
    lap("g_accounting")

    # ---- (h) _explain and a stored script
    t0 = time.perf_counter()
    n_explain = 0
    for q in queries[:4]:
        body = match_body(q, 16)
        st, r = http(port, "POST", "/bench/_search", body)
        check(st == 200, f"(h) search: {str(r)[:200]}")
        for h in r["hits"]["hits"]:
            st, e = http(port, "POST", f"/bench/_explain/{h['_id']}",
                         {"query": body["query"]})
            n_explain += 1
            check(st == 200 and e["matched"] and abs(
                e["explanation"]["value"] - h["_score"])
                <= 1e-6 * abs(h["_score"]),
                f"(h) explain {h['_id']}: {e} vs {h['_score']}")
    explain_ms = (time.perf_counter() - t0) * 1e3 / n_explain
    scores0 = dense_scores(corpus, queries[0])
    miss = int(np.nonzero(scores0 == 0.0)[0][0])
    st, e = http(port, "POST", f"/bench/_explain/{miss}",
                 {"query": match_body(queries[0], 1)["query"]})
    check(st == 200 and e["matched"] is False,
          f"(h) a doc that does not match: {e}")
    st, r = http(port, "PUT", "/_scripts/s1", {"script": {
        "lang": "painless", "source": SCRIPT_BENCH}})
    check(st == 200, f"(h) PUT _scripts: {r}")
    for q in queries[:2]:
        text_q = " ".join(term_name(t) for t in q)
        st, a = http(port, "POST", "/hybrid/_search",
                     script_body(text_q, SCRIPT_BENCH, 100))
        by_id = script_body(text_q, SCRIPT_BENCH, 100)
        by_id["query"]["script_score"]["script"] = {"id": "s1"}
        st2, b = http(port, "POST", "/hybrid/_search", by_id)
        check(st == st2 == 200, f"(h) script by id: {str(b)[:200]}")
        same_answer(a, b, "(h) the stored script answers as the inline")
    out["explain"] = dict(explains=n_explain, ms_an_explain=explain_ms)
    lap("h_explain_scripts")

    # ---- (i) closing the registered index drops it from the front
    ibodies = [match_body(q, 100) for q in queries[:8]]
    before = [http(port, "POST", "/bench/_search", b)[1] for b in ibodies]
    h0 = node.http_stats()
    t0 = time.perf_counter()
    check(http(port, "POST", "/bench/_close")[0] == 200, "(i) close")
    close_s = time.perf_counter() - t0
    for b in ibodies:
        st, r = http(port, "POST", "/bench/_search", b)
        check(st == 400 and r["error"]["type"] == "index_closed_exception"
              and r["error"]["reason"] == "closed index [bench]"
              and r["error"].get("index") == "bench",
              f"(i) a closed index's search: {st} {str(r)[:300]}")
    f1 = front_since(node, h0)
    check(f1["fast"] == 0, f"(i) the front served none: {f1}")
    t0 = time.perf_counter()
    check(http(port, "POST", "/bench/_open")[0] == 200, "(i) open")
    open_s = time.perf_counter() - t0
    h1 = node.http_stats()
    for b, want in zip(ibodies, before):
        st, r = http(port, "POST", "/bench/_search", b)
        check(st == 200, f"(i) after _open: {str(r)[:200]}")
        same_answer(r, want, "(i) after _open as before", front=True)
    f2 = front_since(node, h1)
    check(f2["fast"] == len(ibodies)
          and node.http_stats()["front_registrations"]
          > h0["front_registrations"],
          f"(i) registered again: {f2}")
    out["closed"] = dict(close_s=close_s, open_s=open_s, front_closed=f1,
                         front_open=f2)
    lap("i_closed")

    # ---- (j) a scroll and a PIT outlive a merge; then cleared
    st, r = http(port, "POST", "/pit17/_search?scroll=1m",
                 {k: v for k, v in pbodies[1].items() if k != "pit"})
    check(st == 200, f"(j) scroll: {str(r)[:200]}")
    sid = r["_scroll_id"]
    st, p = http(port, "POST", "/pit17/_pit?keep_alive=1m")
    old = node.indices["pit17"].segment_names()
    check(len(old) >= 2, f"(j) pit17 holds several segments: {old}")
    lap("j_open")
    check(http(port, "POST", "/pit17/_forcemerge")[0] == 200, "(j) merge")
    lap("j_merge")
    check(not any(node.device_cache.resident(s) for s in old),
          "(j) the merge evicted the old segments")
    st, r1 = http(port, "POST", "/_search/scroll", {"scroll_id": sid})
    st2, r2 = http(port, "POST", "/_search", dict(pbodies[1],
                                                  pit={"id": p["id"]}))
    check(st == st2 == 200 and all(node.device_cache.resident(s)
                                    for s in old),
          "(j) the contexts read the merged-away segments again")
    held = sum(node.device_cache.resident(s).hbm_bytes() for s in old)
    http(port, "DELETE", "/_search/scroll", {"scroll_id": sid})
    http(port, "DELETE", "/_pit", {"id": p["id"]})
    check(not any(node.device_cache.resident(s) for s in old)
          and svc.open_scroll_count() == 0 and svc.open_pit_count() == 0,
          "(j) clearing both released the merged-away segments")
    hbm_agrees(node, "contexts", hbm_log)
    out["accounting"] = dict(retired_segments=len(old),
                             retired_bytes_held=held)
    lap("j_accounting")

    launches = {k: c.launches for k, c in counters.items()}
    check(all(v > 0 for v in launches.values()),
          f"phase 17: both kernels launched: {launches}")
    out["launches"] = launches
    out["steps_s"] = steps
    gc.callbacks.remove(gc_timer)
    out["gc"] = dict(pause_s=gc_s[0], collections=gc_s[1],
                     frozen=gc.get_freeze_count())
    out["phase_s"] = time.time() - t_phase
    log(f"[contexts] {json.dumps(out)[:3000]}")
    return out


def contexts_alone(docs=2_000_000, vocab=100_000, seed=0):
    """Phase 17 by itself on the card, on a node holding what it reads of
    the earlier phases' indices: "bench" (registered with the front),
    "logs", phase 11's "kw" and "hybrid" with its ``feat`` column:

        python3 -c 'import chip_smoke as c; c.contexts_alone()'
    """
    import torch

    from elasticsearch_tpu_torch.corpus import (LOGS_MAPPINGS, bench_cat,
                                                bench_feat, build_corpus,
                                                exact_topk, keyword_postings,
                                                logs_columns, make_queries,
                                                segment_from_corpus,
                                                with_incident_terms)
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import _build
    from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
    from elasticsearch_tpu_torch.ops.merge import merge_sorted_slots
    _build.build_all()
    rng = np.random.default_rng(seed)
    corpus = build_corpus(rng, n_docs=docs, vocab=vocab)
    queries = make_queries(rng, corpus["df"], n_docs=docs, n_queries=256)
    node = Node(device="cuda", settings={"indices.breaker.hbm.limit": int(
        0.75 * torch.cuda.mem_get_info()[1])})
    try:
        node.create_index("bench", {"properties": {"title":
                                                   {"type": "text"}}})
        node.indices["bench"].engine.install_segments(
            [segment_from_corpus(corpus)])
        port = node.start(0)
        oracles = [exact_topk(corpus, q, 10) for q in queries[:32]]
        logs = with_incident_terms(corpus, np.random.default_rng(seed + 3))
        cols = logs_columns(docs, np.random.default_rng(seed + 5))
        node.create_index("logs", LOGS_MAPPINGS)
        node.indices["logs"].engine.install_segments(
            [segment_from_corpus(logs, name="logs0", numerics=cols)])
        ords, terms = bench_cat(docs)
        ords = ords.copy()
        ords[::13] = -1
        node.create_index("kw", {"properties": {
            "title": {"type": "text"}, "cat": {"type": "keyword"}}})
        node.indices["kw"].engine.install_segments([segment_from_corpus(
            corpus, name="kw0", keywords={"cat": {"ords": ords,
                                                  "terms": terms}},
            fields={"cat": keyword_postings(ords, terms)})])
        extra = kw_extra_docs(vocab, seed + 14)
        st, r = http(port, "POST", "/kw/_bulk", "".join(
            json.dumps({"index": {"_id": f"x{i}"}}) + "\n" + json.dumps(d)
            + "\n" for i, d in enumerate(extra)), ndjson=True)
        check(st == 200 and not r["errors"], "kw bulk")
        check(http(port, "POST", "/kw/_refresh")[0] == 200, "kw refresh")
        node.create_index("hybrid", {"properties": {
            "title": {"type": "text"}, "feat": {"type": "double"}}})
        node.indices["hybrid"].engine.install_segments([segment_from_corpus(
            corpus, name="hybrid0",
            numerics={"feat": {"values": bench_feat(docs)}})])
        counters = {"gather_bm25_contrib": gather_bm25_contrib,
                    "merge_sorted_slots": merge_sorted_slots}
        out = phase_contexts(node, port, corpus, queries, oracles, logs,
                             cols, seed + 14, seed + 18, counters, [])
        print(json.dumps({"contexts": out}))
        return out
    finally:
        node.close()


# ---------------------------------------------------------------- phase 18
AN_DOCS = 10_000       # the analyzed index (cut from 50,000: PERF.md 4)
AN_BULK = 5_000        # Rally's bulk_size
AN_STD_DOCS = 10_000   # "an18_std", the one standard field's index
AN_BODIES = 32         # match/bool bodies a field, on each path
AN_SIZE = 1000
AN_PHRASES = 8         # phrase and highlight bodies a field
AN_ANALYZE = 64
AN_TV = 32
AN_FAST = 16           # an18_std's fast bodies
AN_FIELDS = ("title", "body", "body.exact", "tags")
AN_HEADS = ("/an18", "/nope", "/an18/_doc/1", "/an18/_doc/999999",
            "/an18/_source/1", "/_alias/an18_al", "/_index_template/none")


class AnalyzedOracle:
    """float64 BM25 and phrase matches over what the shard's segments hold
    for one field (the postings' blocks, field lengths and token streams):
    the statistics count every copy, live or deleted, as the shard's do;
    only live copies match."""

    def __init__(self, segments, field, k1=1.2, b=0.75):
        self.segments = [s for s in segments if field in s.postings]
        self.field, self.k1, self.b = field, k1, b
        pfs = [s.postings[field] for s in self.segments]
        self.doc_count = sum(pf.doc_count for pf in pfs)
        self.avg = (sum(pf.sum_total_term_freq for pf in pfs)
                    / max(1, self.doc_count))
        self.ids = [np.asarray([int(i) for i in s.stored.ids], np.int64)
                    for s in self.segments]

    def df(self, term):
        """The term's doc freq over the segments (every copy)."""
        return sum(int(pf.doc_freq[tid]) for s in self.segments
                   if (tid := (pf := s.postings[self.field]).term_id(term))
                   >= 0)

    def known(self, term):
        return any(s.postings[self.field].term_id(term) >= 0
                   for s in self.segments)

    def _postings(self, pf, term):
        tid = pf.term_id(term)
        if tid < 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float64)
        lo = int(pf.term_block_start[tid])
        hi = lo + int(pf.term_block_count[tid])
        d = np.asarray(pf.block_docids[lo:hi]).reshape(-1).astype(np.int64)
        f = np.asarray(pf.block_tfs[lo:hi]).reshape(-1).astype(np.float64)
        keep = f > 0
        return d[keep], f[keep]

    def scores(self, terms):
        """[per segment float64 scores], every term counted as often as
        the analyzer gave it."""
        from elasticsearch_tpu_torch.ops.bm25 import idf
        dfs = {t: self.df(t) for t in set(terms)}
        out = []
        for s in self.segments:
            pf = s.postings[self.field]
            sc = np.zeros(s.n_docs, np.float64)
            lens = np.asarray(pf.field_lengths, np.float64)
            for t in terms:
                if not dfs[t]:
                    continue
                d, f = self._postings(pf, t)
                norm = self.k1 * (1 - self.b + self.b * lens[d] / self.avg)
                sc[d] += idf(dfs[t], self.doc_count) * f / (f + norm)
            out.append(np.where(np.asarray(s.live, bool), sc, 0.0))
        return out

    def phrase_ids(self, positions):
        """The live ids whose stream holds ``positions`` ({relative
        position: term}) at some start."""
        out = []
        for s, ids in zip(self.segments, self.ids):
            st = s.streams.get(self.field)
            if st is None:
                continue
            toks = np.asarray(st.tokens)
            pf = s.postings[self.field]
            tids = {p: pf.term_id(t) for p, t in positions.items()}
            if min(tids.values()) < 0:
                continue
            span = max(positions) + 1
            n = toks.shape[1] - span + 1
            if n <= 0:
                continue
            hit = np.ones((toks.shape[0], n), bool)
            for p, tid in tids.items():
                hit &= toks[:, p:p + n] == tid
            found = hit.any(axis=1) & np.asarray(s.live, bool)
            out.extend(ids[found].tolist())
        return sorted(out)

    @staticmethod
    def topk(ids_scores, k):
        """(ids, scores, total) of the top k of [(ids, scores)] pieces."""
        ids = np.concatenate([i for i, _ in ids_scores])
        sc = np.concatenate([s for _, s in ids_scores])
        m = sc > 0
        ids, sc = ids[m], sc[m]
        order = np.lexsort((ids, -sc))[:k]
        return ids[order], sc[order], int(m.sum())


def an_check(r, oracle_top, what):
    """An answer against the oracle's top k: the total exact ("eq"), the
    recall rule of the plan path, each served score within rtol 1e-5."""
    truth, scores, total = oracle_top
    check_answer(r, (truth, scores, total), "plan", what)
    by_id = dict(zip(truth.tolist(), scores.tolist()))
    kth = scores[-1] if len(scores) else 0.0
    for h in r["hits"]["hits"]:
        want = by_id.get(int(h["_id"]))
        check(want is not None or abs(h["_score"] - kth) <= 1e-5 * kth,
              f"{what}: doc {h['_id']} outside the oracle's top k")
        if want is not None:
            check(abs(h["_score"] - want) <= 1e-5 * want,
                  f"{what}: doc {h['_id']} scored {h['_score']} vs {want}")


def same_as_cpu(r, c, what, rtol=1e-6):
    """A card answer against the port's CPU execution of the body: ids,
    order and totals equal, scores within ``rtol``, highlights equal."""
    check(r["hits"]["total"] == c["hits"]["total"],
          f"{what}: totals {r['hits']['total']} vs {c['hits']['total']}")
    gh, ch = r["hits"]["hits"], c["hits"]["hits"]
    check([h["_id"] for h in gh] == [h["_id"] for h in ch],
          f"{what}: ids and order equal to the CPU execution")
    gs = np.array([h["_score"] or 0.0 for h in gh], np.float64)
    cs = np.array([h["_score"] or 0.0 for h in ch], np.float64)
    check(np.allclose(gs, cs, rtol=rtol, atol=0),
          f"{what}: scores within rtol {rtol} of the CPU execution")
    check([h.get("highlight") for h in gh] == [h.get("highlight")
                                               for h in ch],
          f"{what}: highlights equal to the CPU execution")


def an_term_pool(oracle, analyzer, docs, field, rng, n):
    """``n`` query texts for ``field``: one to three words of the docs'
    own text, each text's analyzed terms known to the segment."""
    out = []
    src = [d[field.split(".")[0]] for d in docs]
    while len(out) < n:
        words = src[int(rng.integers(len(src)))].split()
        i = int(rng.integers(max(1, len(words) - 3)))
        text = " ".join(words[i:i + int(rng.integers(1, 4))])
        terms = analyzer.terms(text)
        if terms and all(oracle.known(t) for t in terms):
            out.append((text, terms))
    return out


def phase_analysis(node, port, seed, counters, cpu, hbm_log):
    """Analysis, term vectors and the by-query family on one H100
    (module docstring, phase 18), on the main node."""
    import torch

    from elasticsearch_tpu_torch.corpus import (ANALYSIS_MAPPINGS,
                                                ANALYSIS_SETTINGS,
                                                english_docs)
    from elasticsearch_tpu_torch.rest.api import (analyze_answer,
                                                  termvectors_of)
    from elasticsearch_tpu_torch.telemetry.engine import TRACKER
    t_phase = time.time()
    out = {}
    steps = {}
    t_step = [time.time()]

    def lap(name):
        now = time.time()
        steps[name] = now - t_step[0]
        t_step[0] = now

    fp = node.fastpath
    card = {"launches": {n: 0 for n in counters}, "scorings": 0,
            "cohorts_v2m": 0, "cohorts": 0,
            "kernels_calls": {n: 0 for n in counters}}

    def kernel_calls():
        _, k = http(port, "GET", "/_kernels")
        return {n: k["kernels"].get(n, {}).get("calls", 0)
                for n in counters}

    @contextlib.contextmanager
    def on_card():
        """Counts the block's launches, dense scorings, fast cohorts and
        /_kernels calls (the CPU twin's comparisons, whose calls the
        tracker counts too, run outside such blocks)."""
        k0 = kernel_calls()
        l0 = {n: c.launches for n, c in counters.items()}
        s0 = TRACKER.calls("bm25_dense_scores_sorted")
        c0 = dict(fp.stats)
        yield
        for n, c in counters.items():
            card["launches"][n] += c.launches - l0[n]
        card["scorings"] += TRACKER.calls("bm25_dense_scores_sorted") - s0
        card["cohorts_v2m"] += fp.stats["cohorts_v2m"] - c0["cohorts_v2m"]
        card["cohorts"] += fp.stats["cohorts"] - c0["cohorts"]
        k1 = kernel_calls()
        for n in counters:
            card["kernels_calls"][n] += k1[n] - k0[n]

    for c in counters.values():
        c.launches = 0
    rng = np.random.default_rng(seed)
    docs = english_docs(AN_DOCS, rng)
    lap("a_corpus")

    # ---- (a) the analyzed index through _bulk
    st, r = http(port, "PUT", "/an18", {
        "settings": {"index": dict(ANALYSIS_SETTINGS["index"],
                                   number_of_shards=1)},
        "mappings": ANALYSIS_MAPPINGS})
    check(st == 200, f"(a) PUT /an18: {r}")
    t0 = time.time()
    for lo in range(0, AN_DOCS, AN_BULK):
        lines = "".join(
            json.dumps({"index": {"_id": str(i)}}) + "\n"
            + json.dumps(docs[i]) + "\n" for i in range(lo, lo + AN_BULK))
        st, r = http(port, "POST", "/an18/_bulk", lines, ndjson=True)
        check(st == 200 and not r["errors"], f"(a) bulk at {lo}: "
              f"{str(r)[:300]}")
    bulk_s = time.time() - t0
    check(http(port, "POST", "/an18/_refresh")[0] == 200, "(a) _refresh")
    svc = node.indices["an18"]
    mapper = svc.mapper
    # the analyzers' host cost a doc, each field on the same sample
    sample = docs[:2000]
    us_doc = {}
    for f in AN_FIELDS:
        an = mapper.index_analyzer(mapper.field_type(f))
        vals = [d[f.split(".")[0]] for d in sample]
        t0 = time.perf_counter()
        for v in vals:
            an.analyze(v)
        us_doc[f] = (time.perf_counter() - t0) * 1e6 / len(vals)
    out["bulk"] = dict(docs=AN_DOCS, requests=AN_DOCS // AN_BULK,
                       seconds=bulk_s, docs_per_s=AN_DOCS / bulk_s,
                       analyzer_us_a_doc=us_doc,
                       segments=len(svc.engine.segments))
    log(f"[analysis] bulk {out['bulk']}")
    lap("a_bulk")

    # ---- (b) match/bool bodies on each field, plan path and dense
    segs = svc.engine.segments
    oracles = {f: AnalyzedOracle(segs, f) for f in AN_FIELDS}
    kinds = {}
    bodies, checks = [], []
    for f in AN_FIELDS:
        an = mapper.search_analyzer(mapper.field_type(f))
        pool = an_term_pool(oracles[f], an, docs, f, rng, AN_BODIES + 8)
        for j, (text, terms) in enumerate(pool[:AN_BODIES]):
            if j % 2 == 0:
                q = {"match": {f: text}}
                sc = oracles[f].scores(terms)
            else:
                text2, terms2 = pool[AN_BODIES + (j // 2) % 8]
                q = {"bool": {"must": [{"match": {f: text}}],
                              "should": [{"match": {f: text2}}]}}
                s1, s2 = oracles[f].scores(terms), oracles[f].scores(terms2)
                sc = [np.where(a > 0, a + c, 0.0) for a, c in zip(s1, s2)]
            top = AnalyzedOracle.topk(list(zip(oracles[f].ids, sc)),
                                      AN_SIZE)
            for path in ("plan", "dense"):
                body = {"query": q, "size": AN_SIZE, "_source": False}
                if path == "dense":
                    body["min_score"] = 1e-12
                kinds.setdefault(f"{path}_{'match' if j % 2 == 0 else 'bool'}",
                                 []).append(len(bodies))
                bodies.append(body)
                checks.append(("bm25", top, f"{f} {path} body {j}"))
        # phrases (two or three consecutive words) and highlights
        for j in range(AN_PHRASES):
            text, terms = pool[j]
            if len(terms) >= 2:
                # the analyzed terms at consecutive positions (the
                # reference's phrase drops the query's position gaps; the
                # streams keep the documents')
                body = {"query": {"match_phrase": {f: text}},
                        "size": AN_SIZE, "_source": False}
                kinds.setdefault("phrase", []).append(len(bodies))
                bodies.append(body)
                checks.append(("phrase", oracles[f].phrase_ids(
                    dict(enumerate(terms))), f"{f} phrase {j}"))
            body = {"query": {"match": {f: text}}, "size": 20,
                    "highlight": {"fields": {f: {}}}}
            kinds.setdefault("highlight", []).append(len(bodies))
            bodies.append(body)
            checks.append(("bm25", AnalyzedOracle.topk(
                list(zip(oracles[f].ids, oracles[f].scores(terms))), 20),
                f"{f} highlight {j}"))
    lap("b_bodies_and_oracles")
    with on_card():
        res, lat, wall = drive(port, bodies, 8, "an18")
    lap("b_served")
    for i, ((st, r), (kind, want, what)) in enumerate(zip(res, checks)):
        check(st == 200, f"(b) {what}: {str(r)[:300]}")
        if kind == "bm25":
            an_check(r, want, f"(b) {what}")
        else:
            got = sorted(int(h["_id"]) for h in r["hits"]["hits"])
            check(r["hits"]["total"] == {"value": len(want),
                                         "relation": "eq"},
                  f"(b) {what}: the phrase's total is the streams'")
            check(len(want) > AN_SIZE or got == want,
                  f"(b) {what}: the phrase's docs are the streams'")
        same_as_cpu(r, cpu.search("an18", bodies[i]), f"(b) {what}")
    out["bodies"] = {k: len(v) for k, v in kinds.items()}
    out["query_ms"] = {k: float(np.median([lat[i] for i in v]) * 1e3)
                       for k, v in kinds.items()}
    out["load"] = dict(requests=len(bodies), wall_s=wall,
                       qps=len(bodies) / wall, clients=8)
    log(f"[analysis] bodies {out['bodies']} ms {out['query_ms']}")
    lap("b_checked")

    # ---- (c) _analyze and term vectors
    names = ["standard", "simple", "whitespace", "stop", "keyword",
             "english", "english_syn", "exact"]
    reqs = []
    for j in range(AN_ANALYZE):
        text = docs[int(rng.integers(AN_DOCS))]["body"]
        kind = j % 4
        if kind == 0:
            body = {"analyzer": names[j % len(names)], "text": text}
        elif kind == 1:
            body = {"field": AN_FIELDS[j % len(AN_FIELDS)], "text": text}
        elif kind == 2:
            body = {"tokenizer": ["standard", "whitespace", "pattern"][j % 3],
                    "filter": ["lowercase", "few_stop",
                               {"type": "shingle", "max_shingle_size": 3}],
                    "char_filter": ["html_strip", "amp"],
                    "text": [text, text[:40]]}
        else:
            body = {"analyzer": names[j % len(names)], "text": text,
                    "explain": True}
        reqs.append(("POST", "/an18/_analyze", body))
    tv_ids = [str(int(x)) for x in rng.integers(0, AN_DOCS, AN_TV)]
    reqs += [("GET", f"/an18/_termvectors/{i}?term_statistics=true", None)
             for i in tv_ids]
    reqs.append(("POST", "/an18/_mtermvectors",
                 {"ids": tv_ids, "term_statistics": True}))
    t0 = time.perf_counter()
    answers = ask_many(port, reqs, 8)
    tv_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in tv_ids[:8]:
        http(port, "GET", f"/an18/_termvectors/{i}?term_statistics=true")
    tv_ms = (time.perf_counter() - t0) * 1e3 / 8
    for (method, path, body), (st, r) in zip(reqs, answers):
        check(st == 200, f"(c) {path}: {str(r)[:200]}")
        if path.endswith("_analyze"):
            want = analyze_answer(svc.mapper.analysis, body, mapper)
            if "analyzer" in body and not body.get("explain"):
                an = mapper.analysis.get(body["analyzer"])
                texts = body["text"] if isinstance(body["text"],
                                                   list) else [body["text"]]
                check([t["token"] for t in r["tokens"]]
                      == [t for x in texts for t in an.terms(x)],
                      f"(c) {body['analyzer']}: the analyzer's own terms")
            check(r == want, f"(c) _analyze {str(body)[:100]}: the CPU "
                             f"answer")
        elif "_mtermvectors" in path:
            check([d["found"] for d in r["docs"]] == [True] * AN_TV
                  and r["docs"] == [termvectors_of(
                      node, "an18", i, {"term_statistics": True})
                      for i in tv_ids], "(c) _mtermvectors: the CPU answer")
        else:
            doc_id = path.split("/")[3].split("?")[0]
            want = termvectors_of(node, "an18", doc_id,
                                  {"term_statistics": True})
            check(r == want, f"(c) _termvectors {doc_id}: the CPU answer")
            src = docs[int(doc_id)]
            for f, tv in r["term_vectors"].items():
                an = mapper.index_analyzer(mapper.field_type(f))
                toks = an.analyze(src[f.split(".")[0]])
                check(sum(e["term_freq"] for e in tv["terms"].values())
                      == len(toks)
                      and all(e["doc_freq"] == oracles[f].df(t)
                              for t, e in tv["terms"].items()),
                      f"(c) _termvectors {doc_id} {f}: the tokens and the "
                      f"postings' doc freqs")
    out["analyze"] = dict(requests=AN_ANALYZE, termvectors=AN_TV,
                          mtermvectors=1, wall_s=tv_wall,
                          termvectors_ms=tv_ms)
    lap("c_analyze_termvectors")

    # ---- (d) HEAD answers the GET's status
    check(http(port, "PUT", "/an18/_alias/an18_al")[0] == 200, "(d) alias")
    import http.client as _hc
    heads = {}
    for path in AN_HEADS:
        conn = _hc.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("HEAD", path)
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        gst = http(port, "GET", path)[0]
        check(resp.status == gst and body == b"",
              f"(d) HEAD {path}: {resp.status} vs GET {gst}")
        heads[path] = resp.status
    check(list(heads.values()) == [200, 404, 200, 404, 200, 200, 404],
          f"(d) the statuses: {heads}")
    out["head"] = heads
    lap("d_head")

    # ---- (e) the fast path: an18 never on the front; an18_std's fast
    # bodies through the merge kernel, equal to the plan path's
    check(http(port, "POST", "/an18/_forcemerge")[0] == 200, "(e) merge")
    node.refresh_front()
    reg = fp.front_registration()
    check(reg is None or reg["index"] != "an18",
          f"(e) an18 is not on the front: {reg and reg['index']}")
    fast_bodies = [{"query": {"match": {"title": t}}, "size": 100,
                    "_source": False}
                   for t, _ in an_term_pool(
                       AnalyzedOracle(svc.engine.segments, "title"),
                       mapper.search_analyzer(mapper.field_type("title")),
                       docs, "title", rng, AN_FAST)]
    h0 = node.http_stats()
    with on_card():
        res, _, _ = drive(port, fast_bodies, 4, "an18")
    f1 = front_since(node, h0)
    check(all(st == 200 for st, _ in res) and f1["fast"] == 0,
          f"(e) the front served none of an18's bodies: {f1}")
    st, r = http(port, "PUT", "/an18_std", {
        "settings": {"index": {"number_of_shards": 1}},
        "mappings": {"properties": {"title": {"type": "text"}}}})
    lines = "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                    + json.dumps({"title": docs[i]["title"]}) + "\n"
                    for i in range(AN_STD_DOCS))
    st, r = http(port, "POST", "/an18_std/_bulk?refresh=true", lines,
                 ndjson=True)
    check(st == 200 and not r["errors"], "(e) an18_std bulk")
    check(http(port, "POST", "/an18_std/_forcemerge")[0] == 200,
          "(e) an18_std merge")
    std_svc = node.indices["an18_std"]
    check(std_svc.mapper.standard_analyzed(
        std_svc.mapper.field_type("title"))
        and not mapper.standard_analyzed(mapper.field_type("body")),
        "(e) the gate: title builtin standard, body not")
    src_bodies = [dict(b, _source=True) for b in fast_bodies]
    m0 = counters["merge_sorted_slots"].launches
    c0 = fp.stats["cohorts_v2m"]
    with on_card():
        fast, _, _ = drive(port, src_bodies, 4, "an18_std")
    merges = counters["merge_sorted_slots"].launches - m0
    cohorts = fp.stats["cohorts_v2m"] - c0
    check(merges == cohorts > 0, f"(e) an18_std's fast bodies launched "
          f"the merge once a v2m cohort: {merges} vs {cohorts}")
    plan_bodies = [{"query": {"match": {"title": {
        "query": b["query"]["match"]["title"], "boost": 1.0}}},
        "size": 100} for b in fast_bodies]
    with on_card():
        plan, _, _ = drive(port, plan_bodies, 4, "an18_std")
    for j, ((st, a), (st2, p)) in enumerate(zip(fast, plan)):
        check(st == st2 == 200, f"(e) an18_std body {j}")
        same_hits(a, p, f"(e) an18_std fast body {j} against the plan "
                        f"path")
    out["fast"] = dict(front_an18=f1, merges=merges, v2m_cohorts=cohorts,
                       registered=reg and reg["index"])
    lap("e_fast")

    # ---- (f) _reindex into another analyzer, then the by-query family
    st, r = http(port, "PUT", "/an18_en", {
        "settings": {"index": {"number_of_shards": 1, "analysis": {
            "filter": {"more_stop": {"type": "stop",
                                     "stopwords": ["run", "walk"]}},
            "analyzer": {"en_stop": {
                "type": "custom", "tokenizer": "standard",
                "filter": ["lowercase", "stop", "more_stop",
                           "porter_stem"]}}}}},
        "mappings": {"properties": {
            "title": {"type": "text"},
            "body": {"type": "text", "analyzer": "en_stop"},
            "tags": {"type": "text", "analyzer": "whitespace"}}}})
    check(st == 200, f"(f) PUT an18_en: {r}")
    t0 = time.time()
    with on_card():
        st, rr = http(port, "POST", "/_reindex?refresh=true", {
            "source": {"index": "an18"}, "dest": {"index": "an18_en"}})
    reindex_s = time.time() - t0
    check(st == 200 and rr["created"] == rr["total"] == AN_DOCS
          and not rr["failures"], f"(f) _reindex: {str(rr)[:300]}")
    st, c1 = http(port, "GET", "/an18/_count")
    st2, c2 = http(port, "GET", "/an18_en/_count")
    check(c1["count"] == c2["count"] == AN_DOCS, f"(f) totals {c1} {c2}")
    # one term's docs through a script, another term's deleted
    # two terms of about 500 docs each
    pf = svc.engine.segments[0].postings["body"]
    near = np.argsort(np.abs(np.asarray(pf.doc_freq, np.int64) - 500),
                      kind="stable")
    t_upd, t_del = pf.terms[int(near[0])], pf.terms[int(near[1])]
    ids_upd = AnalyzedOracle.topk(list(zip(
        oracles["body"].ids, oracles["body"].scores([t_upd]))), AN_DOCS)[0]
    ids_del = AnalyzedOracle.topk(list(zip(
        oracles["body"].ids, oracles["body"].scores([t_del]))), AN_DOCS)[0]
    with on_card():
        st, ru = http(port, "POST", "/an18/_update_by_query?refresh=true", {
            "query": {"term": {"body": t_upd}},
            "script": {"source": "ctx._source.tags += ' touched18'"}})
    check(st == 200 and ru["updated"] == ru["total"] == len(ids_upd),
          f"(f) _update_by_query: {str(ru)[:300]} vs {len(ids_upd)}")
    st, mg = http(port, "POST", "/an18/_mget",
                  {"ids": [str(i) for i in ids_upd.tolist()]})
    check(all(d["found"] and d["_source"]["tags"].endswith(" touched18")
              for d in mg["docs"]), "(f) _mget of the updated ids")
    with on_card():
        st, rt = http(port, "POST", "/an18/_search", {
            "query": {"match": {"tags": "touched18"}}, "size": 0,
            "track_total_hits": True})
        st, rd = http(port, "POST", "/an18/_delete_by_query?refresh=true",
                      {"query": {"term": {"body": t_del}}})
    check(rt["hits"]["total"]["value"] == len(ids_upd),
          f"(f) the updated docs found by their new tag: {rt['hits']}")
    check(st == 200 and rd["deleted"] == rd["total"] == len(ids_del),
          f"(f) _delete_by_query: {str(rd)[:300]} vs {len(ids_del)}")
    st, mg = http(port, "POST", "/an18/_mget",
                  {"ids": [str(i) for i in ids_del.tolist()]})
    check(not any(d["found"] for d in mg["docs"]),
          "(f) _mget of the deleted ids")
    with on_card():
        st, c3 = http(port, "GET", "/an18/_count")
    check(c3["count"] == AN_DOCS - len(ids_del),
          f"(f) the total after the delete: {c3}")
    # the oracle again over what the segments now hold
    segs = node.indices["an18"].engine.segments
    post = AnalyzedOracle(segs, "body")
    q = {"query": {"match": {"body": f"{t_upd} {t_del}"}}, "size": AN_SIZE}
    with on_card():
        st, r = http(port, "POST", "/an18/_search", q)
    an_check(r, AnalyzedOracle.topk(list(zip(post.ids, post.scores(
        [t_upd, t_del]))), AN_SIZE), "(f) after the by-query writes")
    same_as_cpu(r, cpu.search("an18", q), "(f) after the by-query writes")
    out["reindex"] = dict(seconds=reindex_s, docs_per_s=AN_DOCS / reindex_s,
                          batches=rr["batches"], updated=ru["updated"],
                          update_s=ru["took"] / 1e3,
                          deleted=rd["deleted"], delete_s=rd["took"] / 1e3)
    log(f"[analysis] reindex {out['reindex']}")
    lap("f_reindex")

    # ---- (g) the kernels' counts, the breaker
    for name in ("an18_en", "an18_std"):
        check(http(port, "DELETE", f"/{name}")[0] == 200, f"(g) delete {name}")
    hbm_agrees(node, "analysis", hbm_log)
    calls = card["kernels_calls"]
    launches = {n: c.launches for n, c in counters.items()}
    check(card["launches"] == launches,
          f"(g) every launch of the phase was on the card: {card} "
          f"{launches}")
    # every fast cohort here is a v2m cohort: one launch of each kernel
    check(card["cohorts"] == card["cohorts_v2m"] > 0
          and launches["gather_bm25_contrib"]
          == card["scorings"] + card["cohorts"]
          and card["scorings"] > 0
          and launches["merge_sorted_slots"] == card["cohorts_v2m"]
          and calls == launches,
          f"(g) the contribution kernel once a dense BM25 scoring "
          f"({card['scorings']}) and once a fast cohort, the merge once a "
          f"v2m cohort ({card['cohorts_v2m']} of {card['cohorts']}), "
          f"/_kernels agrees: {launches} vs {calls}")
    out["launches"] = launches
    out["kernels_calls"] = calls
    out["dense_scorings"] = card["scorings"]
    out["fast_cohorts"] = card["cohorts"]
    out["steps_s"] = steps
    out["phase_s"] = time.time() - t_phase
    torch.cuda.synchronize()
    log(f"[analysis] {json.dumps(out)[:3000]}")
    return out


# ---------------------------------------------------------------- phase 19
T19_CLIENTS = 8
T19_LOAD = 64          # (a) bodies from the clients: plan and dense
T19_MSEARCH = 64       # (b) the _msearch whose parent is cancelled
T19_ASYNC = 32         # (c) async searches: plan and dense
T19_TEMPLATES = 64     # (e) _search/template bodies: stored and inline
T19_MTEMPLATES = 32    # (e) the _msearch/template
T19_RANK = 16          # (f) rated requests
T19_SIZE = 100
T19_RPS = 1000         # (d) the background reindex's pace until rethrottled
T19_BATCH = 1000       # (d) its scroll batch
T19_REINDEX = 5000     # (d) its max_docs (an18 holds 10,000: PERF.md 4)
T19_PREFIXES = 8       # (g) _terms_enum prefixes
T19_BURST = 8          # (g) the slow log's burst
T19_MGET = 200         # (d) ids read back from each destination
RANK_METRICS = (
    {"precision": {"k": 10}},
    {"recall": {"k": 20, "relevant_rating_threshold": 2}},
    {"mean_reciprocal_rank": {"k": 10}},
    {"dcg": {"k": 20, "normalize": True}},
    {"expected_reciprocal_rank": {"maximum_relevance": 3, "k": 20}},
)
# the fields that change between two answers of one search
ANSWER_CLOCK = ("took",)


def t19_dense_body(terms, k):
    """A match with ``min_score``: the dense executor, one scoring (a
    contribution-kernel launch) a shard segment."""
    from elasticsearch_tpu_torch.corpus import term_name
    return {"query": {"match": {"title": " ".join(
        term_name(t) for t in terms)}}, "min_score": 1e-6, "size": k}


def same_hits_exactly(a, b, what):
    """Two answers of the port on the card: hits (ids, order, float32
    scores) and totals equal."""
    check(a["hits"]["total"] == b["hits"]["total"],
          f"{what}: totals {a['hits']['total']} vs {b['hits']['total']}")
    check([(h["_id"], h["_score"]) for h in a["hits"]["hits"]]
          == [(h["_id"], h["_score"]) for h in b["hits"]["hits"]],
          f"{what}: ids, order and scores equal")


def np_rank_metric(spec, hits, ratings):
    """The rank-eval metric ``spec`` over ``hits`` (ids in order) and
    ``ratings`` ({id: rating}), in numpy (Elasticsearch's definitions)."""
    (name, p), = spec.items()
    k = p.get("k", 10)
    top = list(hits[:k])
    r = np.array([ratings.get(h, 0) for h in top], np.float64)
    labelled = np.array([h in ratings for h in top], bool)
    thr = p.get("relevant_rating_threshold", 1)
    if name == "precision":
        keep = labelled if p.get("ignore_unlabeled") else np.ones_like(
            labelled)
        n = int(keep.sum())
        return float(((r >= thr) & keep).sum() / n) if n else 0.0
    if name == "recall":
        rel = sum(1 for v in ratings.values() if v >= thr)
        return float((r >= thr).sum() / rel) if rel else 0.0
    if name == "mean_reciprocal_rank":
        at = np.nonzero(r >= thr)[0]
        return float(1.0 / (at[0] + 1)) if len(at) else 0.0
    disc = np.log2(np.arange(len(top)) + 2.0)
    if name == "dcg":
        dcg = float(((2.0 ** r - 1.0) / disc).sum())
        if not p.get("normalize"):
            return dcg
        ideal = np.sort(np.array(list(ratings.values()), np.float64))[::-1][:k]
        idcg = float(((2.0 ** ideal - 1.0)
                      / np.log2(np.arange(len(ideal)) + 2.0)).sum())
        return dcg / idcg if idcg > 0 else 0.0
    if name == "expected_reciprocal_rank":
        stop = (2.0 ** r - 1.0) / 2.0 ** p["maximum_relevance"]
        go_on = np.concatenate([[1.0], np.cumprod(1.0 - stop)[:-1]])
        return float((go_on * stop / np.arange(1, len(top) + 1)).sum())
    raise ValueError(name)


def mapping_fields(props, prefix="", out=None):
    """{field path: type} of a ``_mapping``'s properties: every field
    with a type, each multi-field under ``fields`` as ``path.sub``, an
    object's (or a nested object's) properties under its path; the
    objects themselves are paths, not fields."""
    out = {} if out is None else out
    for name, spec in (props or {}).items():
        path = prefix + name
        if spec.get("type") not in (None, "object", "nested"):
            out[path] = spec["type"]
        for sub, sspec in (spec.get("fields") or {}).items():
            if "type" in sspec:
                out[f"{path}.{sub}"] = sspec["type"]
        if "properties" in spec:
            mapping_fields(spec["properties"], path + ".", out)
    return out


def phase_tasks(node, port, queries, oracles, seed, counters, hbm_log):
    """Tasks and the host search modules on one H100 (module docstring,
    phase 19), on the main node after phase 18."""
    import torch
    from elasticsearch_tpu_torch.corpus import term_name
    from elasticsearch_tpu_torch.search import queries as q_mod
    from elasticsearch_tpu_torch.telemetry.engine import TRACKER
    t_phase = time.time()
    out = {}
    steps = {}
    t_step = [time.time()]
    rng = np.random.default_rng(seed)

    def lap(name):
        now = time.time()
        steps[name] = now - t_step[0]
        t_step[0] = now

    fp = node.fastpath
    tm = node.task_manager
    batcher = node.search_service.plan_batcher
    contrib = counters["gather_bm25_contrib"]

    def kernel_calls():
        _, k = http(port, "GET", "/_kernels")
        return {n: k["kernels"].get(n, {}).get("calls", 0)
                for n in counters}

    k_start = kernel_calls()
    s_start = TRACKER.calls("bm25_dense_scores_sorted")
    c_start = dict(fp.stats)
    for c in counters.values():
        c.launches = 0
    svc = node.indices["bench"]
    reg = fp.register("bench", svc.engine.segments[0], "title", svc.k1,
                      svc.b)
    v2m = [i for i, q in enumerate(queries)
           if lane_of(fp, reg, q, T19_SIZE) == "v2m"]
    check(len(v2m) >= 48, f"v2m queries at size {T19_SIZE}: {len(v2m)}")

    def idle_batcher(what):
        with batcher._lock:
            pending = sum(len(q) for q in batcher._pending.values())
        check(pending == 0 and batcher._lanes_in_flight == 0,
              f"{what}: no plan cohort in flight ({pending} queued, "
              f"{batcher._lanes_in_flight} lanes)")

    def search_tasks():
        st, r = http(port, "GET", "/_tasks?detailed=true")
        check(st == 200, f"GET /_tasks: {r}")
        return list(r["nodes"][node.node_id]["tasks"].values())

    # ---- (a) tasks under load: 8 clients, plan and dense bodies
    load = [plan_body(queries[i], T19_SIZE) if i % 2 == 0
            else t19_dense_body(queries[i], T19_SIZE)
            for i in range(T19_LOAD)]
    started, finished = [0], [0]
    lock = threading.Lock()
    snaps = []
    done_ev = threading.Event()

    def poller():
        while not done_ev.is_set():
            with lock:
                f0 = finished[0]
            _, r = node.rest_controller.dispatch(
                "GET", "/_tasks", {"detailed": "true",
                                   "actions": "indices:data/read/search"},
                None)
            tasks = list(r["nodes"][node.node_id]["tasks"].values())
            with lock:
                s2 = started[0]
            snaps.append((len(tasks), s2 - f0,
                          [t.get("profile_stage") for t in tasks]))
            done_ev.wait(0.002)

    results = [None] * len(load)
    nxt = [0]

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
                if i >= len(load):
                    return
                started[0] += 1
            results[i] = http(port, "POST", "/bench/_search", load[i])
            with lock:
                finished[0] += 1

    th_poll = threading.Thread(target=poller, daemon=True)
    th_poll.start()
    t0 = time.time()
    clients = [threading.Thread(target=client, daemon=True)
               for _ in range(T19_CLIENTS)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(600)
    load_s = time.time() - t0
    done_ev.set()
    th_poll.join(60)
    for i, (st, r) in enumerate(results):
        check(st == 200, f"(a) body {i}: {st} {str(r)[:300]}")
        truth, scores, total = oracles[i]
        check_answer(r, (truth[:T19_SIZE], scores[:T19_SIZE], total),
                     "plan", f"(a) body {i}")
    busy = [s for s in snaps if s[0]]
    check(busy, f"(a) the search tasks were seen in flight ({len(snaps)} "
          f"snapshots)")
    check(all(n <= bound for n, bound, _ in snaps),
          "(a) never more search tasks than requests in flight")
    check(all(st is not None for _, _, stages in snaps for st in stages),
          "(a) every listed search task has a profile stage")
    check(search_tasks() == [], "(a) no task once the traffic stopped")
    st, ns = http(port, "GET", "/_nodes/stats")
    check(ns["nodes"][node.node_id]["tasks"]["current"] == 0,
          f"(a) tasks.current 0: {ns['nodes'][node.node_id]['tasks']}")
    stages = {}
    for _, _, ss in snaps:
        for s in ss:
            stages[s] = stages.get(s, 0) + 1
    out["load"] = dict(bodies=len(load), seconds=load_s,
                       snapshots=len(snaps), busy_snapshots=len(busy),
                       max_tasks=max(n for n, _, _ in snaps),
                       stages_seen=stages)
    log(f"[tasks] (a) {out['load']}")
    lap("a_load")

    # ---- (b) cancellation on the card: a dense body over bench5
    body_b = t19_dense_body(queries[v2m[0]], T19_SIZE)
    l0 = contrib.launches
    st, whole = http(port, "POST", "/bench5/_search", body_b)
    torch.cuda.synchronize()
    big_l = contrib.launches - l0
    check(st == 200 and big_l >= 2,
          f"(b) the whole body: {st}, {big_l} launches")
    orig_scoring = q_mod.bm25_dense_scores_sorted
    first, go = threading.Event(), threading.Event()

    def gated(*args, **kwargs):
        result = orig_scoring(*args, **kwargs)
        if threading.current_thread().name.startswith("async_search-") \
                and not first.is_set():
            first.set()
            go.wait(120)
        return result

    q_mod.bm25_dense_scores_sorted = gated
    try:
        t0 = time.time()
        l0 = contrib.launches
        st, a = http(port, "POST",
                     "/bench5/_async_search?wait_for_completion_timeout=0ms",
                     body_b)
        check(st == 200 and a["is_running"] is True,
              f"(b) submitted, running: {st} {str(a)[:300]}")
        check(first.wait(120), "(b) its first launch")
        st, tl = http(port, "GET", "/_tasks?detailed=true&actions="
                      "indices:data/read/async_search/submit")
        (tid, task), = tl["nodes"][node.node_id]["tasks"].items()
        check(str(task.get("profile_stage")).startswith("score"),
              f"(b) its task in its scoring stage: {task}")
        st, c = http(port, "POST", f"/_tasks/{tid}/_cancel")
        check(st == 200 and c["nodes"][node.node_id]["tasks"][tid][
            "cancelled"] is True, f"(b) cancel: {c}")
    finally:
        go.set()
        q_mod.bm25_dense_scores_sorted = orig_scoring
    st, done = http(port, "GET", f"/_async_search/{a['id']}"
                    f"?wait_for_completion_timeout=120s")
    torch.cuda.synchronize()
    launched = contrib.launches - l0
    cancel_ms = (time.time() - t0) * 1e3
    check(st == 400 and done["error"]["type"] == "task_cancelled_exception"
          and done["is_partial"] is True and "response" not in done,
          f"(b) the cancelled search's answer: {st} {str(done)[:300]}")
    check(1 <= launched < big_l,
          f"(b) launches {launched} < the whole body's {big_l}")
    hbm_agrees(node, "tasks (b) cancel", hbm_log)
    idle_batcher("(b) cancel")
    st, again = http(port, "POST", "/bench5/_search", body_b)
    same_hits_exactly(again, whole, "(b) asked again")
    # the _msearch of 64 whose parent is cancelled after its first child
    # answered: the other children are held until the cancel went out
    m_bodies = [plan_body(queries[i], T19_SIZE) for i in range(T19_MSEARCH)]
    orig_search = node.search_service.search
    entered = [0]
    first_done, m_go = threading.Event(), threading.Event()

    def held(*args, **kwargs):
        # the node's search pool threads (common/threadpool.py)
        if not threading.current_thread().name.startswith(
                "estpu[search]"):
            return orig_search(*args, **kwargs)
        with lock:
            entered[0] += 1
            mine = entered[0]
        if mine == 1:
            r = orig_search(*args, **kwargs)
            first_done.set()
            return r
        m_go.wait(120)
        return orig_search(*args, **kwargs)

    lines = "".join(json.dumps({"index": "bench"}) + "\n" + json.dumps(b)
                    + "\n" for b in m_bodies)
    m_res = {}
    node.search_service.search = held
    try:
        th = threading.Thread(target=lambda: m_res.setdefault(
            "r", http(port, "POST", "/_msearch", lines, ndjson=True)),
            daemon=True)
        th.start()
        check(first_done.wait(120), "(b) the first child answered")
        st, pl = http(port, "GET", "/_tasks?detailed=true&actions="
                      "indices:data/read/msearch")
        (pid, parent), = pl["nodes"][node.node_id]["tasks"].items()
        check(parent["description"] == f"requests[{T19_MSEARCH}]",
              f"(b) the msearch parent: {parent}")
        st, _ = http(port, "POST", f"/_tasks/{pid}/_cancel")
        check(st == 200, "(b) cancel the msearch parent")
    finally:
        m_go.set()
        th.join(300)
        node.search_service.search = orig_search
    st, mr = m_res["r"]
    check(st == 200, f"(b) _msearch: {st}")
    slots = mr["responses"]
    answered = [i for i, s in enumerate(slots) if "error" not in s]
    errors = [s for s in slots if "error" in s]
    banned = sum("parent banned" in s["error"]["reason"] for s in errors)
    check(len(answered) >= 1 and banned >= 1
          and all(s["status"] == 400
                  and s["error"]["type"] == "task_cancelled_exception"
                  for s in errors),
          f"(b) answered {len(answered)}, killed by the ban {banned}, "
          f"every other a 400 task_cancelled_exception")
    for i in answered:
        st, alone = http(port, "POST", "/bench/_search", m_bodies[i])
        same_hits_exactly(slots[i], alone, f"(b) msearch child {i} alone")
    check(search_tasks() == [] and tm.ban_count() == 0,
          "(b) no task and no ban left")
    idle_batcher("(b) msearch")
    out["cancel"] = dict(launches=launched, whole_launches=big_l,
                         cancel_ms=cancel_ms,
                         msearch=dict(bodies=T19_MSEARCH,
                                      answered=len(answered),
                                      killed_by_ban=banned,
                                      cancelled_running=len(errors) - banned))
    log(f"[tasks] (b) {out['cancel']}")
    lap("b_cancel")

    # ---- (c) async search: 32 bodies submitted with a 0 wait
    a_bodies = [plan_body(queries[i], T19_SIZE) if i % 2 == 0
                else t19_dense_body(queries[i], T19_SIZE)
                for i in range(T19_ASYNC)]
    t0 = time.time()
    subs = [http(port, "POST",
                 "/bench/_async_search?wait_for_completion_timeout=0ms", b)
            for b in a_bodies]
    check(all(st == 200 for st, _ in subs), "(c) submitted")
    running = sum(1 for _, r in subs if r["is_running"])
    polled = [http(port, "GET", f"/_async_search/{r['id']}"
                   f"?wait_for_completion_timeout=120s") for _, r in subs]
    async_s = time.time() - t0
    for i, ((st, r), b) in enumerate(zip(polled, a_bodies)):
        check(st == 200 and r["is_running"] is False
              and r["is_partial"] is False, f"(c) async {i}: {st} "
              f"{str(r)[:300]}")
        st, sync = http(port, "POST", "/bench/_search", b)
        same_hits_exactly(r["response"], sync, f"(c) async {i}")
    # a DELETE of a running one: held in its search until it is gone
    d_go = threading.Event()

    def held_async(*args, **kwargs):
        if threading.current_thread().name.startswith("async_search-"):
            d_go.wait(120)
        return orig_search(*args, **kwargs)

    node.search_service.search = held_async
    try:
        st, a = http(port, "POST",
                     "/bench/_async_search?wait_for_completion_timeout=0ms",
                     a_bodies[0])
        check(st == 200 and a["is_running"] is True, "(c) held, running")
        st, _ = http(port, "DELETE", f"/_async_search/{a['id']}")
        check(st == 200, "(c) DELETE a running async search")
        st, g = http(port, "GET", f"/_async_search/{a['id']}")
        check(st == 404, f"(c) a deleted search is a 404: {st}")
    finally:
        d_go.set()
        node.search_service.search = orig_search
    wait_ev = threading.Event()
    for _ in range(12000):
        if node.background_threads() == 0:
            break
        wait_ev.wait(0.01)
    check(node.background_threads() == 0 and search_tasks() == [],
          "(c) the deleted search's thread ended, no task left")
    out["async"] = dict(bodies=T19_ASYNC, running_at_submit=running,
                        seconds=async_s)
    log(f"[tasks] (c) {out['async']}")
    lap("c_async")

    # ---- (d) background reindex of an18, rethrottled while it runs
    src_n = min(T19_REINDEX, http(port, "GET", "/an18/_count")[1]["count"])
    job = {"source": {"index": "an18", "size": T19_BATCH},
           "max_docs": T19_REINDEX}
    t0 = time.time()
    st, r = http(port, "POST", f"/_reindex?wait_for_completion=false"
                 f"&requests_per_second={T19_RPS}",
                 dict(job, dest={"index": "an19_bg"}))
    check(st == 200 and "task" in r, f"(d) background reindex: {r}")
    rid = r["task"]
    st, rt = http(port, "POST",
                  f"/_reindex/{rid}/_rethrottle?requests_per_second=-1")
    check(st == 200 and rid in rt["nodes"][node.node_id]["tasks"],
          f"(d) _rethrottle of the running job: {st} {str(rt)[:300]}")
    polls = 0
    while True:
        polls += 1
        st, done = http(port, "GET", f"/_tasks/{rid}")
        check(st == 200, f"(d) GET /_tasks/{rid}: {st} {done}")
        if done["completed"]:
            break
        threading.Event().wait(0.05)
    bg_s = time.time() - t0
    t0 = time.time()
    st, sync = http(port, "POST", "/_reindex",
                    dict(job, dest={"index": "an19_fg"}))
    fg_s = time.time() - t0
    keys = ("total", "created", "updated", "deleted", "batches", "noops",
            "version_conflicts", "failures")
    got = done["response"]
    check({k: got[k] for k in keys} == {k: sync[k] for k in keys}
          and got["total"] == src_n,
          f"(d) the background counts equal the synchronous ones: "
          f"{ {k: got[k] for k in keys} } vs { {k: sync[k] for k in keys} }")
    http(port, "POST", "/an19_bg,an19_fg/_refresh")
    c_bg = http(port, "GET", "/an19_bg/_count")[1]["count"]
    c_fg = http(port, "GET", "/an19_fg/_count")[1]["count"]
    check(c_bg == c_fg == src_n, f"(d) _count {c_bg} {c_fg} vs {src_n}")
    ids = [str(i) for i in rng.choice(
        [int(x) for s in node.indices["an18"].engine.segments
         for x, live in zip(s.stored.ids, s.live) if live],
        size=T19_MGET, replace=False)]
    mg = {name: http(port, "POST", f"/{name}/_mget", {"ids": ids})[1]
          for name in ("an18", "an19_bg", "an19_fg")}
    srcs = {name: [(d["found"], d.get("_source")) for d in m["docs"]]
            for name, m in mg.items()}
    copied = [s for s in srcs["an19_bg"] if s[0]]
    check(srcs["an19_bg"] == srcs["an19_fg"] and copied
          and all(f for f, _ in srcs["an18"])
          and all(b == a for b, a in zip(srcs["an19_bg"], srcs["an18"])
                  if b[0]),
          "(d) _mget of the ids equal on both destinations, each copied "
          "document equal to its source")
    for name in ("an19_bg", "an19_fg"):
        check(http(port, "DELETE", f"/{name}")[0] == 200, f"delete {name}")
    out["reindex"] = dict(docs=src_n, background_s=bg_s, sync_s=fg_s,
                          polls=polls, batches=got["batches"],
                          mget_found=len(copied))
    log(f"[tasks] (d) {out['reindex']}")
    lap("d_reindex")

    # ---- (e) search templates, stored and inline
    st, _ = http(port, "PUT", "/_scripts/tpl19", {"script": {
        "lang": "mustache",
        "source": '{"query": {"match": {"title": "{{q}}"}}, '
                  '"size": {{size}} }'}})
    check(st == 200, "(e) the stored template")

    def text(i):
        return " ".join(term_name(t) for t in queries[i])

    specs = []
    for j in range(T19_TEMPLATES):
        i = v2m[j % len(v2m)]
        if j % 2 == 0:
            specs.append({"id": "tpl19", "params": {"q": text(i),
                                                     "size": T19_SIZE}})
        else:
            specs.append({"source": {"query": {"bool": {
                "must": [{"match": {"title": "{{q}}"}}],
                "should": [{"match": {"title": "{{s}}"}}]}},
                "size": "{{size}}"},
                "params": {"q": text(i), "s": text(v2m[j - 1]),
                           "size": T19_SIZE}})
    t0 = time.time()
    tpl_answers = []
    for j, spec in enumerate(specs):
        st, t = http(port, "POST", "/bench/_search/template", spec)
        check(st == 200, f"(e) template {j}: {st} {str(t)[:300]}")
        st, rnd = http(port, "POST", "/_render/template", spec)
        st, s = http(port, "POST", "/bench/_search", rnd["template_output"])
        same_hits_exactly(t, s, f"(e) template {j} against its render")
        tpl_answers.append(t)
    tpl_s = time.time() - t0
    lines = "".join(json.dumps({"index": "bench"}) + "\n" + json.dumps(sp)
                    + "\n" for sp in specs[:T19_MTEMPLATES])
    st, mt = http(port, "POST", "/_msearch/template", lines, ndjson=True)
    check(st == 200 and len(mt["responses"]) == T19_MTEMPLATES,
          f"(e) _msearch/template: {st}")
    for j, r in enumerate(mt["responses"]):
        same_hits_exactly(r, tpl_answers[j], f"(e) msearch template {j}")
    http(port, "DELETE", "/_scripts/tpl19")
    out["templates"] = dict(bodies=len(specs), seconds=tpl_s,
                            msearch=T19_MTEMPLATES)
    log(f"[tasks] (e) {out['templates']}")
    lap("e_templates")

    # ---- (f) _rank_eval: ratings from the float64 oracle
    rated = []
    for i in range(T19_RANK):
        truth = oracles[i][0]
        ratings = {str(int(d)): (3 if r < 10 else 2 if r < 30 else 1)
                   for r, d in enumerate(truth[:100])}
        rated.append((i, ratings))
    requests = [{"id": f"q{i}", "request": plan_body(queries[i], T19_SIZE),
                 "ratings": [{"_index": "bench", "_id": d, "rating": v}
                             for d, v in ratings.items()]}
                for i, ratings in rated]
    own = {}
    for i, _ in rated:
        st, r = http(port, "POST", "/bench/_search",
                     plan_body(queries[i], T19_SIZE))
        own[f"q{i}"] = [h["_id"] for h in r["hits"]["hits"]]
    t0 = time.time()
    rank = {}
    for spec in RANK_METRICS:
        st, r = http(port, "POST", "/bench/_rank_eval",
                     {"requests": requests, "metric": spec})
        (name, _), = spec.items()
        check(st == 200, f"(f) {name}: {st} {str(r)[:300]}")
        per = []
        for (i, ratings), req in zip(rated, requests):
            d = r["details"][req["id"]]
            check([h["hit"]["_id"] for h in d["hits"]] == own[req["id"]],
                  f"(f) {name} {req['id']}: the hits of its _search")
            want = np_rank_metric(spec, own[req["id"]], ratings)
            check(np.isclose(d["metric_score"], want, rtol=1e-12, atol=0),
                  f"(f) {name} {req['id']}: {d['metric_score']} vs {want}")
            per.append(want)
        check(np.isclose(r["metric_score"], np.mean(per), rtol=1e-12,
                         atol=0), f"(f) {name}: {r['metric_score']} vs "
              f"{np.mean(per)}")
        rank[name] = r["metric_score"]
    out["rank_eval"] = dict(requests=T19_RANK, metrics=rank,
                            seconds=time.time() - t0)
    log(f"[tasks] (f) {out['rank_eval']}")
    lap("f_rank_eval")

    # ---- (g) the utility routes, _cat, _stats, the slow log (every
    # index refreshed first: `_count` sees what the segments hold)
    check(http(port, "POST", "/_all/_refresh")[0] == 200, "(g) _refresh")
    pf = node.indices["bench"].engine.segments[0].postings["title"]
    dictionary = np.sort(np.asarray(pf.terms, dtype=object).astype(str))
    prefixes = sorted({term_name(int(t))[:-2] for t in rng.choice(
        len(pf.terms), size=T19_PREFIXES, replace=False)})
    for p in prefixes:
        want = dictionary[np.char.startswith(dictionary, p)][:50].tolist()
        st, r = http(port, "POST", "/bench/_terms_enum",
                     {"field": "title", "string": p, "size": 50})
        check(st == 200 and r["terms"] == want,
              f"(g) _terms_enum {p!r}: {r.get('terms', r)[:5]} vs "
              f"{want[:5]}")
    names = sorted(node.indices)
    st, maps = http(port, "GET", "/_all/_mapping")
    for name in names:
        st, fc = http(port, "GET", f"/{name}/_field_caps?fields=*")
        caps = {f: sorted(types) for f, types in fc["fields"].items()}
        want = {f: [t] for f, t in mapping_fields(
            maps[name]["mappings"].get("properties")).items()}
        diff = sorted(set(caps) ^ set(want)) + sorted(
            f for f in set(caps) & set(want) if caps[f] != want[f])
        check(not diff, f"(g) _field_caps of {name} agrees with its "
              f"_mapping: {[(f, caps.get(f), want.get(f)) for f in diff]}")
    st, fc_all = http(port, "GET", "/_field_caps?fields=*")
    check(st == 200 and fc_all["indices"] == sorted(
        n for n in names if not node.indices[n].is_closed),
        "(g) _field_caps over every index")
    valid = [{"match": {"title": "a b"}}, {"bool": {"must": [
        {"term": {"title": "x"}}], "filter": [{"range": {"v": {"gte": 1}}}]}},
        {"match_all": {}}, {"range": {"v": {"lt": 3}}}]
    invalid = [{"no_such_query": {}}, {"bool": {"must": [{"nope": {}}]}},
               {"match": {}}]
    for q in valid + invalid:
        st, r = http(port, "POST", "/bench/_validate/query", {"query": q})
        check(st == 200 and r["valid"] is (q in valid),
              f"(g) _validate/query {q}: {r}")
    md = node.metadata_service
    st, res = http(port, "GET", "/_resolve/index/*")
    check([i["name"] for i in res["indices"]] == names
          and {a["name"]: a["indices"] for a in res["aliases"]}
          == {a: sorted(m) for a, m in md.aliases.items()}
          and [d["name"] for d in res["data_streams"]]
          == sorted(md.data_streams),
          "(g) _resolve/index agrees with the metadata")
    # the front answers `_cat` as text (http_h decodes it)
    st, cat_i = http_h(port, "GET", "/_cat/indices")[::2]
    st, cat_s = http_h(port, "GET", "/_cat/segments")[::2]
    st, cat_sh = http_h(port, "GET", "/_cat/shards")[::2]
    st, cat_c = http_h(port, "GET", "/_cat/count")[::2]
    st, stats = http(port, "GET", "/_stats")
    rows = {ln.split()[2]: ln.split() for ln in cat_i.splitlines()}
    seg_rows = [ln.split() for ln in cat_s.splitlines()]
    total = 0
    for name in names:
        isvc = node.indices[name]
        segs = [s for sh in isvc.shards for s in sh.segments]
        deleted = sum(s.n_docs - int(np.asarray(s.live).sum()) for s in segs)
        if isvc.is_closed:
            count = isvc.stats()["docs"]["count"]
        else:
            st, c = http(port, "GET", f"/{name}/_count")
            check(st == 200, f"(g) {name}/_count: {c}")
            count = c["count"]
        total += count
        check(rows[name][5:] == [str(count), str(deleted)]
              and rows[name][3] == str(isvc.num_shards),
              f"(g) _cat/indices {name}: {rows[name]} vs {count} "
              f"{deleted}")
        check(stats["indices"][name]["docs"]["count"] == count,
              f"(g) _stats {name}")
        mine = [r for r in seg_rows if r[0] == name]
        check([(r[4], int(r[5]), int(r[6])) for r in mine]
              == [(s.name, s.n_docs, int(np.asarray(s.live).sum()))
                  for s in segs], f"(g) _cat/segments {name}")
    check(stats["_all"]["primaries"]["docs"]["count"] == total
          and int(cat_c.split()[1]) == total
          and len(cat_sh.splitlines())
          == sum(node.indices[n].num_shards for n in names),
          f"(g) _stats, _cat/count and _cat/shards over every index: "
          f"{total}")
    # the slow log: a 0ms threshold on bench, a burst of plan, dense and
    # fast bodies through the REST layer
    st, _ = http(port, "PUT", "/bench/_settings",
                 {"index.search.slowlog.threshold.query.warn": "0ms"})
    recent = node.search_service.slowlog_recent
    n0 = len(recent)
    burst = [plan_body(queries[v2m[i]], T19_SIZE) if i % 3 == 0
             else t19_dense_body(queries[v2m[i]], T19_SIZE) if i % 3 == 1
             else match_body(queries[v2m[i]], T19_SIZE, source=True)
             for i in range(T19_BURST)]
    for b in burst:
        check(http(port, "POST", "/bench/_search", b)[0] == 200,
              "(g) the burst")
    http(port, "PUT", "/bench/_settings",
         {"index.search.slowlog.threshold.query.warn": "-1"})
    entries = recent[n0:]
    check(len(entries) == T19_BURST
          and all(e["index"] == "bench" and e.get("slowest_stage")
                  and e.get("trace.id") for e in entries),
          f"(g) every search of the burst in the slow log with its "
          f"slowest stage: {entries[:2]}")
    out["utility"] = dict(prefixes=len(prefixes), indices=len(names),
                          docs=total, validate=len(valid) + len(invalid),
                          slowlog=[e["slowest_stage"] for e in entries])
    log(f"[tasks] (g) {str(out['utility'])[:2000]}")
    lap("g_utility")

    # ---- the kernels' counts, the breaker
    hbm_agrees(node, "tasks", hbm_log)
    idle_batcher("tasks")
    check(search_tasks() == [] and node.background_threads() == 0,
          "no task and no background thread left")
    torch.cuda.synchronize()
    k_end = kernel_calls()
    calls = {n: k_end[n] - k_start[n] for n in counters}
    launches = {n: c.launches for n, c in counters.items()}
    scorings = TRACKER.calls("bm25_dense_scores_sorted") - s_start
    cohorts = fp.stats["cohorts"] - c_start["cohorts"]
    cohorts_v2m = fp.stats["cohorts_v2m"] - c_start["cohorts_v2m"]
    check(cohorts == cohorts_v2m > 0 and scorings > 0
          and launches["gather_bm25_contrib"] == scorings + cohorts
          and launches["merge_sorted_slots"] == cohorts_v2m
          and calls == launches,
          f"the contribution kernel once a dense scoring ({scorings}) and "
          f"once a fast cohort, the merge once a v2m cohort "
          f"({cohorts_v2m} of {cohorts}), /_kernels agrees: {launches} vs "
          f"{calls}")
    out["launches"] = launches
    out["kernels_calls"] = calls
    out["dense_scorings"] = scorings
    out["fast_cohorts"] = cohorts
    out["steps_s"] = steps
    out["phase_s"] = time.time() - t_phase
    log(f"[tasks] {json.dumps(out)[:3000]}")
    return out



# ---------------------------------------------------------------- phase 20
T20_CLIENTS = 8
T20_BODIES = 16        # (a) bodies of each kind a tenant sends
T20_TRACED = 32        # (b) traced plan and dense bodies, one at a time
T20_FAST_COHORT = 8    # (b) traced fast bodies sent together (printed)
T20_CLASS = 8          # (c) requests of each class
T20_MSEARCH = 16       # (d) bodies of the _msearch sent as JSON
T20_LAT = 100          # (g) dense searches timed with and without headers
T20_LAT_CLIENTS = 2    # ... from as many Python clients as fallback workers
T20_MICRO = 5_000      # host micro-benchmarks: iterations of each
T20_SIZE = 10
T20_BREAKER_DOCS = 200_000   # (f) the second node's index
T20_TENANTS = ("t20-header", "t20-body", "t20-logs")


def http_h(port: int, method: str, path: str, body=None, headers=None,
           data=None, ctype="application/json"):
    """(status, response headers, payload) of one request with extra
    ``headers``; ``data`` sends raw bytes as ``ctype``. The payload is
    JSON, CBOR (``Content-Type: application/cbor``) or text."""
    from elasticsearch_tpu_torch.common import cbor
    hdrs = dict(headers or {})
    if data is None and body is not None:
        data = json.dumps(body).encode()
    if data is not None:
        hdrs.setdefault("Content-Type", ctype)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data,
                                 hdrs, method=method)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            status, rh, raw = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        status, rh, raw = e.code, dict(e.headers), e.read()
    kind = rh.get("Content-Type", "")
    if kind.startswith("application/cbor"):
        payload = cbor.loads(raw)
    elif kind.startswith("text/plain"):
        payload = raw.decode()
    else:
        payload = json.loads(raw) if raw else None
    return status, rh, payload


def tenant_rows(port):
    st, r = http(port, "GET", "/_tenants/stats")
    check(st == 200, f"GET /_tenants/stats: {r}")
    return r["tenants"]


def class_rows(port):
    st, r = http(port, "GET", "/_workload/stats")
    check(st == 200, f"GET /_workload/stats: {r}")
    return r["classes"]


def node_metrics(port, node_id, history=False):
    st, r = http(port, "GET", "/_nodes/stats"
                 + ("?history=true" if history else ""))
    check(st == 200, f"GET /_nodes/stats: {str(r)[:300]}")
    return r["nodes"][node_id]


def request_breaker_used(node):
    return node.breaker_service.get_breaker("request").used


def micro_us(fn, n):
    """Host microseconds a call of ``fn`` over ``n`` calls."""
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def phase_telemetry(node, port, corpus, queries, oracles, seed, counters,
                    hbm_log):
    """Node telemetry on one H100 (module docstring, phase 20), over HTTP
    through the fallback workers, on the main node after phase 19.
    ``corpus``: the "bench" corpus, whose first 200,000 docs make the
    breaker node's index."""
    import torch
    from elasticsearch_tpu_torch.corpus import (bench_cat, exact_topk,
                                                segment_from_corpus,
                                                shard_corpus, term_name)
    from elasticsearch_tpu_torch.common import cbor
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.search.batching import PlanBatcher
    from elasticsearch_tpu_torch.telemetry import context as telectx
    t_phase = time.time()
    out = {}
    steps = {}
    t_step = [time.time()]

    def lap(name):
        now = time.time()
        steps[name] = now - t_step[0]
        t_step[0] = now

    fp = node.fastpath
    tele = node.telemetry
    batcher = node.search_service.plan_batcher
    contrib = counters["gather_bm25_contrib"]
    c_start = dict(fp.stats)
    for c in counters.values():
        c.launches = 0
    svc = node.indices["bench"]
    reg = fp.register("bench", svc.engine.segments[0], "title", svc.k1,
                      svc.b)
    v2m = [i for i, q in enumerate(queries)
           if lane_of(fp, reg, q, T20_SIZE) == "v2m"]
    check(len(v2m) >= 3 * T20_BODIES,
          f"v2m queries at size {T20_SIZE}: {len(v2m)}")
    # (f)'s index, the bench corpus's first docs with their own
    # statistics, cut and laid out while (a)-(e) wait on HTTP
    n_b = T20_BREAKER_DOCS
    brk = {}

    def cut_breaker_index():
        brk["corpus"] = shard_corpus(corpus, np.arange(n_b))
        brk["segment"] = segment_from_corpus(
            brk["corpus"], name="brk0",
            keywords={"cat": dict(zip(("ords", "terms"), bench_cat(n_b)))})

    th_brk = threading.Thread(target=cut_breaker_index, daemon=True)
    th_brk.start()
    # the registry `_nodes/stats` renders, read here at the start ((g)
    # reads the route)
    m0 = tele.metrics.to_dict()
    searches0 = m0.get("search.requests", {"value": 0})["value"]
    lat0 = m0.get("search.latency", {"count": 0})["count"]
    sent = [0]          # searches sent to the main node in this phase

    def breaker_zero(what):
        check(request_breaker_used(node) == 0,
              f"{what}: the request breaker back to 0 "
              f"({request_breaker_used(node)} B)")

    # ---- (a) three tenants x 16 bodies of each kind, 8 clients
    kinds = []
    for t_i, tenant in enumerate(T20_TENANTS):
        for j in range(T20_BODIES):
            q = queries[v2m[t_i * T20_BODIES + j]]
            kinds += [(tenant, "plan", plan_body(q, T20_SIZE)),
                      (tenant, "dense", t19_dense_body(q, T20_SIZE)),
                      (tenant, "fast", match_body(q, T20_SIZE,
                                                  source=True))]

    def target(tenant):
        return "logs" if tenant == "t20-logs" else "bench"

    def tagged(tenant, body):
        if tenant == "t20-body":
            return dict(body, tenant=tenant), {}
        if tenant == "t20-header":
            return body, {"X-Tenant-Id": tenant}
        return body, {}

    def drive_all(reqs):
        res = [None] * len(reqs)
        nxt = [0]
        lock = threading.Lock()

        def client():
            while True:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                if i >= len(reqs):
                    return
                res[i] = http_h(port, "POST", *reqs[i])

        ths = [threading.Thread(target=client, daemon=True)
               for _ in range(T20_CLIENTS)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(600)
        return res

    # the untagged answers first ("logs" has no tenant default yet)
    plain = drive_all([(f"/{target(t)}/_search", b, None)
                       for t, _, b in kinds])
    sent[0] += len(kinds)
    lap("a_untagged")
    st, r = http(port, "PUT", "/logs/_settings",
                 {"index.tenant.default": "t20-logs"})
    check(st == 200, f"PUT /logs/_settings index.tenant.default: {r}")
    rows0 = tenant_rows(port)
    entered = Counter()
    entered_lock = threading.Lock()
    orig_execute = batcher.execute

    def counting_execute(bp, ctx, k, k1, b, after_score=None):
        if not bp.empty and PlanBatcher._eligible(bp, after_score):
            with entered_lock:
                entered[telectx.current_tenant()] += 1
        return orig_execute(bp, ctx, k, k1, b, after_score)

    fr_total0 = tele.flight.aggregates()["ring"]["recorded_total"]
    t0_ns = tele.flight._now_ns()
    batcher.execute = counting_execute
    try:
        reqs = []
        for t, _, b in kinds:
            body, headers = tagged(t, b)
            reqs.append((f"/{target(t)}/_search", body, headers))
        t0 = time.time()
        got = drive_all(reqs)
        load_s = time.time() - t0
    finally:
        batcher.execute = orig_execute
    sent[0] += len(kinds)
    fr_total1 = tele.flight.aggregates()["ring"]["recorded_total"]
    for i, ((st, _, r), (st0, _, r0)) in enumerate(zip(got, plain)):
        check(st == 200 and st0 == 200,
              f"(a) body {i} ({kinds[i][:2]}): {st} {str(r)[:200]}")
        same_hits_exactly(r, r0, f"(a) body {i} {kinds[i][:2]} tagged vs "
                                 f"untagged")
    rows1 = tenant_rows(port)
    per_tenant = {}
    for tenant in T20_TENANTS:
        row = rows1[tenant]
        d0 = rows0.get(tenant, {}).get("search", {}).get("count", 0)
        count = row["search"]["count"] - d0
        slots = row["device"]["cohort_slots"] - rows0.get(tenant, {}).get(
            "device", {}).get("cohort_slots", 0)
        check(count == 3 * T20_BODIES,
              f"(a) {tenant}: search count {count} = bodies sent "
              f"{3 * T20_BODIES}")
        check(slots == entered[tenant],
              f"(a) {tenant}: cohort slots {slots} = its bodies that "
              f"entered the PlanBatcher {entered[tenant]}")
        per_tenant[tenant] = dict(searches=count, cohort_slots=slots,
                                  plan_entries=entered[tenant],
                                  launch_ms=row["device"]["launch_ms"],
                                  p50_ms=row["search"]["latency"]["p50_ms"])
    check(fr_total1 - fr_total0 <= tele.flight.capacity,
          f"(a) the flight ring held the phase's events "
          f"({fr_total1 - fr_total0})")
    ring = tele.flight.events(kind="launch", since_ns=t0_ns, limit=1 << 20)
    flight_ms = sum(e["dispatch_ns"] for e in ring) / 1e6
    rows_ms = sum(rows1[t]["device"]["launch_ms"]
                  - rows0.get(t, {}).get("device", {}).get("launch_ms", 0.0)
                  for t in rows1)
    check(abs(rows_ms - flight_ms) <= 1e-3 * (len(rows1) + 1) * 2,
          f"(a) the tenant rows' launch ms ({rows_ms:.3f}) = the flight "
          f"recorder's launch ms over the load ({flight_ms:.3f})")
    st, cat = http_h(port, "GET", "/_cat/tenants")[::2]
    cat_rows = {ln.split()[0]: ln.split() for ln in cat.splitlines()[1:]}
    check(all(int(cat_rows[t][1]) == rows1[t]["search"]["count"]
              for t in T20_TENANTS),
          f"(a) _cat/tenants agrees with _tenants/stats: {cat[:400]}")
    out["tenants"] = dict(bodies=len(kinds), clients=T20_CLIENTS,
                          seconds=load_s, rows=per_tenant,
                          launch_ms_rows=rows_ms,
                          launch_ms_flight=flight_ms,
                          default_launch_ms=rows1["_default"]["device"][
                              "launch_ms"] - rows0.get("_default", {}).get(
                              "device", {}).get("launch_ms", 0.0))
    breaker_zero("(a)")
    log(f"[telemetry] (a) {out['tenants']}")
    lap("a_tenants")

    # ---- (b) traced plan and dense bodies, one at a time
    traced = []
    for i in range(T20_TRACED):
        q = queries[v2m[i]]
        index = "bench" if i % 2 == 0 else "bench5"
        body = plan_body(q, T20_SIZE) if i % 4 < 2 else \
            t19_dense_body(q, T20_SIZE)
        traced.append((index, body, f"t20-trace-{seed}-{i}"))
    spans_seen = Counter()
    events_seen = Counter()
    for index, body, trace in traced:
        l0 = contrib.launches
        st, h, r = http_h(port, "POST", f"/{index}/_search", body,
                          {"trace.id": trace})
        torch.cuda.synchronize()
        grew = contrib.launches - l0
        check(st == 200 and h.get("trace.id") == trace,
              f"(b) {index} echoes its trace.id: {st} {h.get('trace.id')}")
        st, t = http(port, "GET", f"/_traces/{trace}")
        check(st == 200, f"(b) GET /_traces/{trace}: {t}")
        roots = [s for s in t["tree"]]
        check([s["name"] for s in roots] == ["rest.search"],
              f"(b) one rest.search root: {[s['name'] for s in roots]}")
        children = [c["name"] for c in roots[0]["children"]]
        shards = [c for c in children if c.startswith(f"shard[{index}]")]
        check(len(shards) == (SHARDS if index == "bench5" else 1)
              and children[-1] == "fetch" and len(children)
              == len(shards) + 1,
              f"(b) {index}: its shard spans and its fetch span under the "
              f"root: {children}")
        st, w = http(port, "GET", f"/_flight_recorder/waterfall/{trace}")
        check(st == 200 and "unattached_events" not in w,
              f"(b) the waterfall of {trace}")
        evs = []

        def walk(span):
            evs.extend(span["events"])
            for c in span["children"]:
                walk(c)
        for root in w["waterfall"]:
            walk(root)
        evs.sort(key=lambda e: (e["t_ns"], e["seq"]))
        mine = tele.flight.events_for_trace(trace)
        check(evs == mine and w["event_count"] == len(mine),
              f"(b) the waterfall lists exactly the request's launches "
              f"and readbacks ({len(evs)} vs {len(mine)})")
        n_contrib = sum(e.get("kernel") == "gather_bm25_contrib"
                        for e in evs)
        check(n_contrib == grew,
              f"(b) {trace}: its contribution-kernel events {n_contrib} = "
              f"the kernel's launches across the request {grew}")
        spans_seen[len(t["spans"])] += 1
        events_seen[len(evs)] += 1
    sent[0] += len(traced)
    # a fast cohort of traced _source: true bodies sent together: its
    # launches are recorded under the trace of its first caller (printed)
    fast_traces = [f"t20-fast-{seed}-{i}" for i in range(T20_FAST_COHORT)]
    fbodies = [match_body(queries[v2m[i]], T20_SIZE, source=True)
               for i in range(T20_FAST_COHORT)]
    c0 = fp.stats["cohorts"]
    res = [None] * T20_FAST_COHORT
    ths = [threading.Thread(target=lambda i=i: res.__setitem__(
        i, http_h(port, "POST", "/bench/_search", fbodies[i],
                  {"trace.id": fast_traces[i]}))) for i in
        range(T20_FAST_COHORT)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(600)
    sent[0] += T20_FAST_COHORT
    check(all(r[0] == 200 and r[1].get("trace.id") == tr
              for r, tr in zip(res, fast_traces)),
          "(b) the fast bodies echo their trace ids")
    fast_attr = {tr: [e.get("kernel") or e.get("site") for e in
                      tele.flight.events_for_trace(tr)]
                 for tr in fast_traces}
    out["traces"] = dict(
        bodies=len(traced), spans=dict(spans_seen),
        events=dict(events_seen),
        fast_cohorts=fp.stats["cohorts"] - c0,
        fast_events_by_trace={k: len(v) for k, v in fast_attr.items()},
        fast_attribution=("a fast cohort's launches and readback are "
                          "recorded under its first Python caller's "
                          "trace; the other callers' traces hold none"))
    breaker_zero("(b)")
    log(f"[telemetry] (b) {out['traces']}")
    lap("b_traces")

    # ---- (c) X-Workload-Class against classification
    cls0 = class_rows(port)
    http(port, "PUT", "/tele20", {"mappings": {"properties": {
        "title": {"type": "text"}}}})
    sent_cls = Counter()
    for i in range(T20_CLASS):
        q = queries[v2m[i]]
        st, _, r = http_h(port, "POST", "/bench/_search",
                          plan_body(q, 10))
        check(st == 200, f"(c) interactive: {r}")
        sent_cls["interactive"] += 1
        st, _, r = http_h(port, "POST", "/bench/_search", plan_body(q, 10),
                          {"X-Workload-Class": "t20-canary"})
        check(st == 200, f"(c) canary: {r}")
        sent_cls["t20-canary"] += 1
        st, _, r = http_h(port, "POST", "/bench/_search?scroll=1m",
                          plan_body(q, 10))
        check(st == 200 and r.get("_scroll_id"), f"(c) scroll: {r}")
        http(port, "DELETE", "/_search/scroll",
             {"scroll_id": r["_scroll_id"]})
        sent_cls["scroll"] += 1
        st, _, r = http_h(port, "POST", "/bench/_async_search"
                          "?wait_for_completion_timeout=60s",
                          t19_dense_body(q, 10))
        check(st == 200 and not r["is_running"]
              and r["search.class"] == "async", f"(c) async: {r}")
        sent_cls["async"] += 1
    bulk = "".join(json.dumps({"index": {"_id": str(i)}}) + "\n"
                   + json.dumps({"title": f"telemetry doc {i}"}) + "\n"
                   for i in range(64))
    st, r = http(port, "POST", "/tele20/_bulk?refresh=true", bulk,
                 ndjson=True)
    check(st == 200 and not r["errors"], f"(c) bulk: {str(r)[:200]}")
    sent[0] += sum(sent_cls.values())
    cls1 = class_rows(port)
    got_cls = {c: cls1[c]["search"]["count"] - cls0.get(c, {}).get(
        "search", {}).get("count", 0) for c in sent_cls}
    check(got_cls == dict(sent_cls),
          f"(c) _workload/stats counts as sent: {got_cls} vs "
          f"{dict(sent_cls)}")
    bulk_bytes = cls1["bulk"]["indexing"]["bytes"] - cls0.get(
        "bulk", {}).get("indexing", {}).get("bytes", 0)
    check(bulk_bytes == len(bulk.encode()),
          f"(c) the bulk class charged the bulk's bytes: {bulk_bytes} vs "
          f"{len(bulk.encode())}")
    st, catw = http_h(port, "GET", "/_cat/workload")[::2]
    check(st == 200 and "t20-canary" in catw, "(c) _cat/workload")
    out["workload"] = dict(sent=dict(sent_cls), bulk_bytes=bulk_bytes)
    breaker_zero("(c)")
    log(f"[telemetry] (c) {out['workload']}")
    lap("c_workload")

    # ---- (d) CBOR both ways; _msearch sent as JSON
    q = queries[v2m[0]]
    one_each = [plan_body(q, T20_SIZE), t19_dense_body(q, T20_SIZE),
                match_body(q, T20_SIZE, source=True)]
    for body in one_each:
        st, _, js = http_h(port, "POST", "/bench/_search", body)
        st2, h2, cb = http_h(port, "POST", "/bench/_search",
                             data=cbor.dumps(body),
                             ctype="application/cbor",
                             headers={"Accept": "application/cbor"})
        check(st == st2 == 200
              and h2.get("Content-Type", "").startswith("application/cbor"),
              f"(d) CBOR {body}: {st} {st2} {h2.get('Content-Type')}")
        js.pop("took")
        cb.pop("took")
        check(js == cb, f"(d) the CBOR answer decodes equal to the JSON "
                        f"answer: {body}")
    sent[0] += 2 * len(one_each)
    st, _, bad = http_h(port, "POST", "/bench/_search",
                        data=b"\xff\xfe\x00", ctype="application/cbor")
    check(st == 400 and bad["error"]["type"] == "parsing_exception",
          f"(d) a bad CBOR body: {st} {bad}")
    lines = []
    for i in range(T20_MSEARCH):
        qq = queries[v2m[i]]
        lines += [json.dumps({"index": "bench"}),
                  json.dumps(plan_body(qq, 10) if i % 2 == 0
                             else t19_dense_body(qq, 10))]
    text = ("\n".join(lines) + "\n").encode()
    answers = {}
    for ctype in ("application/json", "application/x-ndjson"):
        st, _, r = http_h(port, "POST", "/_msearch", data=text, ctype=ctype)
        check(st == 200 and len(r["responses"]) == T20_MSEARCH,
              f"(d) _msearch as {ctype}: {st} {str(r)[:300]}")
        answers[ctype] = r["responses"]
    for a, b in zip(answers["application/json"],
                    answers["application/x-ndjson"]):
        same_hits_exactly(a, b, "(d) _msearch as JSON vs as x-ndjson")
    sent[0] += 2 * T20_MSEARCH
    out["cbor_msearch"] = dict(cbor_bodies=len(one_each),
                               msearch=T20_MSEARCH)
    breaker_zero("(d)")
    log(f"[telemetry] (d) {out['cbor_msearch']}")
    lap("d_cbor_msearch")

    # ---- (e) the ip filter on a second node
    refused = {}
    for rule in ({"deny": "127.0.0.0/8"}, {"allow": "10.7.0.0/16"}):
        other = Node(device="cuda", settings={"http": {"ip_filter": rule}})
        try:
            p2 = other.start(0)
            try:
                http(p2, "GET", "/")
                ok = False
            except (urllib.error.URLError, ConnectionError):
                ok = True
            check(ok and other.http_stats()["ip_rejected"] >= 1,
                  f"(e) {rule} refuses the connection")
            refused[next(iter(rule))] = other.http_stats()["ip_rejected"]
        finally:
            other.close()
    out["ip_filter"] = refused
    lap("e_ip_filter")

    # ---- (f) the request breaker below one segment's aggregation mask
    th_brk.join(600)
    check("segment" in brk, "(f) the breaker node's index was built")
    bcorpus = brk["corpus"]
    limit = n_b // 2            # bytes: below the [n_b] bool mask
    other = Node(device="cuda", settings={
        "indices.breaker.request.limit": limit})
    try:
        other.create_index("brk", {"properties": {
            "title": {"type": "text"}, "cat": {"type": "keyword"}}})
        other.indices["brk"].engine.install_segments([brk.pop("segment")])
        p3 = other.start(0)
        bq = queries[v2m[0]]
        text_q = " ".join(term_name(t) for t in bq)
        agg_body = {"query": {"match": {"title": text_q}}, "size": 10,
                    "aggs": {"c": {"terms": {"field": "cat"}}}}
        trips0 = other.telemetry.metrics.get_value(
            "breaker.tripped", breaker="request") or 0
        st, r = http(p3, "POST", "/brk/_search", agg_body)
        check(st == 429
              and r["error"]["type"] == "circuit_breaking_exception",
              f"(f) match + terms agg over {n_b} docs with "
              f"request.limit {limit} B: {st} {str(r)[:300]}")
        trips = (other.telemetry.metrics.get_value(
            "breaker.tripped", breaker="request") or 0) - trips0
        check(trips == 1, f"(f) breaker.tripped{{breaker=request}} grew by "
                          f"1: {trips}")
        plain_body = {"query": {"match": {"title": text_q}}, "size": 10}
        st, r = http(p3, "POST", "/brk/_search", plain_body)
        want = exact_topk(bcorpus, bq, 10)[2]
        check(st == 200 and r["hits"]["total"] == {"value": int(want),
                                                   "relation": "eq"},
              f"(f) the body without aggs answers its exact total {want}: "
              f"{st} {str(r)[:200]}")
        check(request_breaker_used(other) == 0,
              "(f) the second node's request breaker back to 0")
        # the body without aggs took that node's fast path: its v2m
        # cohorts launched the merge too
        other_v2m = other.fastpath.stats["cohorts_v2m"]
        out["breaker"] = dict(docs=n_b, limit_bytes=limit,
                              mask_bytes=n_b, trips=trips,
                              total=int(want))
    finally:
        other.close()
    breaker_zero("(f)")
    log(f"[telemetry] (f) {out['breaker']}")
    lap("f_breaker")

    # ---- host costs: a span, an observe, a search record, a slot
    tr = tele.tracer
    out["host_us"] = dict(
        span=micro_us(lambda: tr.start_span("t20.micro").finish(),
                      T20_MICRO),
        observe=micro_us(lambda: tele.metrics.observe("t20.micro", 1.5),
                         T20_MICRO),
        tenant_class_record=micro_us(
            lambda: (tele.tenants.record_search("t20-micro", 1.5),
                     tele.workload.record_search("t20-micro", 1.5)),
            T20_MICRO),
        cohort_slot=micro_us(
            lambda: (tele.tenants.record_cohort("t20-micro"),
                     tele.workload.record_cohort("t20-micro")),
            T20_MICRO))
    # p50 of a dense _search with the four headers against without, on
    # "tele20" (64 docs): the headers' host cost, not 2M docs' scoring
    lat = {}
    body = {"query": {"match": {"title": "telemetry doc"}},
            "min_score": 1e-6, "size": 10}
    for mode in ("bare", "headers", "bare", "headers"):
        hdrs = {} if mode == "bare" else {
            "X-Opaque-Id": "t20", "X-Tenant-Id": "t20-lat",
            "X-Workload-Class": "t20-lat", "trace.id": "t20-lat"}

        def timed(mode=mode, hdrs=hdrs):
            for _ in range(T20_LAT // (2 * T20_LAT_CLIENTS)):
                t0 = time.perf_counter()
                st, _, r = http_h(port, "POST", "/tele20/_search", body,
                                  hdrs)
                lat.setdefault(mode, []).append(time.perf_counter() - t0)
                check(st == 200, f"latency {mode}: {str(r)[:200]}")

        ths = [threading.Thread(target=timed, daemon=True)
               for _ in range(T20_LAT_CLIENTS)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(600)
    check(all(len(v) == T20_LAT for v in lat.values()),
          f"latency: {T20_LAT} searches a mode")
    sent[0] += 2 * T20_LAT
    out["p50_ms"] = {m: float(np.percentile(np.asarray(v) * 1e3, 50))
                     for m, v in lat.items()}
    out["p99_ms"] = {m: float(np.percentile(np.asarray(v) * 1e3, 99))
                     for m, v in lat.items()}
    log(f"[telemetry] host µs {out['host_us']}, p50 ms {out['p50_ms']}")
    lap("host_costs")

    # ---- (g) _nodes/stats
    ns = node_metrics(port, node.node_id, history=True)
    m1 = ns["telemetry"]["metrics"]
    grew = m1["search.requests"]["value"] - searches0
    lat_grew = m1["search.latency"]["count"] - lat0
    check(grew == sent[0] and lat_grew == sent[0],
          f"(g) search.requests grew by the searches sent ({grew} vs "
          f"{sent[0]}), search.latency counts them ({lat_grew})")
    check("history" in ns["telemetry"] and ns["telemetry"]["history"],
          "(g) ?history=true renders the history ring")
    check(ns["telemetry"]["tenants"]["cardinality"]["live"] >= 3
          and ns["recoveries"] and ns["indices"]["bench"],
          "(g) the tenants, recoveries and indices sections")
    out["nodes_stats"] = dict(searches=grew, latency_count=lat_grew,
                              history_keys=sorted(ns["telemetry"][
                                  "history"])[:8],
                              traces=ns["telemetry"]["traces"])
    lap("g_nodes_stats")

    # ---- the kernels' counts, the breaker
    hbm_agrees(node, "telemetry", hbm_log)
    breaker_zero("the phase")
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    cohorts_v2m = fp.stats["cohorts_v2m"] - c_start["cohorts_v2m"]
    check(launches["gather_bm25_contrib"] > 0 and cohorts_v2m > 0
          and launches["merge_sorted_slots"] == cohorts_v2m + other_v2m,
          f"both kernels launched in phase 20, the merge once a v2m "
          f"cohort: {launches} ({cohorts_v2m} v2m cohorts, {other_v2m} "
          f"on the breaker's node)")
    out["launches"] = launches
    out["searches_sent"] = sent[0]
    out["steps_s"] = steps
    out["phase_s"] = time.time() - t_phase
    log(f"[telemetry] {json.dumps(out)[:3000]}")
    return out


def tasks_alone(docs=2_000_000, vocab=100_000, seed=0):
    """Phase 19 by itself on the card, on a node holding what it reads of
    the earlier phases' indices: "bench" (registered with the front),
    "bench5" (the corpus in 5 shards, one segment each) and "an18"
    (10,000 English-like docs through `_bulk`):

        python3 -c 'import chip_smoke as c; c.tasks_alone()'
    """
    import torch

    from elasticsearch_tpu_torch.corpus import (ANALYSIS_MAPPINGS,
                                                ANALYSIS_SETTINGS,
                                                build_corpus, english_docs,
                                                exact_topk, make_queries,
                                                segment_from_corpus,
                                                shard_corpus)
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import _build
    from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
    from elasticsearch_tpu_torch.ops.merge import merge_sorted_slots
    _build.build_all()
    rng = np.random.default_rng(seed)
    corpus = build_corpus(rng, n_docs=docs, vocab=vocab)
    queries = make_queries(rng, corpus["df"], n_docs=docs, n_queries=256)
    # the phase reads the oracles of its first 64 queries
    oracles = [exact_topk(corpus, q, 1000) for q in queries[:T19_LOAD]]
    node = Node(device="cuda", settings={"indices.breaker.hbm.limit": int(
        0.75 * torch.cuda.mem_get_info()[1])})
    try:
        node.create_index("bench", {"properties": {"title":
                                                   {"type": "text"}}})
        node.indices["bench"].engine.install_segments(
            [segment_from_corpus(corpus)])
        port = node.start(0)
        svc = node.create_index(
            "bench5", {"properties": {"title": {"type": "text"}}},
            {"index": {"number_of_shards": SHARDS}})
        assign = routing_oracle(docs, SHARDS)
        for sh in range(SHARDS):
            sub = shard_corpus(corpus, np.nonzero(assign == sh)[0])
            svc.shards[sh].install_segments([segment_from_corpus(
                sub, name=f"bench5[{sh}]_0", ids=sub["ids"])])
        st, _ = http(port, "PUT", "/an18", {
            "settings": {"index": dict(ANALYSIS_SETTINGS["index"],
                                       number_of_shards=1)},
            "mappings": ANALYSIS_MAPPINGS})
        check(st == 200, "PUT /an18")
        an = english_docs(AN_DOCS, np.random.default_rng(seed + 3))
        for lo in range(0, AN_DOCS, AN_BULK):
            st, r = http(port, "POST", "/an18/_bulk", "".join(
                json.dumps({"index": {"_id": str(i)}}) + "\n"
                + json.dumps(an[i]) + "\n"
                for i in range(lo, lo + AN_BULK)), ndjson=True)
            check(st == 200 and not r["errors"], "an18 bulk")
        check(http(port, "POST", "/an18/_refresh")[0] == 200, "refresh")
        counters = {"gather_bm25_contrib": gather_bm25_contrib,
                    "merge_sorted_slots": merge_sorted_slots}
        out = phase_tasks(node, port, queries, oracles, seed + 20,
                          counters, [])
        print(json.dumps({"tasks": out}))
        return out
    finally:
        node.close()


def telemetry_alone(docs=2_000_000, vocab=100_000, seed=0):
    """Phase 20 by itself on the card, on a node holding what it reads of
    the earlier phases' indices: "bench" (registered with the front),
    "bench5" (the corpus in 5 shards, one segment each) and "logs" (the
    incident corpus with its numeric columns):

        python3 -c 'import chip_smoke as c; c.telemetry_alone()'
    """
    import torch

    from elasticsearch_tpu_torch.corpus import (LOGS_MAPPINGS, build_corpus,
                                                exact_topk, logs_columns,
                                                make_queries,
                                                segment_from_corpus,
                                                shard_corpus,
                                                with_incident_terms)
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import _build
    from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
    from elasticsearch_tpu_torch.ops.merge import merge_sorted_slots
    _build.build_all()
    rng = np.random.default_rng(seed)
    corpus = build_corpus(rng, n_docs=docs, vocab=vocab)
    queries = make_queries(rng, corpus["df"], n_docs=docs, n_queries=256)
    oracles = [exact_topk(corpus, q, 1000) for q in queries[:T19_LOAD]]
    node = Node(device="cuda", settings={"indices.breaker.hbm.limit": int(
        0.75 * torch.cuda.mem_get_info()[1])})
    try:
        node.create_index("bench", {"properties": {"title":
                                                   {"type": "text"}}})
        node.indices["bench"].engine.install_segments(
            [segment_from_corpus(corpus)])
        port = node.start(0)
        svc = node.create_index(
            "bench5", {"properties": {"title": {"type": "text"}}},
            {"index": {"number_of_shards": SHARDS}})
        assign = routing_oracle(docs, SHARDS)
        for sh in range(SHARDS):
            sub = shard_corpus(corpus, np.nonzero(assign == sh)[0])
            svc.shards[sh].install_segments([segment_from_corpus(
                sub, name=f"bench5[{sh}]_0", ids=sub["ids"])])
        logs = with_incident_terms(corpus, np.random.default_rng(seed + 3))
        cols = logs_columns(docs, np.random.default_rng(seed + 5))
        node.create_index("logs", LOGS_MAPPINGS)
        node.indices["logs"].engine.install_segments(
            [segment_from_corpus(logs, name="logs0", numerics=cols)])
        node.refresh_front()
        counters = {"gather_bm25_contrib": gather_bm25_contrib,
                    "merge_sorted_slots": merge_sorted_slots}
        out = phase_telemetry(node, port, corpus, queries, oracles,
                              seed + 21, counters, [])
        print(json.dumps({"telemetry": out}))
        return out
    finally:
        node.close()


# ---------------------------------------------------------------- phase 21
T21_SIZE = 100
T21_MSEARCH = 64       # (a) the _msearch's bench bodies
T21_FROZEN = 16        # (b) plan and dense bodies on frozen "bench5"
T21_SCROLL_PAGES = 3   # (b) the scroll walk's pages
T21_RESTORED = 32      # (c) bench-mix bodies on "bench_r"
T21_SLM_DOCS = 200     # (e) the policy's index


def resident_of(node, index):
    """The segments of ``index`` that are resident on the card."""
    return [n for n in node.indices[index].segment_names()
            if node.device_cache.resident(n) is not None]


def breaker_is_resident(node, what):
    """The hbm breaker holds exactly the resident segments' bytes."""
    import torch
    torch.cuda.synchronize()
    used = node.breaker_service.get_breaker("hbm").used
    total = node.device_cache.hbm_stats()["total_bytes"]
    check(used == total, f"{what}: breaker.used {used} == the resident "
          f"bytes {total}")
    return used


def scroll_walk(port, path, body, pages, after=None):
    """The first ``pages`` pages of a scroll of ``body`` on ``path``
    (``after(i)`` runs after page i), then the scroll cleared."""
    st, r = http(port, "POST", f"{path}?scroll=1m", body)
    check(st == 200 and "_scroll_id" in r, f"scroll {path}: {str(r)[:300]}")
    out = [r]
    if after is not None:
        after(0)
    while len(out) < pages:
        st, r = http(port, "POST", "/_search/scroll",
                     {"scroll_id": out[0]["_scroll_id"], "scroll": "1m"})
        check(st == 200 and r["_shards"]["failed"] == 0,
              f"scroll page {len(out)} of {path}: {str(r)[:300]}")
        out.append(r)
        if after is not None:
            after(len(out) - 1)
    st, _ = http(port, "DELETE", "/_search/scroll",
                 {"scroll_id": out[0]["_scroll_id"]})
    check(st == 200, "clear the scroll")
    return out


def arrays_files(node, index):
    import glob
    return glob.glob(os.path.join(node.data_path, index, "*", "*",
                                  "arrays.npz"))


def phase_operations(node, port, queries, seed, counters, hbm_log):
    """The node's operational layer on one H100 (module docstring, phase
    21), on the main node after phase 20, over "bench" and "bench5"."""
    import shutil
    import tempfile

    import torch
    from elasticsearch_tpu_torch.health.indicators import \
        HEALTH_RATE_WINDOW_S
    from elasticsearch_tpu_torch.ops.device import DeviceSegment
    from elasticsearch_tpu_torch.telemetry.engine import TRACKER
    t_phase = time.time()
    out = {}
    steps = {}
    t_step = [time.time()]

    def lap(name):
        now = time.time()
        steps[name] = now - t_step[0]
        t_step[0] = now

    fp = node.fastpath
    s_start = TRACKER.calls("bm25_dense_scores_sorted")
    c_start = dict(fp.stats)
    for c in counters.values():
        c.launches = 0
    svc = node.indices["bench"]
    reg = fp.register("bench", svc.engine.segments[0], "title", svc.k1,
                      svc.b)
    v2m = [i for i, q in enumerate(queries)
           if lane_of(fp, reg, q, T21_SIZE) == "v2m"]
    check(len(v2m) >= T21_MSEARCH, f"v2m queries at size {T21_SIZE}: "
          f"{len(v2m)}")
    # a sample of the history ring at the phase's start: (f)'s window
    # then holds the phase's launches
    check(http(port, "GET", "/_nodes/stats?history=true")[0] == 200,
          "the history ring sampled")
    # every DeviceSegment build (a segment's upload) timed on the card
    uploads = []
    orig_init = DeviceSegment.__init__

    def timed_init(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig_init(self, *args, **kwargs)
        torch.cuda.synchronize()
        uploads.append((self.name, (time.perf_counter() - t0) * 1e3))

    def upload_ms(since):
        return sum(ms for _, ms in uploads[since:])

    tmp = tempfile.mkdtemp(prefix="estpu-ops21-")
    DeviceSegment.__init__ = timed_init
    try:
        # ---- (a) the search pool: an _msearch of 64 bench bodies
        bodies = [plan_body(queries[v2m[i]], T21_SIZE) if i % 2 == 0
                  else match_body(queries[v2m[i]], T21_SIZE, source=True)
                  for i in range(T21_MSEARCH)]
        alone = [http(port, "POST", "/bench/_search", b) for b in bodies]
        tp0 = node_metrics(port, node.node_id)["thread_pool"]["search"]
        nd = "".join(json.dumps({"index": "bench"}) + "\n" + json.dumps(b)
                     + "\n" for b in bodies)
        t0 = time.perf_counter()
        st, r = http(port, "POST", "/_msearch", nd, ndjson=True)
        ms_wall = time.perf_counter() - t0
        check(st == 200 and len(r["responses"]) == T21_MSEARCH,
              f"(a) _msearch: {str(r)[:300]}")
        for i, (got, (st, want)) in enumerate(zip(r["responses"], alone)):
            check(st == 200 and "hits" in got,
                  f"(a) body {i}: {str(got)[:200]}")
            same_hits_exactly(got, want, f"(a) body {i} in the _msearch "
                              f"and alone")
        ns = node_metrics(port, node.node_id)
        tp1 = ns["thread_pool"]["search"]
        check(tp1["completed"] - tp0["completed"] == T21_MSEARCH
              and tp1["rejected"] == tp0["rejected"],
              f"(a) thread_pool.search: completed +{T21_MSEARCH}, "
              f"rejected +0 ({tp0} -> {tp1})")
        st, _, cat = http_h(port, "GET", "/_cat/thread_pool")
        check(st == 200, f"(a) _cat/thread_pool: {cat}")
        pools = ns["thread_pool"]
        rows = {ln.split()[1]: [int(x) for x in ln.split()[2:]]
                for ln in cat.splitlines()}
        check(rows == {n: [p["active"], p["queue"], p["rejected"]]
                       for n, p in pools.items()},
              f"(a) _cat/thread_pool agrees with _nodes/stats: {rows} vs "
              f"{pools}")
        out["thread_pool"] = dict(bodies=T21_MSEARCH, wall_s=ms_wall,
                                  search=tp1, pools=sorted(pools))
        log(f"[ops] (a) {out['thread_pool']}")
        lap("a_thread_pool")

        # ---- (b) "bench5" frozen
        names5 = node.indices["bench5"].segment_names()
        fbodies = [plan_body(queries[v2m[i]], T21_SIZE) if i % 2 == 0
                   else t19_dense_body(queries[v2m[i]], T21_SIZE)
                   for i in range(T21_FROZEN)]
        warm = [http(port, "POST", "/bench5/_search", b) for b in fbodies]
        for i, (st, w) in enumerate(warm):
            check(st == 200, f"(b) unfrozen body {i}: {str(w)[:200]}")
        walk_body = t19_dense_body(queries[v2m[0]], T21_SIZE)
        walk = scroll_walk(port, "/bench5/_search", walk_body,
                           T21_SCROLL_PAGES)
        st, r = http(port, "POST", "/bench5/_freeze")
        check(st == 200 and r["acknowledged"], f"(b) _freeze: {r}")

        def frozen_clean(what):
            check(resident_of(node, "bench5") == [],
                  f"{what}: no bench5 segment on the card")
            check(node.device_cache.hbm_stats(set(names5))[
                "total_bytes"] == 0, f"{what}: no bench5 bytes")
            breaker_is_resident(node, what)

        frozen_clean("(b) after _freeze")
        throttled = node.threadpool.executor("search_throttled")
        thr0 = throttled.stats()["completed"]
        frozen_up = []
        for i, b in enumerate(fbodies):
            n_up = len(uploads)
            st, r = http(port, "POST", "/bench5/_search", b)
            check(st == 200, f"(b) frozen body {i}: {str(r)[:200]}")
            same_hits_exactly(r, warm[i][1], f"(b) frozen body {i} and "
                              f"unfrozen")
            frozen_clean(f"(b) after frozen body {i}")
            frozen_up.append(upload_ms(n_up))
        check(throttled.stats()["completed"] - thr0 == T21_FROZEN,
              f"(b) search_throttled.completed +{T21_FROZEN}")
        st, r = http(port, "PUT", "/bench5/_doc/t21", {"title": "frozen"})
        check(st == 403 and r["error"]["type"] == "cluster_block_exception",
              f"(b) a write to the frozen index: {st} {r}")
        fwalk = scroll_walk(
            port, "/bench5/_search", walk_body, T21_SCROLL_PAGES,
            after=lambda i: frozen_clean(f"(b) after frozen scroll page "
                                         f"{i}"))
        for i, (a, b) in enumerate(zip(fwalk, walk)):
            same_hits_exactly(a, b, f"(b) scroll page {i} frozen and "
                              f"unfrozen")
        check(len(fwalk[-1]["hits"]["hits"]) == T21_SIZE,
              "(b) the walk's third page is full")
        st, r = http(port, "POST", "/bench5/_unfreeze")
        check(st == 200, f"(b) _unfreeze: {r}")
        out["frozen"] = dict(
            bodies=T21_FROZEN, upload_ms=frozen_up,
            upload_ms_mean=float(np.mean(frozen_up)),
            scroll_pages=len(fwalk),
            throttled=throttled.stats())
        log(f"[ops] (b) {out['frozen']}")
        lap("b_frozen")

        # ---- (c) snapshot "bench", restore it as "bench_r"
        repo_dir = os.path.join(tmp, "repo")
        st, r = http(port, "PUT", "/_snapshot/ops21", {
            "type": "fs", "settings": {"location": repo_dir}})
        check(st == 200, f"(c) register the repository: {r}")
        t0 = time.time()
        st, r = http(port, "PUT", "/_snapshot/ops21/snap1",
                     {"indices": "bench"})
        snap_s = time.time() - t0
        check(st == 200 and r["snapshot"]["state"] == "SUCCESS",
              f"(c) snapshot: {str(r)[:300]}")
        st, r = http(port, "GET", "/_snapshot/ops21/snap1/_status")
        snap_stats = r["snapshots"][0]["stats"]
        check(st == 200 and snap_stats["uploaded_bytes"]
              == snap_stats["total_bytes"] > 0,
              f"(c) the first snapshot uploads every byte: {snap_stats}")
        t0 = time.time()
        st, r = http(port, "POST", "/_snapshot/ops21/snap1/_restore", {
            "indices": "bench", "rename_pattern": "bench",
            "rename_replacement": "bench_r"})
        restore_s = time.time() - t0
        check(st == 200 and r["snapshot"]["indices"] == ["bench_r"],
              f"(c) restore: {r}")
        src_names = set(node.indices["bench"].segment_names())
        r_names = set(node.indices["bench_r"].segment_names())
        check(r_names and not (src_names & r_names),
              f"(c) fresh segment names: {src_names} vs {r_names}")
        mix = [(plan_body if i % 3 == 0 else t19_dense_body if i % 3 == 1
                else (lambda q, k: match_body(q, k, source=True)))(
                    queries[v2m[i]], T21_SIZE) for i in range(T21_RESTORED)]
        want = []
        for i, b in enumerate(mix):
            st, w = http(port, "POST", "/bench/_search", b)
            check(st == 200, f"(c) bench body {i}: {str(w)[:200]}")
            want.append(w)
        n_up = len(uploads)
        st, first = http(port, "POST", "/bench_r/_search", mix[1])
        first_up = upload_ms(n_up)
        check(st == 200 and any(n in r_names for n, _ in uploads[n_up:]),
              f"(c) the first bench_r search uploads its segment: {st}")
        d0 = fp.stats["cohorts_v2m"]
        q0 = dict(fp.serving_stats()["dispatch"])
        for i, b in enumerate(mix):
            st, g = http(port, "POST", "/bench_r/_search", b)
            check(st == 200, f"(c) bench_r body {i}: {str(g)[:200]}")
            same_hits_exactly(g, want[i], f"(c) body {i} on bench_r and "
                              f"bench")
        n_fast = sum(1 for i in range(T21_RESTORED) if i % 3 == 2)
        q1 = fp.serving_stats()["dispatch"]
        fast_v2m = sum(v - q0.get(k, 0) for k, v in q1.items()
                       if k.startswith("v2m"))
        check(fp.stats["cohorts_v2m"] > d0 and fast_v2m == n_fast,
              f"(c) bench_r's {n_fast} fast-grammar bodies on the v2m "
              f"lane: {fast_v2m} ({q0} -> {q1})")
        front = (fp._front_reg or {}).get("index")
        breaker_is_resident(node, "(c) bench and bench_r resident")
        st, r = http(port, "PUT", "/_snapshot/ops21/snap2",
                     {"indices": "bench"})
        check(st == 200, f"(c) the second snapshot: {r}")
        st, r = http(port, "GET", "/_snapshot/ops21/snap2/_status")
        snap2 = r["snapshots"][0]["stats"]
        check(snap2["uploaded_bytes"] == 0
              and snap2["skipped_bytes"] == snap2["total_bytes"] > 0,
              f"(c) the second snapshot uploads no new blob bytes: {snap2}")
        victim = want[1]["hits"]["hits"][0]["_id"]
        st, _ = http(port, "DELETE", f"/bench/_doc/{victim}")
        check(st == 200, f"(c) delete {victim} from bench")
        check(http(port, "POST", "/bench/_refresh")[0] == 200, "refresh")
        st, g = http(port, "POST", "/bench_r/_search", mix[1])
        check(g["hits"]["total"] == want[1]["hits"]["total"]
              and g["hits"]["hits"][0]["_id"] == victim,
              f"(c) bench_r keeps the doc deleted in bench: "
              f"{g['hits']['total']}")
        st, s = http(port, "POST", "/bench/_search", mix[1])
        check(s["hits"]["total"]["value"]
              == want[1]["hits"]["total"]["value"] - 1,
              f"(c) bench lost it: {s['hits']['total']}")
        out["snapshot"] = dict(
            snapshot_s=snap_s, bytes=snap_stats["total_bytes"],
            files=snap_stats["file_count"], restore_s=restore_s,
            first_search_upload_ms=first_up, second_snapshot=snap2,
            bodies=T21_RESTORED, fast_bodies_v2m=fast_v2m, front=front)
        log(f"[ops] (c) {out['snapshot']}")
        lap("c_snapshot_restore")

        # ---- (d) mount the snapshot as "bench_m"
        st, r = http(port, "POST", "/_snapshot/ops21/snap1/_mount"
                     "?storage=shared_cache",
                     {"index": "bench", "renamed_index": "bench_m"})
        check(st == 200, f"(d) mount: {r}")
        check(arrays_files(node, "bench_m") == [],
              "(d) no segment file before the first search")
        st, ss0 = http(port, "GET", "/_searchable_snapshots/stats")
        n_up = len(uploads)
        t0 = time.time()
        st, g = http(port, "POST", "/bench_m/_search", mix[1])
        mount_first_s = time.time() - t0
        mount_up = upload_ms(n_up)
        check(st == 200 and arrays_files(node, "bench_m") != [],
              f"(d) the first search materializes the segments: {st}")
        same_hits_exactly(g, want[1], "(d) bench_m's first answer and "
                          "bench's")
        for i, b in enumerate(mix[:8]):
            st, g = http(port, "POST", "/bench_m/_search", b)
            same_hits_exactly(g, want[i], f"(d) body {i} on bench_m and "
                              f"bench")
        st, r = http(port, "PUT", "/bench_m/_doc/t21", {"title": "mounted"})
        check(st == 403, f"(d) a write to the mount: {st} {r}")
        breaker_is_resident(node, "(d) bench, bench_r and bench_m resident")
        st, ss1 = http(port, "GET", "/_searchable_snapshots/stats")
        st, r = http(port, "POST", "/_snapshot/ops21/snap1/_mount"
                     "?storage=shared_cache",
                     {"index": "bench", "renamed_index": "bench_m2"})
        check(st == 200, f"(d) the second mount: {r}")
        st, c = http(port, "POST", "/bench_m2/_count", {})
        check(st == 200, f"(d) _count on the second mount: {c}")
        st, ss2 = http(port, "GET", "/_searchable_snapshots/stats")
        cache0, cache1, cache2 = (x["shared_cache"] for x in (ss0, ss1, ss2))
        check(cache1["misses"] > cache0["misses"]
              and cache2["hits"] > cache1["hits"]
              and cache2["misses"] == cache1["misses"],
              f"(d) the second mount is served from the cache: {cache0} -> "
              f"{cache1} -> {cache2}")
        check(http(port, "DELETE", "/bench_m2")[0] == 200,
              "delete bench_m2")
        out["mount"] = dict(first_search_s=mount_first_s,
                            first_search_upload_ms=mount_up,
                            cache=cache2, indices=ss2["total"])
        log(f"[ops] (d) {out['mount']}")
        lap("d_mount")

        # ---- (e) SLM: a policy executed twice, max_count 1
        lines = "".join(
            json.dumps({"index": {"_index": "ops21", "_id": str(i)}}) + "\n"
            + json.dumps({"title": f"slm doc {i}"}) + "\n"
            for i in range(T21_SLM_DOCS))
        st, r = http(port, "POST", "/_bulk?refresh=true", lines, ndjson=True)
        check(st == 200 and not r["errors"], "(e) the policy's index")
        st, r = http(port, "PUT", "/_slm/policy/p21", {
            "name": "<ops21-{now/d}>", "repository": "ops21",
            "config": {"indices": "ops21"},
            "retention": {"max_count": 1}})
        check(st == 200, f"(e) put the policy: {r}")
        names = []
        for _ in range(2):
            st, r = http(port, "POST", "/_slm/policy/p21/_execute")
            check(st == 200, f"(e) execute: {r}")
            names.append(r["snapshot_name"])
        st, r = http(port, "GET", "/_snapshot/ops21/_all")
        mine = [s["snapshot"] for s in r["snapshots"]
                if s.get("metadata", {}).get("policy") == "p21"]
        check(names[0] != names[1] and mine == [names[1]],
              f"(e) retention kept the newest of {names}: {mine}")
        st, p = http(port, "GET", "/_slm/policy/p21")
        check(p["p21"]["last_success"]["snapshot_name"] == names[1],
              f"(e) the policy's last success: {p}")
        out["slm"] = dict(executed=names, kept=mine)
        lap("e_slm")

        # ---- (f) health
        st, rep = http(port, "GET", "/_health_report")
        br = node.breaker_service.get_breaker("hbm")
        hist = node.telemetry.history
        check(st == 200, f"(f) _health_report: {str(rep)[:300]}")
        nid = node.node_id
        eng = rep["indicators"]["device_engine"]["details"]["nodes"][nid]
        check(eng["hbm_used_ratio"] == round(br.used / br.limit, 4),
              f"(f) device_engine's hbm_used_ratio {eng['hbm_used_ratio']} "
              f"== breaker {br.used} / {br.limit}")
        reg_d = rep["indicators"]["device_regime"]["details"]["nodes"][nid]
        slots = hist.delta_total("flight.launch.slots", HEALTH_RATE_WINDOW_S)
        filled = hist.delta_total("flight.launch.filled",
                                  HEALTH_RATE_WINDOW_S)
        launches_w = hist.delta_total("flight.launches",
                                      HEALTH_RATE_WINDOW_S)
        check(launches_w > 0 and reg_d["launches_in_window"] == launches_w
              and reg_d["fill_ratio_in_window"]
              == (filled / slots if slots else None),
              f"(f) device_regime's fill {reg_d} == the flight ring's "
              f"({launches_w} launches, {filled}/{slots})")
        integ = rep["indicators"]["repository_integrity"]
        check(integ["status"] == "green"
              and integ["details"]["nodes"][nid]["repositories"] == [
                  "ops21"], f"(f) repository_integrity green: {integ}")
        blob = os.path.join(repo_dir, "snap-snap1.json")
        with open(blob, "r+b") as fh:
            fh.truncate(os.path.getsize(blob) // 2)
        st, r = http(port, "GET", "/_health_report/repository_integrity")
        integ_red = r["indicators"]["repository_integrity"]
        check(integ_red["status"] == "red"
              and integ_red["diagnosis"][0]["affected_resources"]
              == ["ops21:snap-snap1.json"],
              f"(f) repository_integrity red, naming the truncated blob: "
              f"{integ_red}")
        st, h = http(port, "GET", "/_cluster/health")
        shards = sum(s.num_shards for s in node.indices.values())
        check(st == 200 and h["status"] == "green"
              and h["active_shards"] == shards,
              f"(f) _cluster/health green with {shards} active shards: {h}")
        st, r = http(port, "GET", "/_health_report/nope")
        check(st == 400 and r["error"]["type"]
              == "illegal_argument_exception",
              f"(f) an unknown indicator: {st} {r}")
        out["health"] = dict(
            status=rep["status"],
            indicators={k: v["status"] for k, v in
                        rep["indicators"].items()},
            hbm_used_ratio=eng["hbm_used_ratio"],
            fill_ratio_in_window=reg_d["fill_ratio_in_window"],
            launches_in_window=launches_w, truncated="snap-snap1.json",
            active_shards=h["active_shards"])
        log(f"[ops] (f) {out['health']}")
        lap("f_health")

        # ---- cleanup
        for index in ("bench_r", "bench_m", "ops21"):
            check(http(port, "DELETE", f"/{index}")[0] == 200,
                  f"delete {index}")
        check(http(port, "DELETE", "/_slm/policy/p21")[0] == 200,
              "delete the policy")
        check(http(port, "DELETE", "/_snapshot/ops21")[0] == 200,
              "delete the repository")
        check(node.background_threads() == 0, "no background thread left")
        hbm_agrees(node, "operations", hbm_log)
        lap("cleanup")
    finally:
        DeviceSegment.__init__ = orig_init
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- the kernels' counts
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    scorings = TRACKER.calls("bm25_dense_scores_sorted") - s_start
    cohorts = fp.stats["cohorts"] - c_start["cohorts"]
    cohorts_v2m = fp.stats["cohorts_v2m"] - c_start["cohorts_v2m"]
    check(cohorts_v2m > 0 and scorings > 0
          and launches["gather_bm25_contrib"] == scorings + cohorts
          and launches["merge_sorted_slots"] == cohorts_v2m,
          f"the contribution kernel once a dense scoring ({scorings}) and "
          f"once a fast cohort ({cohorts}), the merge once a v2m cohort "
          f"({cohorts_v2m}): {launches}")
    out["launches"] = launches
    out["dense_scorings"] = scorings
    out["fast_cohorts"] = cohorts
    out["uploads"] = len(uploads)
    out["steps_s"] = steps
    out["phase_s"] = time.time() - t_phase
    log(f"[ops] {json.dumps(out)[:3000]}")
    return out


def operations_alone(docs=2_000_000, vocab=100_000, seed=0):
    """Phase 21 by itself on the card, on a node holding what it reads of
    the earlier phases' indices: "bench" (registered with the front) and
    "bench5" (the corpus in 5 shards, one segment each):

        python3 -c 'import chip_smoke as c; c.operations_alone()'
    """
    import torch

    from elasticsearch_tpu_torch.corpus import (build_corpus, make_queries,
                                                segment_from_corpus,
                                                shard_corpus)
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import _build
    from elasticsearch_tpu_torch.ops.bm25_contrib import gather_bm25_contrib
    from elasticsearch_tpu_torch.ops.merge import merge_sorted_slots
    _build.build_all()
    rng = np.random.default_rng(seed)
    corpus = build_corpus(rng, n_docs=docs, vocab=vocab)
    queries = make_queries(rng, corpus["df"], n_docs=docs, n_queries=256)
    node = Node(device="cuda", settings={"indices.breaker.hbm.limit": int(
        0.75 * torch.cuda.mem_get_info()[1])})
    try:
        node.create_index("bench", {"properties": {"title":
                                                   {"type": "text"}}})
        node.indices["bench"].engine.install_segments(
            [segment_from_corpus(corpus)])
        port = node.start(0)
        svc = node.create_index(
            "bench5", {"properties": {"title": {"type": "text"}}},
            {"index": {"number_of_shards": SHARDS}})
        assign = routing_oracle(docs, SHARDS)
        for sh in range(SHARDS):
            sub = shard_corpus(corpus, np.nonzero(assign == sh)[0])
            svc.shards[sh].install_segments([segment_from_corpus(
                sub, name=f"bench5[{sh}]_0", ids=sub["ids"])])
        node.refresh_front()
        counters = {"gather_bm25_contrib": gather_bm25_contrib,
                    "merge_sorted_slots": merge_sorted_slots}
        out = phase_operations(node, port, queries, seed + 22, counters, [])
        print(json.dumps({"ops": out}))
        return out
    finally:
        node.close()


class PhaseClock:
    """The wall seconds of each phase, one lap a phase
    (``{"phase_seconds": ...}``)."""

    def __init__(self):
        self.start = self.last = time.time()
        self.seconds = {}

    def lap(self, name):
        now = time.time()
        self.seconds[name] = now - self.last
        self.last = now
        log(f"[phase] {name} took {self.seconds[name]:.1f} s "
            f"({now - self.start:.1f} s in all)")

    def report(self):
        return dict(self.seconds, total=time.time() - self.start)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=2_000_000)
    ap.add_argument("--vocab", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    # config 4 (pure kNN) and config 5 (hybrid) of the reference's
    # BASELINE (8M x 768 cosine, cut to 4M: PERF.md section 4), and the
    # scale corpus with 256-d vectors
    ap.add_argument("--knn-docs", type=int, default=4_000_000)
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
    clock = PhaseClock()

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
    clock.lap("1_build")

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
    clock.lap("setup")

    # the hbm breaker's limit, sized so every phase fits (the reference's
    # default, the host total of 4 GiB, would refuse config 4's slab)
    hbm_limit = int(0.75 * torch.cuda.mem_get_info()[1])
    log(f"[accounting] indices.breaker.hbm.limit = {hbm_limit} B "
        f"(0.75 of the card's {torch.cuda.mem_get_info()[1]} B)")
    node = Node(device="cuda",
                settings={"indices.breaker.hbm.limit": hbm_limit})
    # phases 2-15 count each request's launches and time them: none is
    # answered from the request cache (search/service.py); phase 17
    # gives it its 256 entries back
    node.search_service.REQUEST_CACHE_MAX_ENTRIES = 0
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
        clock.lap("2_kernels")

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
        clock.lap("3_rest_small")

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
        clock.lap("4_scale")

        # ---- 5. the dense executor on the logs index
        dense = phase_dense(node, port, logs, cols, len(corpus["df"]),
                            queries, args.clients, args.seed + 6,
                            args.iters, counters)
        hbm_agrees(node, "dense", hbm_log)
        clock.lap("5_dense")

        # ---- 6. kNN: pure kNN (config 4) and hybrid rank.rrf (config 5)
        knn = phase_knn(node, port, args.knn_docs, args.knn_dims,
                        args.knn_queries, args.seed + 7, args.iters)
        clock.lap("6_knn")
        cpu = SearchService(DeviceSegmentCache("cpu"), node.indices)
        feat = bench_feat(args.docs)
        hybrid = phase_hybrid(node, port, corpus, queries, oracles,
                              args.hybrid_dims, args.seed + 8,
                              min(args.clients, 64), counters, feat, cpu)
        hbm_agrees(node, "knn", hbm_log)
        clock.lap("6_hybrid")

        # ---- 7. script scoring (config 3) on the hybrid index
        script = phase_script(node, port, corpus, queries, feat,
                              args.seed + 9, min(args.clients, 64),
                              counters, cpu)
        hbm_agrees(node, "script", hbm_log)
        clock.lap("7_script")

        # ---- 8. aggregations: the bench's terms-agg row, a Kibana mix
        aggs = phase_aggs(node, port, corpus, queries, logs, cols,
                          min(args.clients, 64), counters, cpu)
        hbm_agrees(node, "aggs", hbm_log)
        clock.lap("8_aggs")

        # ---- 9. device accounting and launch attribution
        accounting = phase_accounting(node, port, corpus, queries,
                                      args.knn_dims, builds, counters,
                                      hbm_log)
        accounting["hbm_limit"] = hbm_limit
        clock.lap("9_accounting")

        # ---- 10. full text: positions, multi-term, features
        fulltext = phase_fulltext(node, port, corpus, args.seed + 12,
                                  min(args.clients, 64), counters, cpu)
        hbm_agrees(node, "fulltext", hbm_log)
        clock.lap("10_fulltext")

        # ---- 11. fetch and sort features, filter conversion
        fetch = phase_fetch(node, port, corpus, queries, cols,
                            args.seed + 13, args.clients, counters, cpu)
        hbm_agrees(node, "fetch", hbm_log)
        fetch["hbm"] = hbm_log[-1]
        clock.lap("11_fetch")

        # ---- 12. the remaining field types and their queries
        fields = phase_fields(node, port, corpus, queries, logs, cols,
                              GEO_POINTS, QA_QUESTIONS, ALERTS,
                              args.seed + 14, args.clients,
                              counters, cpu)
        hbm_agrees(node, "fields", hbm_log)
        fields["hbm"] = hbm_log[-1]
        clock.lap("12_fields")

        # ---- 13. an index of 5 shards: routing, the shard loop, dfs
        shards = phase_shards(node, port, corpus, queries, oracles,
                              filt_pool, args.seed + 15, args.clients,
                              counters, cpu, hbm_log)
        carry = shards.pop("_carry")
        clock.lap("13_shards")

        # ---- 14. the deferred aggregation types
        deferred = phase_aggs_deferred(node, port, corpus, queries, logs,
                                       cols, feat, args.clients, counters,
                                       cpu, hbm_log)
        clock.lap("14_aggs_deferred")

        # ---- 15. the mesh: its fallback on one card, its programs on a
        # grid of the card repeated, the replica fan-out
        mesh = phase_mesh(node, port, corpus, queries, carry,
                          args.seed + 16, args.iters, counters, hbm_log)
        del carry
        clock.lap("15_mesh")

        # ---- 17. index metadata and the search contexts (on this
        # node's "bench", "logs", "kw" and "hybrid"; before phase 16,
        # which opens a node of its own)
        contexts = phase_contexts(node, port, corpus, queries, oracles,
                                  logs, cols, args.seed + 14,
                                  args.seed + 18, counters, hbm_log)
        clock.lap("17_contexts")

        # ---- 18. analysis, term vectors and the by-query family
        analysis = phase_analysis(node, port, args.seed + 19, counters,
                                  cpu, hbm_log)
        clock.lap("18_analysis")

        # ---- 19. tasks and the host search modules
        tasks = phase_tasks(node, port, queries, oracles, args.seed + 20,
                            counters, hbm_log)
        clock.lap("19_tasks")

        # ---- 20. node telemetry: tenants, classes, traces, the breaker
        telemetry = phase_telemetry(node, port, corpus, queries, oracles,
                                    args.seed + 21, counters, hbm_log)
        clock.lap("20_telemetry")

        # ---- 21. the operational layer: thread pools, a frozen index,
        # snapshots, a mount, SLM, health (deletes a doc of "bench")
        seg_live = seg.live
        operations = phase_operations(node, port, queries, args.seed + 22,
                                      counters, hbm_log)
        clock.lap("21_operations")
    finally:
        node.close()

    # ---- 16. durability, on a node of its own on a temporary data path,
    # over the corpus segment as it was built (phase 21's delete in
    # "bench" replaced the live mask of the main node's copy)
    seg16 = copy.copy(seg)
    seg16.live, seg16.live_version, seg16.retired = seg_live, 0, False
    durability = phase_durability(seg16, queries, args.seed + 17, counters,
                                  hbm_log)
    clock.lap("16_durability")

    # ---- the report
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
        if name in ("cohort", "launch_floor"):
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
            launches_fulltext=fulltext["launches"][name],
            launches_fetch=fetch["launches"][name],
            launches_fields=fields["launches"][name],
            launches_shards=shards["launches"][name],
            launches_aggs_deferred=deferred["launches"][name],
            launches_mesh=mesh["launches"][name],
            launches_durability=durability["launches"][name],
            launches_contexts=contexts["launches"][name],
            launches_analysis=analysis["launches"][name],
            launches_tasks=tasks["launches"][name],
            launches_telemetry=telemetry["launches"][name],
            launches_ops=operations["launches"][name],
            launch_floor_ms=kern["launch_floor"]["ms"],
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
    print(json.dumps({"fulltext": fulltext}))
    print(json.dumps({"fetch": fetch}))
    print(json.dumps({"fields": fields}))
    print(json.dumps({"shards": shards}))
    print(json.dumps({"aggs_deferred": deferred}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"durability": durability}))
    print(json.dumps({"contexts": contexts}))
    print(json.dumps({"analysis": analysis}))
    print(json.dumps({"tasks": tasks}))
    print(json.dumps({"telemetry": telemetry}))
    print(json.dumps({"ops": operations}))
    print(json.dumps({"filters": filters}))
    print(json.dumps({"plan": dict(plan_trace, burst=plan_burst,
                                   small=plan_small)}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"phase_seconds": clock.report()}))
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
