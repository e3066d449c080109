"""Query-plan compiler (counterpart of elasticsearch_tpu/search/plan.py):
QueryBuilder trees -> fused plan launches of ops/plan.py.

A query is plannable when it decomposes into:
- postings **groups**: clauses scored or filtered from a text or keyword
  field's postings (match, multi_match, term, terms, constant_score over
  those), each with its own presence requirement (operator=and /
  minimum_should_match inside the clause);
- **dense factors**: pure column predicates (range, exists, ids,
  match_all, term(s) on numbers, booleans and dates) in a bool's must,
  filter or must_not, or a post_filter. At bind time each runs its dense
  executor (search/queries.py) and the launch ANDs their masks
  (``BoundPlan.dense_mask``, negated for must_not); a must factor adds
  its constant score to every hit (``LogicalPlan.bonus``);
composed by one level of bool occur semantics (must / filter / should /
must_not + minimum_should_match), or a top-level dis_max / multi_match
over plannable children;
- a top-level **script_score** over such a query whose script is of
  the expression tier (search/script.py), with scalar params, no
  ``min_score`` and no boost, and evaluates over dummy columns
  (``_plan_script_spec``): the launch applies it to each doc's combined
  score before the filters' verdict, the cursor and the top-k
  (``BoundPlan.script_fn``, a closure over the segment's float32
  numeric columns, ``_bind_script``), so BASELINE config 3 rides the
  batched launch. A vector function, a statement script or a
  ``min_score`` takes the dense executor.
Everything else (a nested bool, a must_not-only bool, a dense should
clause, a negative boost, ...) goes to the dense executor. Compilation
happens once per shard (terms analyzed, idf from shard-level stats);
binding resolves term -> postings-block ids per segment.

Block-max window pruning (``_prune_fields``) runs when the caller
allows it (``track_total_hits`` other than true) and the plan has no
dense factor and no script: postings blocks that provably cannot reach
the top k leave the selection before the bucket is chosen; the hits
stay exact and the total becomes a lower bound. Its bounds are BM25
bounds, which say nothing of a script's score, so a scripted plan is
never pruned (the reference prunes it, and can lose a hit a script
lifts: ROADMAP, Queue 3).

Filter conversion (``_convert_filters``, the reference's): a FILTER or
MUST_NOT group of any-of presence (one required subgroup) over one field
whose terms hold at least ``FILTER_CACHE_MIN_BLOCKS`` postings blocks in
the segment becomes a dense mask instead of entering the launch's sort
(the largest first). The converted groups' masks AND into one composed
mask, cached on the DeviceSegment and charged to the hbm breaker under
``filter_masks`` (ops/device.py ``composed_filter_mask``). At least one
postings group that enumerates docs stays in the launch: a FILTER group
converts only while a MUST group, a SHOULD group under
minimum_should_match, or another FILTER group remains. The BoundPlan
keeps the composition's key (``shared_mask``), not the mask: the launch
fetches the mask from the segment's cache, so a cohort holds it for its
launch even if the cache's LRU drops it meanwhile, and a cached
BoundPlan never holds an uncharged mask. The PlanBatcher keys a cohort
on that key (field, terms, negate per converted group), never on an
object's id. A plan that also has dense factors ANDs the composed mask
into its own per-query mask, which launches alone, as the reference's.
Pruning then validates θ against the composed host mask
(``host_masks``).

The port's declines are the reference's, plus one: a scripted plan is
never pruned (above). Each decline leaves the hits exact: an unpruned
launch, or the dense executor (a dense should clause, a nested bool, a
negative boost).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.index.mapper import (ConstantKeywordFieldType,
                                                  KeywordFieldType,
                                                  TextFieldType)
from elasticsearch_tpu_torch.ops import bm25 as bm25_ops
from elasticsearch_tpu_torch.ops import plan as plan_ops
from elasticsearch_tpu_torch.ops.device import (block_bucket, host_any_mask,
                                                readback)
from elasticsearch_tpu_torch.search import queries as q
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported
from elasticsearch_tpu_torch.search.script import (ScriptContext,
                                                   ScriptException,
                                                   _DocColumn,
                                                   compile_script)

NAN = float("nan")
_NEVER = 1 << 30  # requirement no group can meet (pad groups)

# Block-max window pruning (the reference's, after Lucene's block-max
# WAND): the docid space splits into PRUNE_WINDOWS windows; a window
# whose BM25 upper bound (from block_max_tf / block_min_len) cannot reach
# the k-th best host-verified candidate score is dropped, and postings
# blocks overlapping only dropped windows leave the selection. Only
# selections of at least PRUNE_MIN_BLOCKS blocks pay the host bound pass.
PRUNE_WINDOWS = 512
PRUNE_MIN_BLOCKS = 384

# FILTER / MUST_NOT groups at least this many postings blocks wide run as
# cached dense masks instead of entering the launch's sort (the
# reference's, after Lucene's LRUQueryCache): smaller ones are cheaper to
# sort than to cache.
FILTER_CACHE_MIN_BLOCKS = 8


@dataclass
class TermEntry:
    field: str
    term: str
    sub: int          # subgroup id within the group
    weight: float     # idf · boost (0 for pure-presence entries)
    const: bool       # constant-per-match contribution (keyword scoring)


@dataclass
class GroupPlan:
    kind: int                     # plan_ops.MUST / SHOULD / FILTER / MUST_NOT
    req: int                      # distinct subgroups required for presence
    const_score: float            # NaN = sum of contributions
    terms: List[TermEntry] = dc_field(default_factory=list)


@dataclass
class LogicalPlan:
    groups: List[GroupPlan]
    # dense factors: (clause, negate) -- must_not factors negate
    dense: List[Tuple[Any, bool]]
    n_must: int                           # MUST groups
    n_filter: int                         # FILTER groups
    msm: int
    bonus: float                          # summed must-factor scores
    combine: str = "sum"
    tie: float = 0.0
    # an expression script_score's (source, sorted params) applied to
    # the combined score in the launch, or None
    script: Optional[Tuple[str, tuple]] = None

    def postings_required(self) -> bool:
        """True iff every passing doc must match >= 1 group: the launch
        sees only docs present in the gathered postings."""
        return self.n_must >= 1 or self.n_filter >= 1 or self.msm >= 1


# ---------------------------------------------------------------------------
# clause classification
# ---------------------------------------------------------------------------

def _is_postings_field(mapper, field: str) -> bool:
    """Text, keyword (wildcard too), flattened and unmapped fields: their
    clauses are postings groups. A constant_keyword is a dense factor,
    as the reference plans it."""
    ft = mapper.field_type(field)
    if isinstance(ft, ConstantKeywordFieldType):
        return False
    return (ft is None or isinstance(ft, (TextFieldType, KeywordFieldType))
            or ft.docvalue_kind == "flattened")


def _is_dense_clause(node, mapper) -> bool:
    """Clauses whose do_execute builds masks from dense columns only (no
    postings scatter): range/exists/ids/match_all, and term(s) on a
    number, boolean, date, ip, constant_keyword, range or join field."""
    if isinstance(node, (q.RangeQuery, q.ExistsQuery, q.IdsQuery,
                         q.MatchAllQuery)):
        return True
    if isinstance(node, (q.TermQuery, q.TermsQuery)):
        return not _is_postings_field(mapper, node.field)
    return False


def _idf(searcher, field: str, term: str) -> float:
    doc_count, _ = searcher.stats.field_stats(field)
    df = searcher.stats.doc_freq(field, term)
    return bm25_ops.idf(df, doc_count) if df > 0 else 0.0


# ---------------------------------------------------------------------------
# per-clause group builders (return None when not plannable)
# ---------------------------------------------------------------------------

def _group_for_match(node: "q.MatchQuery", searcher, kind: int,
                     scale: float) -> Optional[GroupPlan]:
    if not _is_postings_field(searcher.mapper, node.field):
        return None
    terms = q._analyze_terms(searcher, node.field, node.query)
    if not terms:
        return None
    uniq = {t: i for i, t in enumerate(sorted(set(terms)))}
    if node.operator == "and":
        req = len(uniq)
    elif node.minimum_should_match:
        # parsed over the token count (duplicates included), clamped to
        # the distinct-term count; <= 1 means "any term"
        r = q.parse_minimum_should_match(
            node.minimum_should_match, len(terms))
        req = 1 if r <= 1 else min(r, len(uniq))
    else:
        req = 1
    g = GroupPlan(kind, req, NAN)
    for t in terms:  # duplicates kept: they double the contribution
        g.terms.append(TermEntry(node.field, t, uniq[t],
                                 _idf(searcher, node.field, t) * scale,
                                 False))
    return g


def _group_for_term(node: "q.TermQuery", searcher, kind: int,
                    scale: float) -> Optional[GroupPlan]:
    if not _is_postings_field(searcher.mapper, node.field):
        return None
    term = str(node.value)
    if isinstance(searcher.mapper.field_type(node.field), TextFieldType):
        g = GroupPlan(kind, 1, NAN)
        g.terms.append(TermEntry(node.field, term,
                                 0, _idf(searcher, node.field, term) * scale,
                                 False))
        return g
    # keyword/unmapped: constant score idf·1/(1+k1), no norms (Lucene
    # keyword fields omit norms)
    const = _idf(searcher, node.field, term) / (1.0 + searcher.k1) * scale
    g = GroupPlan(kind, 1, const)
    g.terms.append(TermEntry(node.field, term, 0, 0.0, False))
    return g


def _group_for_terms(node: "q.TermsQuery", searcher, kind: int,
                     scale: float) -> Optional[GroupPlan]:
    if not _is_postings_field(searcher.mapper, node.field):
        return None
    g = GroupPlan(kind, 1, 1.0 * scale)   # constant_score(1.0) any-of
    for v in node.values:
        g.terms.append(TermEntry(node.field, str(v), 0, 0.0, False))
    return g


def _group_for_clause(node, searcher, kind: int,
                      scale: float) -> Optional[GroupPlan]:
    scale = scale * node.boost
    if isinstance(node, q.MatchQuery):
        return _group_for_match(node, searcher, kind, scale)
    if isinstance(node, q.TermQuery):
        return _group_for_term(node, searcher, kind, scale)
    if isinstance(node, q.TermsQuery):
        return _group_for_terms(node, searcher, kind, scale)
    if isinstance(node, q.ConstantScoreQuery):
        inner = _group_for_clause(node.filter_query, searcher, kind, 1.0)
        if inner is None:
            return None
        inner.kind = kind
        inner.const_score = 1.0 * scale   # score is the boost, not BM25
        for t in inner.terms:
            t.weight = 0.0
        return inner
    return None


# ---------------------------------------------------------------------------
# top-level compilation
# ---------------------------------------------------------------------------

def _plan_script_spec(node: "q.ScriptScoreQuery") \
        -> Optional[Tuple[str, tuple]]:
    """(source, sorted params) when the script can ride the launch: the
    expression tier only (a statement script interprets per doc on the
    host), scalar params, no ``min_score``, no boost, and an evaluation
    over dummy columns that succeeds (it fails on a vector function,
    which needs the segment's slab)."""
    if node.min_score is not None or node.boost != 1.0:
        return None
    if not all(isinstance(v, (int, float, str, bool))
               for v in node.params.values()):
        return None
    compiled = compile_script(node.source)
    if not compiled.vectorized:
        return None

    def dummy_cols(field):
        return _DocColumn(torch.zeros(2), torch.zeros(2, dtype=torch.bool))
    try:
        compiled(ScriptContext(dummy_cols, dict(node.params),
                               score=torch.zeros(2)))
    except ScriptException:
        return None
    return node.source, tuple(sorted(node.params.items()))


def compile_plan(query, searcher,
                 post_filter=None) -> Optional[LogicalPlan]:
    """Compile a query (+ optional post_filter folded in as a filter:
    valid when no aggregations run) into a LogicalPlan, or None when the
    tree needs what this slice does not have."""
    script = None
    if isinstance(query, q.ScriptScoreQuery):
        script = _plan_script_spec(query)
        if script is None:
            return None
        query = query.query
    plan = _compile_tree(query, searcher)
    if plan is None:
        return None
    plan.script = script
    if post_filter is not None:
        g = _group_for_clause(post_filter, searcher, plan_ops.FILTER, 1.0)
        if g is not None:
            g.const_score = NAN
            plan.groups.append(g)
            plan.n_filter += 1
        elif _is_dense_clause(post_filter, searcher.mapper):
            plan.dense.append((post_filter, False))
        else:
            return None
    if not plan.postings_required():
        return None
    # negative boosts would feed negative contributions into the
    # reference's cumsum/cummax segmented sums: the dense executor
    # takes them
    if plan.bonus < 0:
        return None
    for g in plan.groups:
        if any(t.weight < 0 for t in g.terms):
            return None
        if not math.isnan(g.const_score) and g.const_score < 0:
            return None
    return plan


def _compile_tree(query, searcher) -> Optional[LogicalPlan]:
    boost = query.boost
    if isinstance(query, q.BoolQuery):
        return _compile_bool(query, searcher, boost)
    if isinstance(query, q.MultiMatchQuery):
        return _compile_multi_match(query, searcher, boost)
    if isinstance(query, q.DisMaxQuery):
        return _compile_dismax(query, searcher, boost)
    # the top-level boost is in the group scale via _group_for_clause
    g = _group_for_clause(query, searcher, plan_ops.MUST, 1.0)
    if g is not None:
        return LogicalPlan([g], [], 1, 0, 0, 0.0)
    return None


def _compile_bool(node: "q.BoolQuery", searcher,
                  boost: float) -> Optional[LogicalPlan]:
    groups: List[GroupPlan] = []
    dense: List[Tuple[Any, bool]] = []
    bonus = 0.0
    n_must = n_filter = 0
    n_required_any = 0   # must + filter clauses of any kind (msm default)
    for clause in node.must:
        g = _group_for_clause(clause, searcher, plan_ops.MUST, boost)
        if g is not None:
            groups.append(g)
            n_must += 1
        elif _is_dense_clause(clause, searcher.mapper):
            dense.append((clause, False))
            # a required constant-score clause adds its score to every
            # hit (a dense mask scores 1.0 * boost in the dense path)
            bonus += clause.boost * boost
        else:
            return None
        n_required_any += 1
    for clause in node.filter:
        g = _group_for_clause(clause, searcher, plan_ops.FILTER, 1.0)
        if g is not None:
            g.const_score = NAN   # filters never score
            groups.append(g)
            n_filter += 1
        elif _is_dense_clause(clause, searcher.mapper):
            dense.append((clause, False))
        else:
            return None
        n_required_any += 1
    for clause in node.must_not:
        g = _group_for_clause(clause, searcher, plan_ops.MUST_NOT, 1.0)
        if g is not None:
            g.const_score = NAN
            groups.append(g)
        elif _is_dense_clause(clause, searcher.mapper):
            dense.append((clause, True))
        else:
            return None
    for clause in node.should:
        # a dense should clause (a conditional +1) goes to the dense
        # executor, which keeps its exact semantics
        g = _group_for_clause(clause, searcher, plan_ops.SHOULD, boost)
        if g is None:
            return None
        groups.append(g)

    if node.minimum_should_match is None:
        msm = 1 if (node.should and n_required_any == 0) else 0
    else:
        msm = q.parse_minimum_should_match(
            node.minimum_should_match, len(node.should))
    if node.should and msm > len(node.should):
        msm = len(node.should)
    return LogicalPlan(groups, dense, n_must, n_filter, msm, bonus)


def _compile_multi_match(node: "q.MultiMatchQuery", searcher,
                         boost: float) -> Optional[LogicalPlan]:
    fields = node.fields
    if not fields or fields == ["*"]:
        fields = [name for name, ft in searcher.mapper.fields.items()
                  if isinstance(ft, TextFieldType)]
    if not fields:
        return None
    groups = []
    for f in fields:
        g = _group_for_match(q.MatchQuery(f, node.query), searcher,
                             plan_ops.SHOULD, boost)
        if g is None:
            return None
        groups.append(g)
    if node.type == "most_fields":
        return LogicalPlan(groups, [], 0, 0, 1, 0.0, combine="sum")
    if node.type == "best_fields":
        return LogicalPlan(groups, [], 0, 0, 1, 0.0, combine="dismax",
                           tie=node.tie_breaker)
    return None   # other types: the dense executor


def _compile_dismax(node: "q.DisMaxQuery", searcher,
                    boost: float) -> Optional[LogicalPlan]:
    groups = []
    for sub in node.queries:
        g = _group_for_clause(sub, searcher, plan_ops.SHOULD, boost)
        if g is None:
            return None
        groups.append(g)
    if not groups:
        return None
    return LogicalPlan(groups, [], 0, 0, 1, 0.0, combine="dismax",
                       tie=node.tie_breaker)


# ---------------------------------------------------------------------------
# per-segment binding + execution
# ---------------------------------------------------------------------------

@dataclass
class BoundPlan:
    """A LogicalPlan bound to one segment's device arrays: the launch's
    arguments. Selections stay numpy until the launch uploads them (once
    per cohort, in ops/plan.py plan_topk_batch)."""
    streams: List[plan_ops.FieldStream]
    group_kind: np.ndarray
    group_req: np.ndarray
    group_const: np.ndarray
    # AND of the dense factors' masks (bool [ND] on the device), or None
    dense_mask: Optional[Any]
    n_must: int
    n_filter: int
    msm: int
    bonus: float
    tie: float
    combine: str
    # bound on a doc's run in the sorted postings: one entry per term
    # entry of the plan (ops/bm25.py scan_run_bound)
    max_run: int
    empty: bool = False   # no query term exists in this segment
    # blocks were pruned: the launch's match count is a lower bound
    pruned: bool = False
    # the plan's script spec (the batcher's signature keys it) and its
    # closure over this segment's columns (ops/plan.py script_fn)
    script: Optional[Tuple[str, tuple]] = None
    script_fn: Optional[Callable] = None
    # the converted groups' composition key (``composed_filter_mask``'s
    # ``conversions``, sorted) when the launch ANDs the cached composed
    # mask and nothing else; it is fetched at launch (``launch_mask``)
    shared_mask: Optional[tuple] = None
    # host copies of the masks the launch ANDs in, as (mask, negate):
    # pruning validates its θ candidates against them
    host_masks: List[Tuple[np.ndarray, bool]] = dc_field(
        default_factory=list)
    # groups converted to masks (the profile's and the smoke's count)
    n_converted: int = 0


def launch_mask(bp: BoundPlan, ctx):
    """The bool [ND] column a launch of ``bp`` ANDs in: the plan's own
    dense mask, else the segment's cached composed filter mask (fetched
    now, rebuilt and charged again if the LRU dropped it), else None."""
    if bp.shared_mask is not None:
        return ctx.device.composed_filter_mask(bp.shared_mask)[0]
    return bp.dense_mask


def _group_field_blocks(g: GroupPlan, ctx) -> Optional[Tuple[str, int]]:
    """(field, total postings blocks in this segment) of a single-field
    group, else None."""
    fields = {t.field for t in g.terms}
    if len(fields) != 1:
        return None
    fname = next(iter(fields))
    dp = ctx.device.postings.get(fname)
    if dp is None:
        return fname, 0
    n = 0
    for t in g.terms:
        tid = dp.host.term_id(t.term)
        if tid >= 0:
            n += int(dp.term_block_count[tid])
    return fname, n


def _convert_filters(plan: LogicalPlan, ctx):
    """Split the plan's groups into launch groups and mask conversions:
    FILTER / MUST_NOT groups of any-of presence (req <= 1) over one field
    with at least FILTER_CACHE_MIN_BLOCKS blocks here, the largest first,
    keeping one enumerating postings group in the launch. Returns
    (launch groups, [(field, terms, negate)], launch FILTER count)."""
    must_enum = plan.n_must >= 1
    should_enum = plan.msm >= 1 and any(
        g.kind == plan_ops.SHOULD for g in plan.groups)
    sized = []
    for gi, g in enumerate(plan.groups):
        if g.kind not in (plan_ops.FILTER, plan_ops.MUST_NOT) or g.req > 1:
            continue
        fb = _group_field_blocks(g, ctx)
        if fb is not None and fb[1] >= FILTER_CACHE_MIN_BLOCKS:
            sized.append((fb[1], gi, g, fb[0]))
    sized.sort(key=lambda e: -e[0])   # the largest convert first
    n_filters_left = plan.n_filter
    converted: List[Tuple[str, List[str], bool]] = []
    convert_ids = set()
    for _, gi, g, fname in sized:
        if g.kind == plan_ops.MUST_NOT:
            convert_ids.add(gi)
            converted.append((fname, [t.term for t in g.terms], True))
        elif must_enum or should_enum or n_filters_left > 1:
            convert_ids.add(gi)
            converted.append((fname, [t.term for t in g.terms], False))
            n_filters_left -= 1
    kernel = [g for gi, g in enumerate(plan.groups) if gi not in convert_ids]
    return kernel, converted, n_filters_left


def bind_plan(plan: LogicalPlan, ctx, k: int = 10,
              allow_prune: bool = False) -> BoundPlan:
    """Resolve terms -> block ids against one segment (ctx:
    SegmentContext). With ``allow_prune`` the unpadded selections go
    through the block-max window pruning for a top ``k`` first. Selection
    widths bucket to powers of two (ops/device.py block_bucket), so they
    take O(log) values."""
    groups, converted, n_filter = _convert_filters(plan, ctx)
    ngroups = len(groups)
    # group and subgroup ids share the low 32 bits of the launch's sort
    # key, 16 bits each (pad entries carry group = ngroups)
    if ngroups >= plan_ops.GROUP_LIMIT or any(
            t.sub >= plan_ops.GROUP_LIMIT for g in groups
            for t in g.terms):
        raise SliceUnsupported(
            f"a plan holds fewer than {plan_ops.GROUP_LIMIT} clauses and "
            f"fewer than {plan_ops.GROUP_LIMIT} distinct terms per clause")
    # the converted groups' composed mask (cached, charged), then the
    # dense factors' masks, each from its dense executor
    dense_mask = None
    shared_mask = None
    host_masks: List[Tuple[np.ndarray, bool]] = []
    if converted:
        shared_mask = ctx.device.composition_key(converted)
        composed, comp_host = ctx.device.composed_filter_mask(shared_mask)
        host_masks.append((comp_host, False))
        if plan.dense:
            dense_mask = composed
    for clause, negate in plan.dense:
        _, m = clause.do_execute(ctx)
        m = (~m) if negate else m
        dense_mask = m if dense_mask is None else (dense_mask & m)
    if plan.dense:
        # the plan's own per-query mask holds the composition
        shared_mask = None

    by_field: Dict[str, List[Tuple[int, int, float, bool, str]]] = {}
    for gi, g in enumerate(groups):
        for t in g.terms:
            by_field.setdefault(t.field, []).append(
                (gi, t.sub, t.weight, t.const, t.term))

    # per field, unpadded: (name, postings, block ids, group, subgroup,
    # weight, const, entry index) per selected block
    fields = []
    n_entries = 0
    for fname, entries in by_field.items():
        dp = ctx.device.postings.get(fname)
        if dp is None:
            continue
        starts: List[int] = []
        counts: List[int] = []
        egrp: List[int] = []
        esub: List[int] = []
        ew: List[float] = []
        econst: List[bool] = []
        for gi, sub, w, const, term in entries:
            tid = dp.host.term_id(term)
            if tid < 0:
                continue
            starts.append(int(dp.term_block_start[tid]))
            counts.append(int(dp.term_block_count[tid]))
            egrp.append(gi)
            esub.append(sub)
            ew.append(w)
            econst.append(const)
        counts_np = np.asarray(counts, np.int64)
        tot = int(counts_np.sum())
        if tot == 0:
            continue
        n_entries += len(starts)
        # vectorized range expansion: every block of every entry
        rep = np.repeat(np.arange(len(starts)), counts_np)
        offs = (np.arange(tot, dtype=np.int64)
                - np.repeat(np.cumsum(counts_np) - counts_np, counts_np))
        fields.append((fname, dp,
                       (np.asarray(starts, np.int64)[rep] + offs)
                       .astype(np.int32),
                       np.asarray(egrp, np.int32)[rep],
                       np.asarray(esub, np.int32)[rep],
                       np.asarray(ew, np.float32)[rep],
                       np.asarray(econst, bool)[rep],
                       rep.astype(np.int32)))

    pruned = False
    if allow_prune and fields:
        fields, pruned = _prune_fields(plan, groups, fields, ctx, k,
                                       host_masks)

    streams: List[plan_ops.FieldStream] = []
    for fname, dp, sel_u, grp_u, sub_u, w_u, c_u, _ent in fields:
        tot = len(sel_u)
        if tot == 0:
            continue
        n = block_bucket(tot)
        sel = np.full(n, dp.zero_block, np.int32)
        sel[:tot] = sel_u
        grp = np.full(n, ngroups, np.int32)   # pads: clipped; tf=0: inert
        grp[:tot] = grp_u
        sub_a = np.zeros(n, np.int32)
        sub_a[:tot] = sub_u
        w_a = np.zeros(n, np.float32)
        w_a[:tot] = w_u
        c_a = np.zeros(n, bool)
        c_a[:tot] = c_u
        streams.append(plan_ops.FieldStream(
            dp.block_docids, dp.block_tfs, dp.doc_lens,
            ctx.stats.field_stats(fname)[1], sel, grp, sub_a, w_a, c_a))

    gpad = max(4, block_bucket(max(1, ngroups)) if ngroups else 4)
    kind = np.full(gpad, plan_ops.FILTER, np.int32)
    req = np.full(gpad, _NEVER, np.int32)
    const = np.full(gpad, NAN, np.float32)
    for gi, g in enumerate(groups):
        kind[gi] = g.kind
        req[gi] = g.req
        const[gi] = g.const_score
    # pad groups: FILTER with unreachable req — never present, and absent
    # FILTER groups don't block (n_filter counts only real groups)
    return BoundPlan(streams, kind, req, const, dense_mask, plan.n_must,
                     n_filter, plan.msm, plan.bonus, plan.tie,
                     plan.combine,
                     bm25_ops.scan_run_bound(n_entries), empty=not streams,
                     pruned=pruned, script=plan.script,
                     script_fn=(None if plan.script is None
                                else _bind_script(ctx.device, plan.script)),
                     shared_mask=shared_mask, host_masks=host_masks,
                     n_converted=len(converted))



def _bind_script(dev, spec: Tuple[str, tuple]) -> Callable:
    """The launch's closure of script ``spec`` over the DeviceSegment
    ``dev``'s float32 numeric columns:
    ``fn(score [Q, L], docids [Q, L]) -> float32 [Q, L]`` gathers each
    column at the docids. A field without doc values in this segment is
    a ScriptException, as the reference's. A result that reads neither a
    column nor ``_score`` (``Math.log(10)``) is a CPU number or 0-d
    tensor: it is moved to the score's device and broadcast."""
    compiled = compile_script(spec[0])
    params = dict(spec[1])

    def fn(score, docids):
        idx = docids.long()

        def doc_columns(field):
            col = dev.numerics.get(field)
            if col is None:
                raise ScriptException(f"unknown numeric field [{field}]")
            return _DocColumn(col[idx], dev.numeric_missing[field][idx])
        out = compiled(ScriptContext(doc_columns, params, score=score))
        if isinstance(out, torch.Tensor):
            return out.to(device=score.device,
                          dtype=torch.float32).broadcast_to(score.shape)
        return torch.full_like(score, float(np.float32(out)))
    return fn


# ---------------------------------------------------------------------------
# block-max window pruning (host bound pass)
# ---------------------------------------------------------------------------

def _prune_backoff(dev) -> None:
    """A bound pass that pruned nothing: skip the next 2^fails binds of
    this segment (at most 256), so a corpus whose docid space shows no
    block-max skew stops paying for it."""
    dev._prune_fail += 1
    dev._prune_skip = min(256, 2 ** min(dev._prune_fail, 8))


def _prune_fields(plan: LogicalPlan, groups: List[GroupPlan], fields,
                  ctx, k: int, host_masks: List[Tuple[np.ndarray, bool]]):
    """Drop postings blocks that provably cannot affect the top k.
    Returns (fields, pruned).

    Why the hits stay exact:
    - θ is the k-th largest single-entry contribution among >= k
      distinct docs that verifiably PASS the whole query (live, and every
      FILTER group and converted mask checked on the host): each such
      doc's true score is at
      least its partial contribution, so the true k-th best score is at
      least θ.
    - A docid window's bound sums per-term maxima of
      w·max_tf/(max_tf + k1·(1−b+b·min_len/avg)): an upper bound on any
      doc's score inside the window (the score rises with tf and falls
      with length).
    - Windows whose bound is below θ hold no top-k doc; blocks that
      overlap only such windows drop from every group (scoring and
      filter alike), so a surviving doc keeps ALL its postings and
      scores exactly.
    The launch's match count becomes a lower bound (``pruned``), which
    is why callers allow this only under a ``track_total_hits`` other
    than true. Declines (returns the fields unchanged) for a plan it
    cannot bound: a dense factor, a script (its score is not the BM25
    sum the bounds bound), a MUST_NOT group (pruned away, its excluded
    docs could return and the count overcount), several MUST groups, a
    minimum_should_match above 1, a group of more than one required
    subgroup, a FILTER group over several fields, more than 64 entries
    in a field, no verifiable θ."""
    total_blocks = sum(len(f[2]) for f in fields)
    if (total_blocks < PRUNE_MIN_BLOCKS or plan.dense or plan.bonus < 0
            or plan.script is not None):
        return fields, False
    dev = ctx.device
    if dev._prune_skip > 0:
        dev._prune_skip -= 1
        return fields, False

    # ---- eligibility, candidate groups, filters checked on the host
    # (``groups`` are the launch's: converted ones are in host_masks)
    must_ids = [gi for gi, g in enumerate(groups)
                if g.kind == plan_ops.MUST]
    cand_ids = set()
    filters: List[int] = []
    for gi, g in enumerate(groups):
        if g.kind == plan_ops.MUST:
            if len(must_ids) != 1 or plan.msm >= 1 or g.req > 1:
                return fields, False
            cand_ids.add(gi)
        elif g.kind == plan_ops.SHOULD:
            if not must_ids and plan.msm <= 1 and g.req <= 1:
                cand_ids.add(gi)
        elif g.kind == plan_ops.MUST_NOT:
            return fields, False
        else:   # FILTER, evaluated in the launch
            if g.req > 1 or len({t.field for t in g.terms}) != 1:
                return fields, False
            filters.append(gi)
    if must_ids:
        cand_ids = set(must_ids)
    if not cand_ids:
        return fields, False

    nd = ctx.segment.n_docs
    if nd <= 0:
        return fields, False
    wsz = max(1, -(-nd // PRUNE_WINDOWS))
    n_win = -(-nd // wsz)
    k1, b = ctx.k1, ctx.b
    ng = len(groups)
    gconst = np.asarray([g.const_score for g in groups], np.float32)
    gkind = np.asarray([g.kind for g in groups], np.int32)

    # the docs that pass every filter: live, the converted masks, and
    # each launch FILTER group's any-of presence (host_any_mask, as the
    # reference's small filters)
    vmask = np.asarray(ctx.segment.live[:nd], bool).copy()
    for hm, negate in host_masks:
        vmask &= ~hm[:nd] if negate else hm[:nd]
    for gi in filters:
        g = groups[gi]
        dp = ctx.device.postings.get(g.terms[0].field)
        vmask &= (host_any_mask(dp.host, [t.term for t in g.terms], nd)
                  if dp is not None else False)

    # ---- per-(group, window) upper bounds + θ candidates
    group_wb = np.zeros((ng, n_win), np.float64)
    group_any = np.zeros((ng, n_win), bool)     # presence, const groups
    theta = -np.inf
    probe_j = -(-k // 128) + 4                  # blocks per candidate entry
    per_field = []                              # (wlo, whi) per block
    for fname, dp, sel_u, grp_u, sub_u, w_u, c_u, ent_u in fields:
        pf = dp.host
        avg = ctx.stats.field_stats(fname)[1]
        lo_all, hi_all = dp.block_bounds()
        wlo = lo_all[sel_u] // wsz
        whi = np.maximum(hi_all[sel_u] // wsz, wlo)
        per_field.append((wlo, whi))
        mtf = pf.block_max_tf[sel_u].astype(np.float64)
        mln = pf.block_min_len[sel_u].astype(np.float64)
        norm = k1 * (1.0 - b + b * mln / avg)
        sat = np.where(mtf > 0.0, mtf / (mtf + norm), 0.0)
        is_sum_grp = np.isnan(gconst[grp_u])    # NaN: sum of contributions
        ub = np.where(is_sum_grp, np.where(c_u, w_u, w_u * sat),
                      (mtf > 0.0).astype(np.float64))

        # per-entry window maxima (an entry's blocks cover disjoint docs)
        n_ent = int(ent_u[-1]) + 1 if len(ent_u) else 0
        if n_ent > 64:
            return fields, False
        lens = whi - wlo + 1
        tot = int(lens.sum())
        csum = np.cumsum(lens) - lens
        widx = (np.repeat(wlo, lens)
                + (np.arange(tot, dtype=np.int64) - np.repeat(csum, lens)))
        eidx = np.repeat(ent_u.astype(np.int64), lens)
        ewm = np.zeros(n_ent * n_win, np.float64)
        np.maximum.at(ewm, eidx * n_win + widx, np.repeat(ub, lens))
        ewm = ewm.reshape(n_ent, n_win)

        # fold entries into group bounds: NaN-const groups SUM their
        # entries' maxima (a duplicated term counts twice, as in the
        # launch); const groups need presence only
        for e0 in np.flatnonzero(np.diff(ent_u, prepend=-1)):
            e = int(ent_u[e0])
            gi = int(grp_u[e0])
            if np.isnan(gconst[gi]):
                group_wb[gi] += ewm[e]
            group_any[gi] |= ewm[e] > 0.0

            # θ probe: the top-J blocks of a candidate entry, exact
            # partial contributions of docs that pass every filter
            if gi not in cand_ids:
                continue
            blocks = sel_u[ent_u == e]
            ub_e = ub[ent_u == e]
            j = min(probe_j, len(blocks))
            topb = (blocks[np.argpartition(ub_e, len(ub_e) - j)
                           [len(ub_e) - j:]]
                    if j < len(blocks) else blocks)
            d = pf.block_docids[topb].reshape(-1)
            tf = pf.block_tfs[topb].reshape(-1).astype(np.float64)
            ok = (tf > 0.0) & (d < nd)
            d, tf = d[ok], tf[ok]
            ok = vmask[d]
            d, tf = d[ok], tf[ok]
            if len(d) < k:
                continue
            if not np.isnan(gconst[gi]):
                cand = np.full(len(d), float(gconst[gi]))
            elif bool(c_u[e0]):
                cand = np.full(len(d), float(w_u[e0]))
            else:
                dnorm = k1 * (1.0 - b + b * pf.field_lengths[d]
                              .astype(np.float64) / avg)
                cand = float(w_u[e0]) * tf / (tf + dnorm)
            th = np.partition(cand, len(cand) - k)[len(cand) - k]
            theta = max(theta, th)

    if not np.isfinite(theta) or theta <= 0.0:
        _prune_backoff(dev)
        return fields, False

    # ---- group bounds -> per-window score bound
    scoring = (gkind == plan_ops.MUST) | (gkind == plan_ops.SHOULD)
    gb = np.where(np.isnan(gconst)[:, None], group_wb,
                  np.nan_to_num(gconst)[:, None] * group_any)[scoring]
    if plan.combine == "dismax":
        mx = gb.max(axis=0) if len(gb) else np.zeros(n_win)
        wb = mx + plan.tie * (gb.sum(axis=0) - mx)
    else:
        wb = gb.sum(axis=0) if len(gb) else np.zeros(n_win)

    # the launch's float32 sums can exceed the float64 bound by rounding:
    # keep a small margin
    keep_w = wb >= theta * (1.0 - 1e-5)
    if keep_w.all():
        _prune_backoff(dev)
        return fields, False
    ck = np.concatenate([[0], np.cumsum(keep_w)])

    out = []
    pruned = False
    for field, (wlo, whi) in zip(fields, per_field):
        blk_keep = (ck[np.minimum(whi, n_win - 1) + 1] - ck[wlo]) > 0
        if blk_keep.all():
            out.append(field)
            continue
        pruned = True
        out.append(field[:2] + tuple(a[blk_keep] for a in field[2:]))
    if pruned:
        dev._prune_fail = 0
    else:
        _prune_backoff(dev)
    return out, pruned


def empty_result(k: int):
    return (np.full(k, -np.inf, np.float32),
            np.full(k, plan_ops._SENTINEL, np.int32), 0)


def execute_bound(bp: BoundPlan, ctx, k: int, k1: float, b: float,
                  after_score: Optional[float] = None):
    """One launch for one segment -> host (vals [k], ids [k], total),
    through ONE packed readback."""
    if bp.empty:
        return empty_result(k)
    packed = plan_ops.plan_topk(
        bp.streams, bp.group_kind, bp.group_req, bp.group_const,
        ctx.live, bp.n_must, bp.n_filter, bp.msm, bonus=bp.bonus,
        tie=bp.tie, k1=k1, b=b, k=k, combine=bp.combine, packed=True,
        max_run=bp.max_run, dense_mask=launch_mask(bp, ctx),
        after_score=after_score, script_fn=bp.script_fn)
    return plan_ops.unpack_result(
        readback("search.searcher.plan_topk", packed), k)
