"""Query-plan compiler (counterpart of elasticsearch_tpu/search/plan.py):
QueryBuilder trees -> fused plan launches of ops/plan.py.

A query is plannable when it decomposes into postings **groups**:
clauses scored or filtered from a text or keyword field's postings
(match, multi_match, term, terms, constant_score over those), each with
its own presence requirement (operator=and / minimum_should_match inside
the clause), composed by one level of bool occur semantics (must /
filter / should / must_not + minimum_should_match), or a top-level
dis_max / multi_match over plannable children. Compilation happens once
per shard (terms analyzed, idf from shard-level stats); binding resolves
term -> postings-block ids per segment.

Left for later slices, as the reference's: dense column factors (range,
exists, ids, match_all) with the ``dense_mask`` column and the constant
``bonus`` they give; ``_convert_filters`` (large FILTER / MUST_NOT
groups as cached dense masks); block-max pruning (``_prune_fields``,
for ``track_total_hits`` thresholds); ``script_score``. Without the
filter conversion every FILTER and MUST_NOT group is evaluated in the
launch, with the same set semantics, so the hits do not change.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.ops import bm25 as bm25_ops
from elasticsearch_tpu_torch.ops import plan as plan_ops
from elasticsearch_tpu_torch.ops.device import block_bucket, readback
from elasticsearch_tpu_torch.search import queries as q
from elasticsearch_tpu_torch.search.fastpath import SliceUnsupported

NAN = float("nan")
_NEVER = 1 << 30  # requirement no group can meet (pad groups)


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
    n_must: int                           # MUST groups
    n_filter: int                         # FILTER groups
    msm: int
    combine: str = "sum"
    tie: float = 0.0

    def postings_required(self) -> bool:
        """True iff every passing doc must match >= 1 group: the launch
        sees only docs present in the gathered postings."""
        return self.n_must >= 1 or self.n_filter >= 1 or self.msm >= 1


def _idf(searcher, field: str, term: str) -> float:
    doc_count, _ = searcher.stats.field_stats(field)
    df = searcher.stats.doc_freq(field, term)
    return bm25_ops.idf(df, doc_count) if df > 0 else 0.0


# ---------------------------------------------------------------------------
# per-clause group builders (return None when not plannable)
# ---------------------------------------------------------------------------

def _group_for_match(node: "q.MatchQuery", searcher, kind: int,
                     scale: float) -> Optional[GroupPlan]:
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
    term = str(node.value)
    if searcher.mapper.fields.get(node.field) == "text":
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

def compile_plan(query, searcher,
                 post_filter=None) -> Optional[LogicalPlan]:
    """Compile a query (+ optional post_filter folded in as a filter:
    valid when no aggregations run) into a LogicalPlan, or None when the
    tree needs what this slice does not have."""
    plan = _compile_tree(query, searcher)
    if plan is None:
        return None
    if post_filter is not None:
        g = _group_for_clause(post_filter, searcher, plan_ops.FILTER, 1.0)
        if g is None:
            return None
        g.const_score = NAN
        plan.groups.append(g)
        plan.n_filter += 1
    if not plan.postings_required():
        return None
    # negative boosts would feed negative contributions into the
    # reference's cumsum/cummax segmented sums; it sends them to its
    # dense executor, which is a later slice here
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
        return LogicalPlan([g], 1, 0, 0)
    return None


def _compile_bool(node: "q.BoolQuery", searcher,
                  boost: float) -> Optional[LogicalPlan]:
    groups: List[GroupPlan] = []
    n_must = n_filter = 0
    for clause in node.must:
        g = _group_for_clause(clause, searcher, plan_ops.MUST, boost)
        if g is None:
            return None
        groups.append(g)
        n_must += 1
    for clause in node.filter:
        g = _group_for_clause(clause, searcher, plan_ops.FILTER, 1.0)
        if g is None:
            return None
        g.const_score = NAN   # filters never score
        groups.append(g)
        n_filter += 1
    for clause in node.must_not:
        g = _group_for_clause(clause, searcher, plan_ops.MUST_NOT, 1.0)
        if g is None:
            return None
        g.const_score = NAN
        groups.append(g)
    for clause in node.should:
        g = _group_for_clause(clause, searcher, plan_ops.SHOULD, boost)
        if g is None:
            return None
        groups.append(g)

    if node.minimum_should_match is None:
        msm = 1 if (node.should and n_must + n_filter == 0) else 0
    else:
        msm = q.parse_minimum_should_match(
            node.minimum_should_match, len(node.should))
    if node.should and msm > len(node.should):
        msm = len(node.should)
    return LogicalPlan(groups, n_must, n_filter, msm)


def _compile_multi_match(node: "q.MultiMatchQuery", searcher,
                         boost: float) -> Optional[LogicalPlan]:
    fields = node.fields
    if not fields or fields == ["*"]:
        fields = [name for name, ft in searcher.mapper.fields.items()
                  if ft == "text"]
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
        return LogicalPlan(groups, 0, 0, 1, combine="sum")
    if node.type == "best_fields":
        return LogicalPlan(groups, 0, 0, 1, combine="dismax",
                           tie=node.tie_breaker)
    return None   # cross_fields / phrase types: later slices


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
    return LogicalPlan(groups, 0, 0, 1, combine="dismax",
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
    n_must: int
    n_filter: int
    msm: int
    tie: float
    combine: str
    # bound on a doc's run in the sorted postings: one entry per term
    # entry of the plan (ops/bm25.py scan_run_bound)
    max_run: int
    empty: bool = False   # no query term exists in this segment


def bind_plan(plan: LogicalPlan, ctx) -> BoundPlan:
    """Resolve terms -> block ids against one segment (ctx:
    SegmentContext). Selection widths bucket to powers of two
    (ops/device.py block_bucket), so they take O(log) values."""
    ngroups = len(plan.groups)
    # group and subgroup ids share the low 32 bits of the launch's sort
    # key, 16 bits each (pad entries carry group = ngroups)
    if ngroups >= plan_ops.GROUP_LIMIT or any(
            t.sub >= plan_ops.GROUP_LIMIT for g in plan.groups
            for t in g.terms):
        raise SliceUnsupported(
            f"a plan holds fewer than {plan_ops.GROUP_LIMIT} clauses and "
            f"fewer than {plan_ops.GROUP_LIMIT} distinct terms per clause")
    by_field: Dict[str, List[Tuple[int, int, float, bool, str]]] = {}
    for gi, g in enumerate(plan.groups):
        for t in g.terms:
            by_field.setdefault(t.field, []).append(
                (gi, t.sub, t.weight, t.const, t.term))

    streams: List[plan_ops.FieldStream] = []
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
        n = block_bucket(tot)
        sel = np.full(n, dp.zero_block, np.int32)
        sel[:tot] = np.asarray(starts, np.int64)[rep] + offs
        grp = np.full(n, ngroups, np.int32)   # pads: clipped; tf=0: inert
        grp[:tot] = np.asarray(egrp, np.int32)[rep]
        sub_a = np.zeros(n, np.int32)
        sub_a[:tot] = np.asarray(esub, np.int32)[rep]
        w_a = np.zeros(n, np.float32)
        w_a[:tot] = np.asarray(ew, np.float32)[rep]
        c_a = np.zeros(n, bool)
        c_a[:tot] = np.asarray(econst, bool)[rep]
        streams.append(plan_ops.FieldStream(
            dp.block_docids, dp.block_tfs, dp.doc_lens,
            ctx.stats.field_stats(fname)[1], sel, grp, sub_a, w_a, c_a))

    gpad = max(4, block_bucket(max(1, ngroups)) if ngroups else 4)
    kind = np.full(gpad, plan_ops.FILTER, np.int32)
    req = np.full(gpad, _NEVER, np.int32)
    const = np.full(gpad, NAN, np.float32)
    for gi, g in enumerate(plan.groups):
        kind[gi] = g.kind
        req[gi] = g.req
        const[gi] = g.const_score
    # pad groups: FILTER with unreachable req — never present, and absent
    # FILTER groups don't block (n_filter counts only real groups)
    return BoundPlan(streams, kind, req, const, plan.n_must, plan.n_filter,
                     plan.msm, plan.tie, plan.combine,
                     bm25_ops.scan_run_bound(n_entries), empty=not streams)


def empty_result(k: int):
    return (np.full(k, -np.inf, np.float32),
            np.full(k, plan_ops._SENTINEL, np.int32), 0)


def execute_bound(bp: BoundPlan, ctx, k: int, k1: float, b: float):
    """One launch for one segment -> host (vals [k], ids [k], total),
    through ONE packed readback."""
    if bp.empty:
        return empty_result(k)
    packed = plan_ops.plan_topk(
        bp.streams, bp.group_kind, bp.group_req, bp.group_const,
        ctx.live, bp.n_must, bp.n_filter, bp.msm, tie=bp.tie, k1=k1, b=b,
        k=k, combine=bp.combine, packed=True, max_run=bp.max_run)
    return plan_ops.unpack_result(
        readback("search.searcher.plan_topk", packed), k)
