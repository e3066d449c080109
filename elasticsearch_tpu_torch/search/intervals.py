"""Interval matching over token streams, for the intervals query and
the span family (a copy of the jax-free
elasticsearch_tpu/search/intervals.py).

It follows the reference's intervals query (its IntervalQueryBuilder and
Lucene's minimal-interval semantics of IntervalsSource) and the classic
span queries (SpanNearQueryBuilder and the rest). The split is the
phrases' (search/phrase.py): the device filters candidate docs through
the postings blocks, and the exact minimal-interval algebra below runs
on the host over only the candidates' token rows.

An interval is (start, end), inclusive token positions. Sources compute
MINIMAL intervals (no interval contains another) per candidate row:

  - term:    every position of a term
  - match:   n terms, ordered or unordered, with max_gaps
  - any_of:  union of child intervals (minimalized)
  - all_of:  one interval from each child, ordered/unordered, max_gaps
  - not_containing / first-ending-before etc. via filters

Span queries translate onto these: span_term -> term, span_or -> any_of,
span_near -> all_of(ordered=in_order, max_gaps=slop), span_first ->
filter end < n, span_not -> drop intervals overlapping the exclude set.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Interval = Tuple[int, int]


def _minimalize(intervals: List[Interval]) -> List[Interval]:
    """Drop intervals that strictly contain another interval (Lucene keeps
    only minimal ones); result sorted by (start, end)."""
    ivs = sorted(set(intervals))
    return [a for a in ivs
            if not any(b != a and b[0] >= a[0] and b[1] <= a[1]
                       for b in ivs)]


def term_intervals(row: Sequence[int], tid: int) -> List[Interval]:
    return [(int(p), int(p)) for p in np.nonzero(
        np.asarray(row) == tid)[0]]


def match_intervals(row: Sequence[int], tids: Sequence[int],
                    ordered: bool, max_gaps: int) -> List[Interval]:
    """Minimal intervals covering all terms (ordered or any order)."""
    if not tids:
        return []
    if len(tids) == 1:
        return term_intervals(row, tids[0])
    pos_lists = [np.nonzero(np.asarray(row) == t)[0].tolist()
                 for t in tids]
    if any(not pl for pl in pos_lists):
        return []
    out: List[Interval] = []
    if ordered:
        # for each start of the first term, greedily chain the rest
        for p0 in pos_lists[0]:
            cur = p0
            ok = True
            for pl in pos_lists[1:]:
                nxt = next((p for p in pl if p > cur), None)
                if nxt is None:
                    ok = False
                    break
                cur = nxt
            if ok:
                out.append((p0, cur))
    else:
        # classic minimal-window sweep over the heads of each list
        idx = [0] * len(pos_lists)
        while True:
            heads = [pos_lists[j][idx[j]] for j in range(len(pos_lists))]
            if len(set(heads)) == len(heads):       # distinct positions
                out.append((min(heads), max(heads)))
            j_min = min(range(len(heads)), key=lambda j: heads[j])
            idx[j_min] += 1
            if idx[j_min] >= len(pos_lists[j_min]):
                break
    out = _minimalize(out)
    if max_gaps >= 0:
        n = len(tids)
        out = [(s, e) for s, e in out if (e - s + 1 - n) <= max_gaps]
    return out


def all_of_intervals(children: List[List[Interval]], ordered: bool,
                     max_gaps: int) -> List[Interval]:
    """One interval from each child; ordered children must not overlap
    and appear in sequence. Gaps measured between consecutive child
    intervals (ordered) or as window slack (unordered)."""
    if any(not c for c in children):
        return []
    out: List[Interval] = []
    if ordered:
        for s0, e0 in children[0]:
            # greedily chain the remaining children after this first
            # interval (first fit — Lucene's minimal-interval greediness)
            def rest(ci: int, prev_end: int) -> bool:
                if ci == len(children):
                    out.append((s0, prev_end))
                    return True
                for s, e in children[ci]:
                    if s > prev_end:
                        if (max_gaps >= 0
                                and (s - prev_end - 1) > max_gaps):
                            return False
                        return rest(ci + 1, e)
                return False

            rest(1, e0)
    else:
        # linear heads-sweep over the children's (sorted) interval lists —
        # the match_intervals unordered pattern lifted to intervals; the
        # itertools.product alternative is exponential per candidate doc
        lists = [sorted(c) for c in children]
        idx = [0] * len(lists)
        while True:
            heads = [lists[j][idx[j]] for j in range(len(lists))]
            s = min(h[0] for h in heads)
            e = max(h[1] for h in heads)
            width = e - s + 1
            covered = sum(min(he, e) - max(hs, s) + 1
                          for hs, he in heads)
            if max_gaps < 0 or (width - min(covered, width)) <= max_gaps:
                out.append((s, e))
            j_min = min(range(len(heads)), key=lambda j: heads[j][0])
            idx[j_min] += 1
            if idx[j_min] >= len(lists[j_min]):
                break
    return _minimalize(out)


def any_of_intervals(children: List[List[Interval]]) -> List[Interval]:
    out: List[Interval] = []
    for c in children:
        out.extend(c)
    return _minimalize(out)


def not_overlapping(include: List[Interval],
                    exclude: List[Interval]) -> List[Interval]:
    def overlaps(a: Interval, b: Interval) -> bool:
        return a[0] <= b[1] and b[0] <= a[1]
    return [iv for iv in include
            if not any(overlaps(iv, ex) for ex in exclude)]


def containing(big: List[Interval],
               small: List[Interval]) -> List[Interval]:
    """Intervals from `big` that contain at least one of `small`
    (span_containing)."""
    return [b for b in big
            if any(s[0] >= b[0] and s[1] <= b[1] for s in small)]


def within(small: List[Interval], big: List[Interval]) -> List[Interval]:
    """Intervals from `small` that lie within one of `big` (span_within)."""
    return [s for s in small
            if any(s[0] >= b[0] and s[1] <= b[1] for b in big)]


# ---------------------------------------------------------------------------
# rule tree evaluation
# ---------------------------------------------------------------------------

def evaluate_rule(rule: Dict[str, Any], row: Sequence[int],
                  term_id: Callable[[str], int],
                  expand_prefix: Callable[[str], List[int]],
                  rows: Optional[Dict[str, Sequence[int]]] = None
                  ) -> List[Interval]:
    """Evaluate an intervals rule tree for one candidate row. Nodes
    marked ``_src_field`` (field_masking_span subtrees) switch the doc's
    token row to that field's via ``rows`` — positions from the source
    field combine with the enclosing field's spans, the Lucene
    FieldMaskingSpanQuery contract (same-position subfields)."""
    (kind, spec), = ((k, v) for k, v in rule.items()
                     if k not in ("boost",))
    if (isinstance(spec, dict) and rows is not None
            and spec.get("_src_field") is not None):
        row = rows.get(str(spec["_src_field"]), row)
    if kind == "term":                        # internal: single term id
        return term_intervals(row, spec)
    if kind == "match":
        tids = spec["_tids"]
        out = match_intervals(row, tids,
                              bool(spec.get("ordered", False)),
                              int(spec.get("max_gaps", -1)))
        flt = spec.get("filter")
        if flt:
            out = _apply_filter(out, flt, row, term_id, expand_prefix,
                                rows)
        return out
    if kind == "prefix":
        tids = spec["_tids"]
        return any_of_intervals([term_intervals(row, t) for t in tids])
    if kind == "any_of":
        out = any_of_intervals([
            evaluate_rule(r, row, term_id, expand_prefix, rows)
            for r in spec.get("intervals", [])])
        flt = spec.get("filter")
        if flt:
            out = _apply_filter(out, flt, row, term_id, expand_prefix,
                                rows)
        return out
    if kind == "all_of":
        children = [evaluate_rule(r, row, term_id, expand_prefix, rows)
                    for r in spec.get("intervals", [])]
        out = all_of_intervals(children,
                               bool(spec.get("ordered", False)),
                               int(spec.get("max_gaps", -1)))
        first_end = spec.get("_first_end")
        if first_end is not None:           # span_first: end < n
            out = [iv for iv in out if iv[1] < int(first_end)]
        flt = spec.get("filter")
        if flt:
            out = _apply_filter(out, flt, row, term_id, expand_prefix,
                                rows)
        return out
    raise ValueError(f"unknown intervals rule [{kind}]")


def _apply_filter(intervals: List[Interval], flt: Dict[str, Any],
                  row, term_id, expand_prefix,
                  rows: Optional[Dict[str, Sequence[int]]] = None
                  ) -> List[Interval]:
    """ES intervals filters: not_containing / containing / not_contained_by
    / contained_by / not_overlapping. ``rows`` threads through so
    field-masked subtrees in filter position read their own field."""
    for fkind, frule in flt.items():
        other = evaluate_rule(frule, row, term_id, expand_prefix, rows)
        if fkind == "not_containing":
            intervals = [iv for iv in intervals
                         if not any(o[0] >= iv[0] and o[1] <= iv[1]
                                    for o in other)]
        elif fkind == "containing":
            intervals = containing(intervals, other)
        elif fkind == "contained_by":
            intervals = within(intervals, other)
        elif fkind == "not_contained_by":
            inside = within(intervals, other)
            intervals = [iv for iv in intervals if iv not in inside]
        elif fkind == "not_overlapping":
            intervals = not_overlapping(intervals, other)
        else:
            raise ValueError(f"unknown intervals filter [{fkind}]")
    return intervals
