"""Suggesters: term, phrase and completion (counterpart of
elasticsearch_tpu/search/suggest.py).

The term suggester proposes, per analyzed token of the text, the terms
of the field's dictionary within ``max_edits`` edits (sharing the first
``prefix_length`` chars), scored 1 - distance / longer length, then by
doc frequency; the phrase suggester corrects a whole phrase by a beam
over each token's candidates within ``max_errors``; the completion
suggester answers a prefix from a ``completion`` field's weighted prefix
index (index/segment.py ``CompletionValues``), else from the sorted term
dictionary by doc frequency.

Every candidate comes from the shard's term dictionaries on the host:
suggesters are dictionary problems, not scoring problems, so nothing
here touches the device. The text analyzes with the field's search
analyzer.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from elasticsearch_tpu_torch.search.queries import (_edit_distance_within,
                                                    _expand_prefix)


class _TermDict:
    """The union of the shard's term dictionaries of one field: the
    sorted terms (prefix ranges) and their summed doc freqs."""

    def __init__(self, searchers, field: str):
        freqs: Dict[str, int] = {}
        for _, searcher in searchers:
            for seg in searcher.segments:
                pf = seg.postings.get(field)
                if pf is None:
                    continue
                for tid, term in enumerate(pf.terms):
                    freqs[term] = freqs.get(term, 0) + int(pf.doc_freq[tid])
        self.freqs = freqs
        self.sorted_terms = sorted(freqs)

    def candidates_for(self, prefix: str) -> List[str]:
        if not prefix:
            return self.sorted_terms
        return _expand_prefix(self.sorted_terms, prefix,
                              len(self.sorted_terms))


def _term_candidates(token: str, tdict: _TermDict, max_edits: int,
                     prefix_length: int, min_word_length: int,
                     size: int) -> List[Dict[str, Any]]:
    if len(token) < min_word_length:
        return []
    out: List[Tuple[float, int, str]] = []
    for term in tdict.candidates_for(token[:prefix_length]):
        if term == token or abs(len(term) - len(token)) > max_edits:
            continue
        d = _edit_distance_within(token, term, max_edits)
        if d <= max_edits:
            score = 1.0 - d / max(len(token), len(term))
            out.append((score, tdict.freqs[term], term))
    out.sort(key=lambda e: (-e[0], -e[1], e[2]))
    return [{"text": t, "score": round(s, 6), "freq": df}
            for s, df, t in out[:size]]


def compute_suggest(spec: Dict[str, Any], searchers) -> Dict[str, Any]:
    """``spec``: {"text": global text?, name: {"text"?, "term" | "phrase"
    | "completion": {...}}}; ``searchers``: [(index, ShardSearcher)].
    Returns the response's ``suggest`` section."""
    global_text = spec.get("text")
    out: Dict[str, Any] = {}
    mapper = searchers[0][1].mapper if searchers else None
    for name, entry in spec.items():
        if name == "text" or not isinstance(entry, dict):
            continue
        text = entry.get("text", global_text) or ""
        if "term" in entry:
            out[name] = _term_suggest(text, entry["term"], searchers, mapper)
        elif "phrase" in entry:
            out[name] = _phrase_suggest(text, entry["phrase"], searchers,
                                        mapper)
        elif "completion" in entry:
            out[name] = _completion_suggest(
                entry.get("prefix", text), entry["completion"], searchers)
    return out


def _field_analyzer(mapper, field: str):
    """The suggested field's search analyzer."""
    return mapper.search_analyzer(mapper.field_type(field))


def _term_suggest(text: str, cfg: Dict[str, Any], searchers, mapper):
    field = cfg["field"]
    size = int(cfg.get("size", 5))
    max_edits = int(cfg.get("max_edits", 2))
    prefix_length = int(cfg.get("prefix_length", 1))
    min_word_length = int(cfg.get("min_word_length", 4))
    suggest_mode = cfg.get("suggest_mode", "missing")
    tdict = _TermDict(searchers, field)
    entries = []
    for tok in _field_analyzer(mapper, field).analyze(text):
        existing_df = tdict.freqs.get(tok.term, 0)
        if suggest_mode == "missing" and existing_df > 0:
            options: List[Dict[str, Any]] = []
        else:
            options = _term_candidates(tok.term, tdict, max_edits,
                                       prefix_length, min_word_length, size)
            if suggest_mode == "popular":
                options = [o for o in options if o["freq"] > existing_df]
        entries.append({
            "text": tok.term, "offset": tok.start_offset,
            "length": tok.end_offset - tok.start_offset,
            "options": options,
        })
    return entries


def _phrase_suggest(text: str, cfg: Dict[str, Any], searchers, mapper):
    field = cfg["field"]
    size = int(cfg.get("size", 5))
    max_errors = float(cfg.get("max_errors", 1.0))
    tdict = _TermDict(searchers, field)
    toks = _field_analyzer(mapper, field).analyze(text)
    if not toks:
        return [{"text": text, "offset": 0, "length": len(text),
                 "options": []}]
    # each token's best corrections (a known token corrects to itself)
    per_token: List[List[Tuple[str, float]]] = []
    any_correction = False
    for tok in toks:
        if tdict.freqs.get(tok.term, 0) > 0:
            per_token.append([(tok.term, 1.0)])
        else:
            cands = _term_candidates(tok.term, tdict, 2, 1, 1, 3)
            if cands:
                any_correction = True
                per_token.append([(c["text"], c["score"]) for c in cands])
            else:
                per_token.append([(tok.term, 0.1)])
    options: List[Dict[str, Any]] = []
    if any_correction:
        budget = max(1, int(max_errors) if max_errors >= 1
                     else int(len(toks) * max_errors) or 1)
        # a beam over the tokens' candidates, within the error budget
        beams: List[Tuple[List[str], float, int]] = [([], 1.0, 0)]
        for ti, cands in enumerate(per_token):
            new_beams = []
            orig = toks[ti].term
            for words, score, errs in beams:
                for w, s in cands[:size]:
                    e = errs + (1 if w != orig else 0)
                    if e > budget:
                        continue
                    new_beams.append((words + [w], score * s, e))
            new_beams.sort(key=lambda b: -b[1])
            beams = new_beams[:max(size * 2, 10)]
        seen = set()
        for words, score, errs in beams:
            phrase = " ".join(words)
            if phrase in seen or errs == 0:
                continue
            seen.add(phrase)
            options.append({"text": phrase, "score": round(score, 6)})
            if len(options) >= size:
                break
    return [{"text": text, "offset": 0, "length": len(text),
             "options": options}]


def _completion_suggest(prefix: str, cfg: Dict[str, Any], searchers):
    field = cfg["field"]
    size = int(cfg.get("size", 5))
    # category contexts: an entry must carry EVERY requested value
    ctx_filter = frozenset(
        f"{name}={v}"
        for name, vals in (cfg.get("contexts") or {}).items()
        for v in ([vals] if isinstance(vals, str) else vals))
    # a completion field's segments answer from its prefix index; a field
    # without one from the term dictionary below
    best: Dict[str, Tuple[float, str]] = {}
    used_index = False
    for _, searcher in searchers:
        for seg in searcher.segments:
            cv = seg.completions.get(field)
            if cv is None:
                continue
            used_index = True
            for i in cv.top_k(prefix, size,
                              context_filter=ctx_filter or None,
                              live=seg.live):
                text = cv.inputs[i]
                w = float(cv.weights[i])
                doc = seg.stored.ids[int(cv.doc_of[i])]
                if text not in best or w > best[text][0]:
                    best[text] = (w, doc)
    if used_index:
        options = [{"text": t, "_id": doc, "score": w}
                   for t, (w, doc) in sorted(best.items(),
                                             key=lambda e: (-e[1][0], e[0]))
                   ][:size]
        return [{"text": prefix, "offset": 0, "length": len(prefix),
                 "options": options}]
    scored: Dict[str, int] = {}
    for _, searcher in searchers:
        for seg in searcher.segments:
            pf = seg.postings.get(field)
            kv = seg.keywords.get(field)
            terms = (pf.terms if pf is not None
                     else kv.terms if kv is not None else [])
            for t in _expand_prefix(terms, prefix, size * 8):
                if pf is not None:
                    scored[t] = scored.get(t, 0) + int(
                        pf.doc_freq[pf.term_id(t)])
                else:
                    scored[t] = scored.get(t, 0) + 1
    options = [{"text": t, "score": float(df)} for t, df in
               sorted(scored.items(), key=lambda e: (-e[1], e[0]))[:size]]
    return [{"text": prefix, "offset": 0, "length": len(prefix),
             "options": options}]
