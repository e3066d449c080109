"""Token filters and char filters (the port's copy of
elasticsearch_tpu/analysis/filters.py, Elasticsearch's analysis-common
set): a token filter maps a token list to a token list, a char filter
maps the raw text before the tokenizer.

Tokens are immutable here (analysis/tokenizers.py ``Token`` is a named
tuple), so ``keyword_marker`` marks a token by replacing it with a copy
whose ``keyword`` is set; every other filter rebuilds tokens exactly as
the reference's do, carrying ``keyword`` where the reference carries it.
"""

from __future__ import annotations

import functools
import re
import unicodedata
from typing import List, Optional, Set

from elasticsearch_tpu_torch.analysis.tokenizers import Token, _new_token

# Lucene's EnglishAnalyzer.ENGLISH_STOP_WORDS_SET — the `_english_` stopword
# list the reference's `stop` filter defaults to.
ENGLISH_STOP_WORDS: Set[str] = {
    "a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if", "in",
    "into", "is", "it", "no", "not", "of", "on", "or", "such", "that", "the",
    "their", "then", "there", "these", "they", "this", "to", "was", "will",
    "with",
}


class TokenFilter:
    name = "?"

    def filter(self, tokens: List[Token]) -> List[Token]:
        raise NotImplementedError


class LowercaseFilter(TokenFilter):
    name = "lowercase"

    def filter(self, tokens):
        out = []
        for t in tokens:
            low = t.term.lower()
            out.append(t if low == t.term else _new_token((low,) + t[1:]))
        return out


class UppercaseFilter(TokenFilter):
    name = "uppercase"

    def filter(self, tokens):
        return [Token(t.term.upper(), t.position, t.start_offset,
                      t.end_offset, t.keyword)
                for t in tokens]


class StopFilter(TokenFilter):
    """Removes stopwords; preserves position increments (gaps stay in the
    position numbering, as Lucene's StopFilter does by default)."""

    name = "stop"

    def __init__(self, stopwords: Optional[Set[str]] = None):
        self.stopwords = (ENGLISH_STOP_WORDS if stopwords is None
                          else set(stopwords))

    def filter(self, tokens):
        return [t for t in tokens if t.term not in self.stopwords]


class AsciiFoldingFilter(TokenFilter):
    name = "asciifolding"

    def filter(self, tokens):
        out = []
        for t in tokens:
            folded = _fold(t.term)
            out.append(t if folded == t.term
                       else _new_token((folded,) + t[1:]))
        return out


# a term's folding, stem and word parts are pure functions of the term:
# each is computed once a distinct term (the indexing chain's hot loop)
_TERM_CACHE = 1 << 17


@functools.lru_cache(maxsize=_TERM_CACHE)
def _fold(term: str) -> str:
    if term.isascii():
        return term
    folded = unicodedata.normalize("NFKD", term)
    return "".join(c for c in folded if not unicodedata.combining(c))


class LengthFilter(TokenFilter):
    name = "length"

    def __init__(self, min_length: int = 0, max_length: int = 2 ** 31 - 1):
        self.min = min_length
        self.max = max_length

    def filter(self, tokens):
        return [t for t in tokens if self.min <= len(t.term) <= self.max]


class TrimFilter(TokenFilter):
    name = "trim"

    def filter(self, tokens):
        return [Token(t.term.strip(), t.position, t.start_offset,
                      t.end_offset, t.keyword)
                for t in tokens]


class TruncateFilter(TokenFilter):
    name = "truncate"

    def __init__(self, length: int = 10):
        self.length = length

    def filter(self, tokens):
        return [Token(t.term[: self.length], t.position, t.start_offset,
                      t.end_offset, t.keyword)
                for t in tokens]


class UniqueFilter(TokenFilter):
    name = "unique"

    def filter(self, tokens):
        seen = set()
        out = []
        for t in tokens:
            if t.term not in seen:
                seen.add(t.term)
                out.append(t)
        return out


class ReverseFilter(TokenFilter):
    name = "reverse"

    def filter(self, tokens):
        return [Token(t.term[::-1], t.position, t.start_offset, t.end_offset)
                for t in tokens]


class EdgeNGramFilter(TokenFilter):
    name = "edge_ngram"

    def __init__(self, min_gram: int = 1, max_gram: int = 2):
        self.min_gram = min_gram
        self.max_gram = max_gram

    def filter(self, tokens):
        out = []
        for t in tokens:
            for size in range(self.min_gram, self.max_gram + 1):
                if size > len(t.term):
                    break
                out.append(Token(t.term[:size], t.position, t.start_offset,
                                 t.end_offset))
        return out


class ShingleFilter(TokenFilter):
    """Word n-grams (ref: ShingleTokenFilterFactory; used by the phrase
    suggester)."""

    name = "shingle"

    def __init__(self, min_shingle_size: int = 2, max_shingle_size: int = 2,
                 output_unigrams: bool = True, token_separator: str = " "):
        self.min_size = min_shingle_size
        self.max_size = max_shingle_size
        self.output_unigrams = output_unigrams
        self.sep = token_separator

    def filter(self, tokens):
        out = []
        for i, t in enumerate(tokens):
            if self.output_unigrams:
                out.append(t)
            for size in range(self.min_size, self.max_size + 1):
                if i + size > len(tokens):
                    break
                window = tokens[i : i + size]
                out.append(Token(self.sep.join(w.term for w in window),
                                 t.position, t.start_offset,
                                 window[-1].end_offset))
        return out


class PorterStemFilter(TokenFilter):
    """Porter stemming algorithm (ref: Lucene PorterStemFilter, the `stemmer`
    filter's default `english` language). Classic Porter (1980) rules."""

    name = "porter_stem"

    _VOWELS = "aeiou"

    def _cons(self, w: str, i: int) -> bool:
        ch = w[i]
        if ch in self._VOWELS:
            return False
        if ch == "y":
            return i == 0 or not self._cons(w, i - 1)
        return True

    def _measure(self, stem: str) -> int:
        """Number of VC sequences."""
        m = 0
        prev_vowel = False
        for i in range(len(stem)):
            is_v = not self._cons(stem, i)
            if prev_vowel and not is_v:
                m += 1
            prev_vowel = is_v
        return m

    def _has_vowel(self, stem: str) -> bool:
        return any(not self._cons(stem, i) for i in range(len(stem)))

    def _ends_double_cons(self, w: str) -> bool:
        return len(w) >= 2 and w[-1] == w[-2] and self._cons(w, len(w) - 1)

    def _cvc(self, w: str) -> bool:
        if len(w) < 3:
            return False
        return (self._cons(w, len(w) - 3) and not self._cons(w, len(w) - 2)
                and self._cons(w, len(w) - 1) and w[-1] not in "wxy")

    def _stem(self, w: str) -> str:
        if len(w) <= 2:
            return w
        # step 1a
        if w.endswith("sses"):
            w = w[:-2]
        elif w.endswith("ies"):
            w = w[:-2]
        elif w.endswith("ss"):
            pass
        elif w.endswith("s"):
            w = w[:-1]
        # step 1b
        if w.endswith("eed"):
            if self._measure(w[:-3]) > 0:
                w = w[:-1]
        elif w.endswith("ed") and self._has_vowel(w[:-2]):
            w = w[:-2]
            w = self._step1b_fix(w)
        elif w.endswith("ing") and self._has_vowel(w[:-3]):
            w = w[:-3]
            w = self._step1b_fix(w)
        # step 1c
        if w.endswith("y") and self._has_vowel(w[:-1]):
            w = w[:-1] + "i"
        # step 2
        for suf, rep in [("ational", "ate"), ("tional", "tion"),
                         ("enci", "ence"), ("anci", "ance"), ("izer", "ize"),
                         ("bli", "ble"), ("alli", "al"), ("entli", "ent"),
                         ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
                         ("ation", "ate"), ("ator", "ate"), ("alism", "al"),
                         ("iveness", "ive"), ("fulness", "ful"),
                         ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
                         ("biliti", "ble"), ("logi", "log")]:
            if w.endswith(suf):
                if self._measure(w[: -len(suf)]) > 0:
                    w = w[: -len(suf)] + rep
                break
        # step 3
        for suf, rep in [("icate", "ic"), ("ative", ""), ("alize", "al"),
                         ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                         ("ness", "")]:
            if w.endswith(suf):
                if self._measure(w[: -len(suf)]) > 0:
                    w = w[: -len(suf)] + rep
                break
        # step 4
        for suf in ["al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                    "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
                    "ive", "ize"]:
            if w.endswith(suf):
                stem = w[: -len(suf)]
                if self._measure(stem) > 1:
                    w = stem
                break
            if suf == "ent" and w.endswith("ion"):
                stem = w[:-3]
                if stem and stem[-1] in "st" and self._measure(stem) > 1:
                    w = stem
                break
        else:
            if w.endswith("ion"):
                stem = w[:-3]
                if stem and stem[-1] in "st" and self._measure(stem) > 1:
                    w = stem
        # step 5a
        if w.endswith("e"):
            m = self._measure(w[:-1])
            if m > 1 or (m == 1 and not self._cvc(w[:-1])):
                w = w[:-1]
        # step 5b
        if (self._ends_double_cons(w) and w.endswith("l")
                and self._measure(w) > 1):
            w = w[:-1]
        return w

    def _step1b_fix(self, w: str) -> str:
        if w.endswith(("at", "bl", "iz")):
            return w + "e"
        if self._ends_double_cons(w) and w[-1] not in "lsz":
            return w[:-1]
        if self._measure(w) == 1 and self._cvc(w):
            return w + "e"
        return w

    def filter(self, tokens):
        # keyword_marker-protected tokens pass through unstemmed; an
        # unprotected token's keyword is False, so a stem equal to its
        # term leaves the token as it was
        out = []
        for t in tokens:
            stem = t.term if t.keyword else _porter_stem(t.term)
            out.append(t if stem == t.term else _new_token((stem,) + t[1:]))
        return out


@functools.lru_cache(maxsize=_TERM_CACHE)
def _porter_stem(term: str) -> str:
    return PorterStemFilter._stem(_PORTER, term)


_PORTER = PorterStemFilter()


# ---------------------------------------------------------------------------
# Char filters (run before tokenization)
# ---------------------------------------------------------------------------

class CharFilter:
    name = "?"

    def apply(self, text: str) -> str:
        raise NotImplementedError


class HtmlStripCharFilter(CharFilter):
    name = "html_strip"

    _TAG = re.compile(r"<[^>]*>")
    _ENTITIES = {"&amp;": "&", "&lt;": "<", "&gt;": ">", "&quot;": '"',
                 "&apos;": "'", "&nbsp;": " "}

    def apply(self, text: str) -> str:
        text = self._TAG.sub(" ", text)
        for ent, rep in self._ENTITIES.items():
            text = text.replace(ent, rep)
        return text


class MappingCharFilter(CharFilter):
    name = "mapping"

    def __init__(self, mappings: dict):
        self.mappings = mappings

    def apply(self, text: str) -> str:
        for src, dst in self.mappings.items():
            text = text.replace(src, dst)
        return text


class PatternReplaceCharFilter(CharFilter):
    name = "pattern_replace"

    def __init__(self, pattern: str, replacement: str = ""):
        self.pattern = re.compile(pattern)
        self.replacement = replacement

    def apply(self, text: str) -> str:
        return self.pattern.sub(self.replacement, text)


# ---------------------------------------------------------------------------
# analysis-common extras + language-analysis plugin equivalents
# ---------------------------------------------------------------------------

class SynonymFilter(TokenFilter):
    """Synonym expansion at the same position (ref: analysis-common
    SynonymTokenFilterFactory, Solr synonyms format: "a, b, c" equivalence
    groups and "a, b => c" explicit rules)."""

    name = "synonym"

    def __init__(self, rules: List[str]):
        self.expand: dict = {}
        for rule in rules or []:
            if "=>" in rule:
                lhs, _, rhs = rule.partition("=>")
                targets = [t.strip() for t in rhs.split(",") if t.strip()]
                for src in (t.strip() for t in lhs.split(",")):
                    if src:
                        self.expand[src] = targets
            else:
                group = [t.strip() for t in rule.split(",") if t.strip()]
                for src in group:
                    self.expand[src] = group

    def filter(self, tokens):
        out: List[Token] = []
        for t in tokens:
            targets = self.expand.get(t.term)
            if targets is None:
                out.append(t)
                continue
            # all synonyms emit at the SAME position (equivalence class)
            for term in targets:
                out.append(Token(term, t.position, t.start_offset,
                                 t.end_offset))
        return out


class ElisionFilter(TokenFilter):
    """Strips leading elided articles (l', d', …) — ref: analysis-common
    ElisionTokenFilterFactory, French defaults."""

    name = "elision"
    DEFAULT_ARTICLES = {"l", "m", "t", "qu", "n", "s", "j", "d", "c",
                        "jusqu", "quoiqu", "lorsqu", "puisqu"}

    def __init__(self, articles: Optional[Set[str]] = None):
        self.articles = articles or self.DEFAULT_ARTICLES

    def filter(self, tokens):
        out = []
        for t in tokens:
            term = t.term
            for sep in ("'", "’"):
                i = term.find(sep)
                if 0 < i and term[:i].lower() in self.articles:
                    term = term[i + 1:]
                    break
            out.append(Token(term, t.position, t.start_offset,
                             t.end_offset, t.keyword))
        return out


class ApostropheFilter(TokenFilter):
    """Strips everything after an apostrophe (ref: analysis-common
    ApostropheFilterFactory, Turkish)."""

    name = "apostrophe"

    def filter(self, tokens):
        out = []
        for t in tokens:
            i = t.term.find("'")
            term = t.term[:i] if i >= 0 else t.term
            out.append(Token(term, t.position, t.start_offset,
                             t.end_offset, t.keyword))
        return out


class DecimalDigitFilter(TokenFilter):
    """Folds unicode digits to latin 0-9 (ref: DecimalDigitFilterFactory)."""

    name = "decimal_digit"

    def filter(self, tokens):
        out = []
        for t in tokens:
            term = "".join(str(unicodedata.digit(ch)) if ch.isdigit()
                           else ch for ch in t.term)
            out.append(Token(term, t.position, t.start_offset,
                             t.end_offset, t.keyword))
        return out


class KeywordMarkerFilter(TokenFilter):
    """Marks terms as keywords so the stemmers leave them as they are
    (Elasticsearch's keyword_marker): a listed term's token is replaced
    by a copy with ``keyword`` set."""

    name = "keyword_marker"

    def __init__(self, keywords: Set[str]):
        self.keywords = keywords

    def filter(self, tokens):
        return [t._replace(keyword=True) if t.term in self.keywords else t
                for t in tokens]


class WordDelimiterGraphFilter(TokenFilter):
    """Splits on case changes / non-alphanumerics / letter-digit
    boundaries (ref: analysis-common WordDelimiterGraphFilterFactory —
    generate_word_parts + catenate options subset)."""

    name = "word_delimiter_graph"

    def __init__(self, generate_word_parts: bool = True,
                 catenate_all: bool = False,
                 preserve_original: bool = False):
        self.generate_word_parts = generate_word_parts
        self.catenate_all = catenate_all
        self.preserve_original = preserve_original

    @staticmethod
    @functools.lru_cache(maxsize=_TERM_CACHE)
    def _word_parts(term: str) -> tuple:
        """Unicode-aware sub-word splitting: non-alphanumerics delimit,
        letter↔digit transitions split, lower→Upper splits, and an
        UPPER run followed by lower keeps its last letter with the next
        part (XMLHttp → XML, Http) — Lucene WordDelimiterIterator rules."""
        parts: List[str] = []
        cur = ""
        prev = None                           # "u" | "l" | "d"
        for ch in term:
            if ch.isdigit():
                kind = "d"
            elif ch.isalpha():
                kind = "u" if ch.isupper() else "l"
            else:
                if cur:
                    parts.append(cur)
                cur, prev = "", None
                continue
            if not cur:
                cur, prev = ch, kind
                continue
            if (prev == "l" and kind == "u") or (
                    "d" in (prev, kind) and prev != kind):
                parts.append(cur)
                cur = ch
            elif prev == "u" and kind == "l" and len(cur) > 1 and all(
                    c.isupper() for c in cur):
                parts.append(cur[:-1])
                cur = cur[-1] + ch
            else:
                cur += ch
            prev = kind
        if cur:
            parts.append(cur)
        return tuple(parts)   # cached: shared, so immutable

    def filter(self, tokens):
        out: List[Token] = []
        shift = 0        # split parts consume positions; later tokens shift
        for t in tokens:
            pos = t.position + shift
            parts = self._word_parts(t.term)
            emitted = False
            if self.preserve_original or len(parts) <= 1:
                out.append(Token(t.term, pos, t.start_offset, t.end_offset,
                                 t.keyword))
                emitted = True
            if len(parts) > 1:
                if self.generate_word_parts:
                    # parts take incrementing positions so phrase queries
                    # match across the split (PowerShot → power@p,
                    # shot@p+1) and FOLLOWING tokens shift accordingly —
                    # Lucene's posIncrement semantics
                    for i, p in enumerate(parts):
                        out.append(Token(p, pos + i, t.start_offset,
                                         t.end_offset))
                    shift += len(parts) - 1
                    emitted = True
                if self.catenate_all:
                    out.append(Token("".join(parts), pos,
                                     t.start_offset, t.end_offset))
                    emitted = True
            if not emitted:
                out.append(Token(t.term, pos, t.start_offset, t.end_offset,
                                 t.keyword))
        return out


class CjkBigramFilter(TokenFilter):
    """CJK bigrams (ref: analysis-common CJKBigramFilterFactory): runs of
    CJK codepoints emit overlapping bigrams; non-CJK tokens pass through."""

    name = "cjk_bigram"

    @staticmethod
    def _is_cjk(ch: str) -> bool:
        cp = ord(ch)
        return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
                or 0x3040 <= cp <= 0x30FF or 0xAC00 <= cp <= 0xD7AF)

    def __init__(self, output_unigrams: bool = False):
        self.output_unigrams = output_unigrams

    def filter(self, tokens):
        out: List[Token] = []
        shift = 0        # bigrams consume positions; later tokens shift
        for t in tokens:
            pos = t.position + shift
            if all(self._is_cjk(c) for c in t.term) and len(t.term) >= 2:
                # bigrams take incrementing positions from the source
                # token's and shift everything after (posIncrement model)
                for i in range(len(t.term) - 1):
                    out.append(Token(t.term[i:i + 2], pos + i,
                                     t.start_offset + i,
                                     t.start_offset + i + 2))
                if self.output_unigrams:
                    for i, ch in enumerate(t.term):
                        out.append(Token(ch, pos + i,
                                         t.start_offset + i,
                                         t.start_offset + i + 1))
                shift += len(t.term) - 2
            else:
                out.append(Token(t.term, pos, t.start_offset, t.end_offset,
                                 t.keyword))
        return out


def soundex(word: str) -> str:
    """Classic Soundex (ref: plugins/analysis-phonetic encoder family)."""
    word = re.sub(r"[^a-z]", "", word.lower())
    if not word:
        return ""
    codes = {"b": "1", "f": "1", "p": "1", "v": "1",
             "c": "2", "g": "2", "j": "2", "k": "2", "q": "2",
             "s": "2", "x": "2", "z": "2",
             "d": "3", "t": "3", "l": "4", "m": "5", "n": "5", "r": "6"}
    first = word[0]
    out = [first.upper()]
    prev = codes.get(first, "")
    for ch in word[1:]:
        code = codes.get(ch, "")
        if code and code != prev:
            out.append(code)
        if ch not in "hw":
            prev = code
        if len(out) == 4:
            break
    return ("".join(out) + "000")[:4]


def metaphone(word: str, max_len: int = 4) -> str:
    """Simplified original Metaphone — enough to group the classic
    spelling families (smith/smyth, catherine/kathryn)."""
    w = re.sub(r"[^a-z]", "", word.lower())
    if not w:
        return ""
    # common prefixes
    for pre, rep in (("kn", "n"), ("gn", "n"), ("pn", "n"), ("wr", "r"),
                     ("ae", "e"), ("x", "s"), ("wh", "w")):
        if w.startswith(pre):
            w = rep + w[len(pre):]
            break
    out = []
    i = 0
    vowels = "aeiou"
    while i < len(w) and len(out) < max_len:
        c = w[i]
        nxt = w[i + 1] if i + 1 < len(w) else ""
        if c in vowels:
            if i == 0:
                out.append(c.upper())
        elif c == "b":
            if not (i == len(w) - 1 and i > 0 and w[i - 1] == "m"):
                out.append("B")
        elif c == "c":
            if nxt == "h":
                out.append("X")
                i += 1
            elif nxt in "iey":
                out.append("S")
            else:
                out.append("K")
        elif c == "d":
            if nxt == "g" and i + 2 < len(w) and w[i + 2] in "iey":
                out.append("J")
                i += 2
            else:
                out.append("T")
        elif c == "g":
            if nxt == "h" and i + 2 < len(w) and w[i + 2] not in vowels:
                i += 1
            elif nxt in "iey":
                out.append("J")
            else:
                out.append("K")
        elif c == "h":
            if i > 0 and w[i - 1] in vowels and nxt not in vowels:
                pass
            else:
                out.append("H")
        elif c == "k":
            if not (i > 0 and w[i - 1] == "c"):
                out.append("K")
        elif c == "p":
            if nxt == "h":
                out.append("F")
                i += 1
            else:
                out.append("P")
        elif c == "q":
            out.append("K")
        elif c == "s":
            if nxt == "h":
                out.append("X")
                i += 1
            elif nxt == "i" and i + 2 < len(w) and w[i + 2] in "oa":
                out.append("X")
            else:
                out.append("S")
        elif c == "t":
            if nxt == "h":
                out.append("0")
                i += 1
            elif nxt == "i" and i + 2 < len(w) and w[i + 2] in "oa":
                out.append("X")
            else:
                out.append("T")
        elif c == "v":
            out.append("F")
        elif c == "w" or c == "y":
            if nxt in vowels:
                out.append(c.upper())
        elif c == "x":
            out.append("KS")
        elif c == "z":
            out.append("S")
        elif c in "flmnr":
            out.append(c.upper())
        if i < len(w) - 1 and w[i] == w[i + 1]:
            i += 1                       # collapse doubles
        i += 1
    return "".join(out)[:max_len]


class PhoneticFilter(TokenFilter):
    """Phonetic encoding (ref: plugins/analysis-phonetic
    PhoneticTokenFilterFactory — soundex/metaphone encoders; `replace`
    keeps or replaces the original token)."""

    name = "phonetic"

    def __init__(self, encoder: str = "metaphone", replace: bool = True):
        if encoder not in ("metaphone", "soundex"):
            raise ValueError(f"unknown phonetic encoder [{encoder}]")
        self.encode = metaphone if encoder == "metaphone" else soundex
        self.replace = replace

    def filter(self, tokens):
        out = []
        for t in tokens:
            enc = self.encode(t.term)
            if not self.replace:
                out.append(t)
            if enc:
                out.append(Token(enc, t.position, t.start_offset,
                                 t.end_offset))
        return out
