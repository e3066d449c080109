"""Tokenizers: text -> Tokens (the port's copy of
elasticsearch_tpu/analysis/tokenizers.py): standard, whitespace, keyword,
letter, pattern, ngram and edge_ngram. Each yields Token(term, position,
start_offset, end_offset, keyword).

Host-side: tokenization happens at index and query time on the CPU; only
term ids and postings reach the device. The standard tokenizer's ASCII
path splits with one regular expression (``_ascii_tokens``), and the
indexer may take an ASCII value's terms alone (``TermRun``).
"""

from __future__ import annotations

import functools
import itertools
import re
import sys
import unicodedata
from typing import List, NamedTuple


class Token(NamedTuple):
    term: str
    position: int
    start_offset: int
    end_offset: int
    # keyword_marker's protection from the stemmers (Lucene's
    # KeywordAttribute); a filter that rebuilds a token carries it
    keyword: bool = False


def _is_word_char(ch: str) -> bool:
    cat = unicodedata.category(ch)
    # letters, digits and combining marks continue a token (approximates
    # Lucene's UAX#29 StandardTokenizer word rules)
    return cat[0] in ("L", "N") or cat in ("Mn", "Mc")


# longer runs of word characters are dropped, as the reference does
MAX_TOKEN_LENGTH = 255

# the word characters of ASCII text: its letters and digits, the only
# ASCII characters whose category is L*, N*, Mn or Mc; split keeps the
# runs at the odd places, between the gaps
_ASCII_WORD_SPLIT = re.compile(r"([A-Za-z0-9]+)")
# a Token from its 5-tuple, without the named tuple's Python __new__
_new_token = functools.partial(tuple.__new__, Token)


@functools.lru_cache(maxsize=1)
def _word_run() -> "re.Pattern":
    """A run of word characters (``_is_word_char``) over all of Unicode
    as one character class, built at the first non-ASCII text."""
    ranges = []
    start = None
    for cp in range(sys.maxunicode + 2):
        word = cp <= sys.maxunicode and _is_word_char(chr(cp))
        if word and start is None:
            start = cp
        elif not word and start is not None:
            ranges.append(f"\\U{start:08x}-\\U{cp - 1:08x}")
            start = None
    return re.compile("[" + "".join(ranges) + "]+")


def _ascii_tokens(text: str,
                  max_token_length: int = MAX_TOKEN_LENGTH) -> List[Token]:
    """The tokens of an ASCII text: its runs of letters and digits, each
    one's offsets the running sums of the lengths of the gaps and runs
    before it, runs longer than ``max_token_length`` dropped; no Python
    frame a token."""
    parts = _ASCII_WORD_SPLIT.split(text)
    ends = list(itertools.accumulate(map(len, parts)))
    terms, starts, ends = parts[1::2], ends[0::2], ends[1::2]
    if terms and max(map(len, terms)) > max_token_length:
        kept = [i for i, t in enumerate(terms)
                if len(t) <= max_token_length]
        terms = [terms[i] for i in kept]
        starts = [starts[i] for i in kept]
        ends = [ends[i] for i in kept]
    return list(map(_new_token, zip(terms, range(len(terms)), starts,
                                    ends, itertools.repeat(False))))


class TermRun:
    """The tokens of one ASCII text value as the indexer reads them: its
    terms at positions 0 .. n-1 (``terms``), with the Token objects and
    their offsets made only when something asks for them (iterating or
    indexing the run)."""

    __slots__ = ("text", "terms", "_tokens")

    def __init__(self, text: str):
        self.text = text
        terms = _ASCII_WORD_SPLIT.findall(text)
        if terms and max(map(len, terms)) > MAX_TOKEN_LENGTH:
            terms = [t for t in terms if len(t) <= MAX_TOKEN_LENGTH]
        self.terms = terms
        self._tokens: List[Token] = None

    def tokens(self) -> List[Token]:
        if self._tokens is None:
            self._tokens = _ascii_tokens(self.text)
        return self._tokens

    def __len__(self):
        return len(self.terms)

    def __iter__(self):
        return iter(self.tokens())

    def __getitem__(self, i):
        return self.tokens()[i]

    def __eq__(self, other):
        return self.tokens() == list(other)


class Tokenizer:
    name = "?"

    def tokenize(self, text: str) -> List[Token]:
        raise NotImplementedError


class StandardTokenizer(Tokenizer):
    """UAX#29-approximate word-boundary tokenizer (Lucene
    StandardTokenizer): splits on non-alphanumerics."""

    name = "standard"

    def __init__(self, max_token_length: int = MAX_TOKEN_LENGTH):
        self.max_token_length = max_token_length

    def tokenize(self, text: str) -> List[Token]:
        if text.isascii():
            return _ascii_tokens(text, self.max_token_length)
        out: List[Token] = []
        pos = 0
        for m in _word_run().finditer(text):
            start, end = m.span()
            if end - start <= self.max_token_length:
                out.append(_new_token((m.group(), pos, start, end, False)))
                pos += 1
        return out


class WhitespaceTokenizer(Tokenizer):
    name = "whitespace"

    def tokenize(self, text: str) -> List[Token]:
        return [_new_token((m.group(), pos, m.start(), m.end(), False))
                for pos, m in enumerate(re.finditer(r"\S+", text))]


class KeywordTokenizer(Tokenizer):
    """The whole input as one token."""

    name = "keyword"

    def tokenize(self, text: str) -> List[Token]:
        if not text:
            return []
        return [Token(text, 0, 0, len(text))]


class LetterTokenizer(Tokenizer):
    """Runs of letters (Unicode category L*)."""

    name = "letter"

    def tokenize(self, text: str) -> List[Token]:
        out = []
        pos = 0
        start = None
        for i, ch in enumerate(text):
            if unicodedata.category(ch)[0] == "L":
                if start is None:
                    start = i
            elif start is not None:
                out.append(Token(text[start:i], pos, start, i))
                pos += 1
                start = None
        if start is not None:
            out.append(Token(text[start:], pos, start, len(text)))
        return out


class PatternTokenizer(Tokenizer):
    """Splits on a regular expression (``\\W+`` by default, as
    Elasticsearch's)."""

    name = "pattern"

    def __init__(self, pattern: str = r"\W+"):
        self.pattern = re.compile(pattern)

    def tokenize(self, text: str) -> List[Token]:
        out = []
        pos = 0
        last = 0
        for m in self.pattern.finditer(text):
            start = m.start()
            if start > last:
                out.append(_new_token((text[last:start], pos, last, start,
                                       False)))
                pos += 1
            last = m.end()
        if last < len(text):
            out.append(Token(text[last:], pos, last, len(text)))
        return out


class NGramTokenizer(Tokenizer):
    name = "ngram"

    def __init__(self, min_gram: int = 1, max_gram: int = 2):
        self.min_gram = min_gram
        self.max_gram = max_gram

    def tokenize(self, text: str) -> List[Token]:
        out = []
        pos = 0
        for start in range(len(text)):
            for size in range(self.min_gram, self.max_gram + 1):
                end = start + size
                if end > len(text):
                    break
                out.append(Token(text[start:end], pos, start, end))
                pos += 1
        return out


class EdgeNGramTokenizer(Tokenizer):
    name = "edge_ngram"

    def __init__(self, min_gram: int = 1, max_gram: int = 2):
        self.min_gram = min_gram
        self.max_gram = max_gram

    def tokenize(self, text: str) -> List[Token]:
        out = []
        for pos, size in enumerate(range(self.min_gram, self.max_gram + 1)):
            if size > len(text):
                break
            out.append(Token(text[:size], pos, 0, size))
        return out
