"""The standard tokenizer (counterpart of elasticsearch_tpu/analysis/tokenizers.py
``StandardTokenizer._tokenize_py``).

Host-side: tokenization happens at index and query time on the CPU; only
term ids and postings reach the device.
"""

from __future__ import annotations

import functools
import itertools
import re
import unicodedata
from typing import List, NamedTuple


class Token(NamedTuple):
    term: str
    position: int
    start_offset: int
    end_offset: int


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
_new_token = functools.partial(tuple.__new__, Token)


def _ascii_tokens(text: str) -> List[Token]:
    """The tokens of an ASCII text: its runs of letters and digits, each
    one's offsets the running sums of the lengths of the gaps and runs
    before it, runs longer than MAX_TOKEN_LENGTH dropped; no Python
    frame a token."""
    parts = _ASCII_WORD_SPLIT.split(text)
    ends = list(itertools.accumulate(map(len, parts)))
    terms, starts, ends = parts[1::2], ends[0::2], ends[1::2]
    if terms and max(map(len, terms)) > MAX_TOKEN_LENGTH:
        kept = [i for i, t in enumerate(terms)
                if len(t) <= MAX_TOKEN_LENGTH]
        terms = [terms[i] for i in kept]
        starts = [starts[i] for i in kept]
        ends = [ends[i] for i in kept]
    return list(map(_new_token, zip(terms, range(len(terms)), starts,
                                    ends)))


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


class StandardTokenizer:
    """UAX#29-approximate word-boundary tokenizer (Lucene
    StandardTokenizer): splits on non-alphanumerics."""

    def tokenize(self, text: str) -> List[Token]:
        if text.isascii():
            return _ascii_tokens(text)
        out: List[Token] = []
        pos = 0
        i = 0
        n = len(text)
        while i < n:
            if _is_word_char(text[i]):
                start = i
                while i < n and _is_word_char(text[i]):
                    i += 1
            else:
                i += 1
                continue
            term = text[start:i]
            if len(term) <= MAX_TOKEN_LENGTH:
                out.append(Token(term, pos, start, i))
                pos += 1
        return out
