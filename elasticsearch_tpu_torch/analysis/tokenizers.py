"""The standard tokenizer (counterpart of elasticsearch_tpu/analysis/tokenizers.py
``StandardTokenizer._tokenize_py``).

Host-side: tokenization happens at index and query time on the CPU; only
term ids and postings reach the device.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass
from typing import List


@dataclass
class Token:
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


class StandardTokenizer:
    """UAX#29-approximate word-boundary tokenizer (Lucene
    StandardTokenizer): splits on non-alphanumerics."""

    def tokenize(self, text: str) -> List[Token]:
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
