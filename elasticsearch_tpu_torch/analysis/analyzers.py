"""The standard analyzer (counterpart of the ``standard`` entry of
elasticsearch_tpu/analysis/analyzers.py): standard tokenizer, then
lowercase. It is the only analyzer the v2m serving lane accepts."""

from __future__ import annotations

from typing import List

from elasticsearch_tpu_torch.analysis.tokenizers import (StandardTokenizer,
                                                         TermRun, Token)

# names a text field may carry for its (search) analyzer in this slice
SUPPORTED = ("standard", "default")


class StandardAnalyzer:
    def __init__(self):
        self.tokenizer = StandardTokenizer()

    def analyze(self, text: str) -> List[Token]:
        if text.isascii():
            # lowercasing ASCII keeps every offset: tokenize the
            # lowercased text once
            return self.tokenizer.tokenize(text.lower())
        out = []
        for t in self.tokenizer.tokenize(text):
            low = t.term.lower()
            out.append(t if low == t.term else
                       Token(low, t.position, t.start_offset, t.end_offset))
        return out

    def index_terms(self, text: str):
        """``analyze`` as the indexer takes it: an ASCII value as a
        TermRun (its terms, the Tokens made on demand), any other as
        its Tokens."""
        if text.isascii():
            return TermRun(text.lower())
        return self.analyze(text)
