"""Analyzers and the analysis registry (the port's copy of
elasticsearch_tpu/analysis/analyzers.py): an analyzer is char filters,
then a tokenizer, then token filters; ``AnalysisRegistry`` builds an
index's analyzers from its ``analysis`` settings beside the builtin
ones (standard, simple, whitespace, stop, keyword, english).

The builtin ``standard`` analyzer is ``StandardAnalyzer``: the standard
tokenizer then lowercase, with the indexer's ``TermRun`` fast path for
an ASCII value (``index_terms``). It is the only analyzer the native
front's C++ tokenizer mirrors (native/src/estpu_tokenize.h), so the
fast path serves a field only when both its analyzers are that object
(``is_builtin_standard``). Every other analyzer hands the indexer its
Tokens.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.analysis.filters import (
    ApostropheFilter, AsciiFoldingFilter, CharFilter, CjkBigramFilter,
    DecimalDigitFilter, EdgeNGramFilter, ElisionFilter, HtmlStripCharFilter,
    KeywordMarkerFilter, LengthFilter, LowercaseFilter, MappingCharFilter,
    PatternReplaceCharFilter, PorterStemFilter, ReverseFilter, ShingleFilter,
    StopFilter, SynonymFilter, TokenFilter, TrimFilter, TruncateFilter,
    UniqueFilter, UppercaseFilter, WordDelimiterGraphFilter)
from elasticsearch_tpu_torch.analysis.tokenizers import (
    EdgeNGramTokenizer, KeywordTokenizer, LetterTokenizer, NGramTokenizer,
    PatternTokenizer, StandardTokenizer, TermRun, Token, Tokenizer,
    WhitespaceTokenizer)
from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.common.settings import flat_settings


class Analyzer:
    name = "?"

    def analyze(self, text: str) -> List[Token]:
        raise NotImplementedError

    def terms(self, text: str) -> List[str]:
        return [t.term for t in self.analyze(text)]

    def index_terms(self, text: str):
        """``analyze`` as the indexer takes it."""
        return self.analyze(text)


class CustomAnalyzer(Analyzer):
    def __init__(self, name: str, tokenizer: Tokenizer,
                 token_filters: Optional[List[TokenFilter]] = None,
                 char_filters: Optional[List[CharFilter]] = None):
        self.name = name
        self.tokenizer = tokenizer
        self.token_filters = token_filters or []
        self.char_filters = char_filters or []
        # the standard tokenizer followed by lowercase: an ASCII text
        # tokenizes lowercased and skips the filter (lowercasing ASCII
        # keeps every offset and every word boundary)
        self._lower_first = (isinstance(tokenizer, StandardTokenizer)
                             and bool(self.token_filters)
                             and isinstance(self.token_filters[0],
                                            LowercaseFilter))

    def analyze(self, text: str) -> List[Token]:
        for cf in self.char_filters:
            text = cf.apply(text)
        filters = self.token_filters
        if self._lower_first and text.isascii():
            tokens = self.tokenizer.tokenize(text.lower())
            filters = filters[1:]
        else:
            tokens = self.tokenizer.tokenize(text)
        for tf in filters:
            tokens = tf.filter(tokens)
        return tokens


class StandardAnalyzer(CustomAnalyzer):
    """The builtin ``standard`` analyzer: the standard tokenizer, then
    lowercase (Elasticsearch's default has no stop words)."""

    def __init__(self):
        super().__init__("standard", StandardTokenizer(), [LowercaseFilter()])

    def index_terms(self, text: str):
        """``analyze`` as the indexer takes it: an ASCII value as a
        TermRun (its terms, the Tokens made on demand), any other as
        its Tokens."""
        if text.isascii():
            return TermRun(text.lower())
        return self.analyze(text)


# named analyzers a plugin contributes ({name: zero-arg factory}); the
# port has no plugins/ yet, so none
PLUGIN_ANALYZERS: Dict[str, Any] = {}


def _prebuilt_analyzers() -> Dict[str, Analyzer]:
    out = {name: factory() for name, factory in PLUGIN_ANALYZERS.items()}
    out.update(_builtin_analyzers())
    return out


def _builtin_analyzers() -> Dict[str, Analyzer]:
    return {
        "standard": StandardAnalyzer(),
        "simple": CustomAnalyzer("simple", LetterTokenizer(),
                                 [LowercaseFilter()]),
        "whitespace": CustomAnalyzer("whitespace", WhitespaceTokenizer()),
        "stop": CustomAnalyzer("stop", LetterTokenizer(),
                               [LowercaseFilter(), StopFilter()]),
        "keyword": CustomAnalyzer("keyword", KeywordTokenizer()),
        # stop words and the Porter stemmer (possessives fall to the
        # standard tokenizer's split)
        "english": CustomAnalyzer("english", StandardTokenizer(),
                                  [LowercaseFilter(), StopFilter(),
                                   PorterStemFilter()]),
    }


def _parse_stopwords(value):
    """None or ``_english_`` -> the default list; a string -> its
    comma-separated words; a list -> its set."""
    if value in (None, "_english_"):
        return None
    if isinstance(value, str):
        return {w.strip() for w in value.split(",") if w.strip()}
    return set(value)


def _flag(s, key: str, default: bool) -> bool:
    return s.get(key, default) in (True, "true")


_TOKENIZERS = {
    "standard": lambda s: StandardTokenizer(
        int(s.get("max_token_length", 255))),
    "whitespace": lambda s: WhitespaceTokenizer(),
    "keyword": lambda s: KeywordTokenizer(),
    "letter": lambda s: LetterTokenizer(),
    "pattern": lambda s: PatternTokenizer(s.get("pattern", r"\W+")),
    "ngram": lambda s: NGramTokenizer(int(s.get("min_gram", 1)),
                                      int(s.get("max_gram", 2))),
    "edge_ngram": lambda s: EdgeNGramTokenizer(int(s.get("min_gram", 1)),
                                               int(s.get("max_gram", 2))),
}


def _word_delimiter(s):
    return WordDelimiterGraphFilter(_flag(s, "generate_word_parts", True),
                                    _flag(s, "catenate_all", False),
                                    _flag(s, "preserve_original", False))


_TOKEN_FILTERS = {
    "lowercase": lambda s: LowercaseFilter(),
    "uppercase": lambda s: UppercaseFilter(),
    "stop": lambda s: StopFilter(_parse_stopwords(s.get("stopwords"))),
    "asciifolding": lambda s: AsciiFoldingFilter(),
    "length": lambda s: LengthFilter(int(s.get("min", 0)),
                                     int(s.get("max", 2 ** 31 - 1))),
    "trim": lambda s: TrimFilter(),
    "truncate": lambda s: TruncateFilter(int(s.get("length", 10))),
    "unique": lambda s: UniqueFilter(),
    "reverse": lambda s: ReverseFilter(),
    "edge_ngram": lambda s: EdgeNGramFilter(int(s.get("min_gram", 1)),
                                            int(s.get("max_gram", 2))),
    "shingle": lambda s: ShingleFilter(
        int(s.get("min_shingle_size", 2)), int(s.get("max_shingle_size", 2)),
        _flag(s, "output_unigrams", True)),
    "porter_stem": lambda s: PorterStemFilter(),
    # the `english` stemmer and its neighbours: the one stemmer in tree
    "stemmer": lambda s: PorterStemFilter(),
    "kstem": lambda s: PorterStemFilter(),
    "snowball": lambda s: PorterStemFilter(),
    "synonym": lambda s: SynonymFilter(s.get("synonyms") or []),
    "synonym_graph": lambda s: SynonymFilter(s.get("synonyms") or []),
    "elision": lambda s: ElisionFilter(
        set(s.get("articles")) if s.get("articles") else None),
    "apostrophe": lambda s: ApostropheFilter(),
    "decimal_digit": lambda s: DecimalDigitFilter(),
    "keyword_marker": lambda s: KeywordMarkerFilter(
        set(s.get("keywords") or [])),
    "word_delimiter": _word_delimiter,
    "word_delimiter_graph": _word_delimiter,
    "cjk_bigram": lambda s: CjkBigramFilter(
        _flag(s, "output_unigrams", False)),
    # "phonetic" is a plugin's filter (filters.py PhoneticFilter), as in
    # the reference: it is registered with plugins/, not here
}

_CHAR_FILTERS = {
    "html_strip": lambda s: HtmlStripCharFilter(),
    "mapping": lambda s: MappingCharFilter(
        {src.strip(): dst.strip()
         for src, _, dst in (m.partition("=>")
                             for m in (s.get("mappings") or []))}),
    "pattern_replace": lambda s: PatternReplaceCharFilter(
        s.get("pattern", ""), s.get("replacement", "")),
}


def _groups(flat: Dict[str, Any], prefix: str) -> Dict[str, Dict[str, Any]]:
    """The settings under ``prefix.`` grouped by their next key (the
    reference's ``Settings.groups``: a bare ``prefix.name`` value lands
    under the key ``name`` of its group)."""
    prefix += "."
    out: Dict[str, Dict[str, Any]] = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        name, _, sub = k[len(prefix):].partition(".")
        out.setdefault(name, {})[sub or name] = v
    return out


class AnalysisRegistry:
    """An index's analyzers, from its settings (nested or dotted, as
    ``PUT /{index}`` takes them), e.g.::

        index.analysis.analyzer.my_analyzer.type: custom
        index.analysis.analyzer.my_analyzer.tokenizer: standard
        index.analysis.analyzer.my_analyzer.filter: [lowercase, stop]
        index.analysis.filter.my_stop.type: stop
        index.analysis.filter.my_stop.stopwords: [foo, bar]

    ``analysis.X`` and ``index.analysis.X`` are the same key (the
    latter wins a clash). An unknown component or analyzer type is an
    IllegalArgumentException with the reference's reason."""

    def __init__(self, index_settings: Optional[Dict[str, Any]] = None):
        self._analyzers: Dict[str, Analyzer] = _prebuilt_analyzers()
        self._build_custom(flat_settings(index_settings))

    @staticmethod
    def _groups(flat: Dict[str, Any], group: str):
        out = _groups(flat, f"analysis.{group}")
        out.update(_groups(flat, f"index.analysis.{group}"))
        return out

    def _named_components(self, flat, group: str, registry: dict):
        out = {}
        for name, conf in self._groups(flat, group).items():
            type_ = conf.get("type", name)
            factory = registry.get(type_)
            if factory is None:
                raise IllegalArgumentException(
                    f"Unknown {group} type [{type_}] for [{name}]")
            out[name] = factory(conf)
        return out

    @staticmethod
    def _names(value) -> List[str]:
        if isinstance(value, str):
            return [f.strip() for f in value.split(",")]
        return list(value)

    def _build_custom(self, flat: Dict[str, Any]):
        custom_tokenizers = self._named_components(flat, "tokenizer",
                                                   _TOKENIZERS)
        custom_filters = self._named_components(flat, "filter",
                                                _TOKEN_FILTERS)
        custom_char_filters = self._named_components(flat, "char_filter",
                                                     _CHAR_FILTERS)
        # the index's components stay resolvable by name (`_analyze`
        # takes them beside the builtin ones)
        self.named_tokenizers = custom_tokenizers
        self.named_filters = custom_filters
        self.named_char_filters = custom_char_filters

        for name, conf in self._groups(flat, "analyzer").items():
            type_ = conf.get("type", "custom")
            if type_ != "custom":
                if type_ not in self._analyzers:
                    raise IllegalArgumentException(
                        f"Unknown analyzer type [{type_}] for [{name}]")
                self._analyzers[name] = self._analyzers[type_]
                continue
            tok_name = conf.get("tokenizer", "standard")
            tokenizer = custom_tokenizers.get(tok_name)
            if tokenizer is None:
                factory = _TOKENIZERS.get(tok_name)
                if factory is None:
                    raise IllegalArgumentException(
                        f"analyzer [{name}] must specify a known tokenizer, "
                        f"got [{tok_name}]")
                tokenizer = factory({})
            filters = []
            for fname in self._names(conf.get("filter", [])):
                f = custom_filters.get(fname)
                if f is None:
                    factory = _TOKEN_FILTERS.get(fname)
                    if factory is None:
                        raise IllegalArgumentException(
                            f"analyzer [{name}]: unknown token filter "
                            f"[{fname}]")
                    f = factory({})
                filters.append(f)
            char_filters = []
            for cname in self._names(conf.get("char_filter", [])):
                cf = custom_char_filters.get(cname)
                if cf is None:
                    factory = _CHAR_FILTERS.get(cname)
                    if factory is None:
                        raise IllegalArgumentException(
                            f"analyzer [{name}]: unknown char filter "
                            f"[{cname}]")
                    cf = factory({})
                char_filters.append(cf)
            self._analyzers[name] = CustomAnalyzer(name, tokenizer, filters,
                                                   char_filters)

    def get(self, name: str) -> Analyzer:
        analyzer = self._analyzers.get(name)
        if analyzer is None:
            raise IllegalArgumentException(f"failed to find analyzer [{name}]")
        return analyzer

    def has(self, name: str) -> bool:
        return name in self._analyzers

    @property
    def default(self) -> Analyzer:
        return self._analyzers.get("default", self._analyzers["standard"])

    def resolve(self, name: str) -> Analyzer:
        """The analyzer a field named ``name`` indexes and searches
        with: ``get(name)`` when the index has it, else ``default``."""
        analyzer = self._analyzers.get(name)
        return analyzer if analyzer is not None else self.default


def is_builtin_standard(analyzer: Analyzer) -> bool:
    """Whether ``analyzer`` is the builtin standard analyzer itself (a
    custom chain of the same components is not)."""
    return type(analyzer) is StandardAnalyzer
