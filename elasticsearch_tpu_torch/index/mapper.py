"""Document mapping for the `_search` slices (counterpart of
elasticsearch_tpu/index/mapper.py): a document parses into per-field
token lists (text, analyzed), term lists (keyword, untokenized),
numeric doc values (numbers, booleans and dates, as float64) and dense
vectors (float32).

Field types, with the reference's class names and ``parse``: ``text``
(the standard analyzer only), ``keyword``, ``long``, ``integer``,
``short``, ``byte``, ``double``, ``float``, ``half_float``, ``boolean``
(1.0 / 0.0), ``date`` (epoch milliseconds, from
``strict_date_optional_time||epoch_millis``) and ``dense_vector`` (a
float32 [dims] row of the segment's vector slab; its JSON array is one
value). An explicit mapping may give a field multi-fields
(``"fields"``): every value indexes into the field and into each of
them. Other field types (ranges, ``ip``, ``geo_*``,
``constant_keyword``, ``nested``, ...) belong to later slices and are
refused with a ``MapperParsingException``.

Dynamic mapping follows the reference's ``_infer_type``: a bool maps to
``boolean``, an int to ``long``, a float to ``float``, a date-shaped
string to ``date`` and any other string to ``text`` with a ``.keyword``
subfield (``ignore_above`` 256).
"""

from __future__ import annotations

import datetime as _dt
import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.analysis.analyzers import (SUPPORTED,
                                                        StandardAnalyzer)
from elasticsearch_tpu_torch.analysis.tokenizers import Token


class MapperParsingException(ValueError):
    """A mapping or document this slice cannot take."""


# ---------------------------------------------------------------------------
# Field types
# ---------------------------------------------------------------------------

class MappedFieldType:
    """A field's type: how values parse, and which columnar form they
    feed ("postings" text, "term" keyword, "numeric" doc values,
    "vector" slab rows)."""

    type_name = "?"
    docvalue_kind = "none"

    def __init__(self, name: str, params: Optional[Dict[str, Any]] = None):
        self.name = name
        self.params = params or {}
        self.subfields: List[str] = []

    def parse(self, value: Any) -> Any:
        """JSON value -> internal typed value."""
        raise NotImplementedError


class TextFieldType(MappedFieldType):
    type_name = "text"
    docvalue_kind = "postings"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        for key in ("analyzer", "search_analyzer"):
            if self.params.get(key, "standard") not in SUPPORTED:
                raise MapperParsingException(
                    f"field [{name}] asks for analyzer "
                    f"[{self.params[key]}]: this slice has the standard "
                    f"analyzer only")

    def parse(self, value):
        return str(value)


class KeywordFieldType(MappedFieldType):
    type_name = "keyword"
    docvalue_kind = "term"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.ignore_above = int(self.params.get("ignore_above", 2 ** 31 - 1))

    def parse(self, value):
        s = str(value)
        if len(s) > self.ignore_above:
            return None
        return s


class _NumericFieldType(MappedFieldType):
    docvalue_kind = "numeric"
    _min = None
    _max = None
    _cast = float

    def parse(self, value):
        try:
            v = self._cast(value)
        except (ValueError, TypeError):
            raise MapperParsingException(
                f"failed to parse field [{self.name}] of type "
                f"[{self.type_name}]: For input string: \"{value}\"")
        if self._min is not None and (v < self._min or v > self._max):
            raise MapperParsingException(
                f"Value [{value}] is out of range for field [{self.name}] "
                f"of type [{self.type_name}]")
        return v


class LongFieldType(_NumericFieldType):
    type_name = "long"
    _cast = int
    _min, _max = -(2 ** 63), 2 ** 63 - 1


class IntegerFieldType(_NumericFieldType):
    type_name = "integer"
    _cast = int
    _min, _max = -(2 ** 31), 2 ** 31 - 1


class ShortFieldType(_NumericFieldType):
    type_name = "short"
    _cast = int
    _min, _max = -(2 ** 15), 2 ** 15 - 1


class ByteFieldType(_NumericFieldType):
    type_name = "byte"
    _cast = int
    _min, _max = -(2 ** 7), 2 ** 7 - 1


class DoubleFieldType(_NumericFieldType):
    type_name = "double"


class FloatFieldType(_NumericFieldType):
    type_name = "float"


class HalfFloatFieldType(_NumericFieldType):
    type_name = "half_float"

    def parse(self, value):
        return float(np.float16(super().parse(value)))


class BooleanFieldType(MappedFieldType):
    type_name = "boolean"
    docvalue_kind = "numeric"

    def parse(self, value):
        if isinstance(value, bool):
            return 1.0 if value else 0.0
        if value in ("true", "True"):
            return 1.0
        if value in ("false", "False", ""):
            return 0.0
        raise MapperParsingException(
            f"failed to parse field [{self.name}] of type [boolean]: "
            f"[{value}]")


_DATE_FORMATS = [
    "%Y-%m-%dT%H:%M:%S.%f%z", "%Y-%m-%dT%H:%M:%S%z", "%Y-%m-%dT%H:%M:%S.%f",
    "%Y-%m-%dT%H:%M:%S", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d", "%Y/%m/%d",
]


class DateFieldType(MappedFieldType):
    """Dates stored as epoch millis float64 (the
    `strict_date_optional_time||epoch_millis` default format)."""

    type_name = "date"
    docvalue_kind = "numeric"

    def parse(self, value):
        if isinstance(value, (int, float)):
            return float(value)
        s = str(value)
        if re.fullmatch(r"-?\d+", s):
            return float(int(s))
        for fmt in _DATE_FORMATS:
            try:
                dt = _dt.datetime.strptime(s, fmt)
                if dt.tzinfo is None:
                    dt = dt.replace(tzinfo=_dt.timezone.utc)
                return dt.timestamp() * 1000.0
            except ValueError:
                continue
        raise MapperParsingException(
            f"failed to parse date field [{value}] for field [{self.name}]")


class DenseVectorFieldType(MappedFieldType):
    """At most 2048 float dims (the reference's DenseVectorFieldMapper
    limit); a doc's vector is a row of the [n_docs, dims] device slab
    (bfloat16 by default, search/context.py)."""

    type_name = "dense_vector"
    docvalue_kind = "vector"
    MAX_DIMS = 2048

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.dims = int(self.params.get("dims", 0))
        if not (0 < self.dims <= self.MAX_DIMS):
            raise MapperParsingException(
                f"The number of dimensions for field [{name}] should be in "
                f"the range [1, {self.MAX_DIMS}] but was [{self.dims}]")
        self.similarity = self.params.get("similarity", "cosine")

    def parse(self, value):
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim != 1 or arr.shape[0] != self.dims:
            raise MapperParsingException(
                f"The [dims] of field [{self.name}] is [{self.dims}], "
                f"doesn't match the number of dimensions in the provided "
                f"value [{arr.shape}]")
        return arr


FIELD_TYPES = {cls.type_name: cls for cls in (
    TextFieldType, KeywordFieldType, LongFieldType, IntegerFieldType,
    ShortFieldType, ByteFieldType, DoubleFieldType, FloatFieldType,
    HalfFloatFieldType, BooleanFieldType, DateFieldType,
    DenseVectorFieldType)}

# the reference's other field types (and nested objects): each a later
# slice of the port
LATER_SLICE_TYPES = {
    "integer_range", "float_range", "long_range", "double_range",
    "date_range", "ip_range", "ip", "geo_point", "geo_shape",
    "constant_keyword", "rank_feature", "rank_features",
    "flattened", "join", "percolator", "completion", "search_as_you_type",
    "token_count", "annotated_text", "wildcard", "murmur3", "nested"}


@dataclass
class ParsedDocument:
    doc_id: str
    source: bytes
    # field -> analyzed tokens
    text_tokens: Dict[str, List[Token]] = field(default_factory=dict)
    # field -> untokenized values, one term each (keyword fields)
    keyword_terms: Dict[str, List[str]] = field(default_factory=dict)
    # field -> numeric values (numbers, booleans, dates as epoch millis)
    numeric_values: Dict[str, List[float]] = field(default_factory=dict)
    # field -> float32 [dims] (dense_vector fields)
    vectors: Dict[str, np.ndarray] = field(default_factory=dict)
    # field -> similarity name (cosine | dot_product | l2_norm)
    vector_similarity: Dict[str, str] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Document mapper / parser
# ---------------------------------------------------------------------------

_DYNAMIC_DATE_RE = re.compile(r"\d{4}[-/]\d{2}[-/]\d{2}([T ].*)?$")


def _field_type(path: str, conf: Dict[str, Any]) -> MappedFieldType:
    type_name = conf.get("type", "object")
    cls = FIELD_TYPES.get(type_name)
    if cls is None:
        if type_name in LATER_SLICE_TYPES:
            raise MapperParsingException(
                f"field [{path}] has type [{type_name}]: a later slice of "
                f"the port (this one maps {', '.join(sorted(FIELD_TYPES))})")
        raise MapperParsingException(
            f"No handler for type [{type_name}] declared on field [{path}]")
    return cls(path, {k: v for k, v in conf.items()
                      if k not in ("type", "fields")})


class DocumentMapper:
    """Field map of one index: dotted path -> MappedFieldType."""

    def __init__(self, mappings: Optional[Dict[str, Any]] = None):
        self.fields: Dict[str, MappedFieldType] = {}
        self.analyzer = StandardAnalyzer()
        if mappings:
            self._add_properties("", mappings.get("properties", {}))

    def field_type(self, name: str) -> Optional[MappedFieldType]:
        return self.fields.get(name)

    def _add_properties(self, prefix: str, props: Dict[str, Any]):
        for name, conf in props.items():
            path = f"{prefix}{name}"
            if conf.get("type", "object") == "object":
                self._add_properties(f"{path}.", conf.get("properties", {}))
                continue
            ft = _field_type(path, conf)
            self.fields[path] = ft
            # multi-fields: every value indexes into the parent AND each
            # subfield
            for subname, subconf in (conf.get("fields") or {}).items():
                subconf = dict(subconf or {})
                subconf.setdefault("type", "keyword")
                sft = _field_type(f"{path}.{subname}", subconf)
                self.fields[sft.name] = sft
                ft.subfields.append(subname)

    def _infer_type(self, path: str, value: Any) -> Optional[MappedFieldType]:
        """The dynamic mapping of a new field from its first value."""
        if isinstance(value, bool):
            return BooleanFieldType(path)
        if isinstance(value, int):
            return LongFieldType(path)
        if isinstance(value, float):
            return FloatFieldType(path)
        if isinstance(value, str):
            if _DYNAMIC_DATE_RE.match(value):
                try:
                    DateFieldType(path).parse(value)
                    return DateFieldType(path)
                except MapperParsingException:
                    pass
            # dynamic strings map to text with a .keyword subfield
            return TextFieldType(path)
        return None

    def parse(self, doc_id: str, source: Dict[str, Any]) -> ParsedDocument:
        if not isinstance(source, dict):
            raise MapperParsingException("document source must be an object")
        parsed = ParsedDocument(
            doc_id=doc_id,
            source=json.dumps(source, separators=(",", ":")).encode())
        self._parse_object("", source, parsed)
        return parsed

    def _parse_object(self, prefix: str, obj: Dict[str, Any],
                      parsed: ParsedDocument):
        for key, value in obj.items():
            path = f"{prefix}{key}"
            if isinstance(value, dict):
                self._parse_object(f"{path}.", value, parsed)
                continue
            ft = self.fields.get(path)
            if ft is not None and ft.docvalue_kind == "vector":
                # a dense_vector's JSON array is ONE value
                values = [value]
            else:
                values = value if isinstance(value, list) else [value]
            # arrays of objects flatten
            if values and isinstance(values[0], dict):
                for v in values:
                    self._parse_object(f"{path}.", v, parsed)
                continue
            if ft is None:
                sample = next((v for v in values if v is not None), None)
                if sample is None:
                    continue
                ft = self._infer_type(path, sample)
                if ft is None:
                    continue
                self.fields[path] = ft
                if isinstance(ft, TextFieldType):
                    kw = KeywordFieldType(f"{path}.keyword",
                                          {"ignore_above": 256})
                    self.fields[kw.name] = kw
            self._index_values(ft, values, parsed)
            # explicit multi-fields: the same values index into every
            # declared subfield
            for subname in ft.subfields:
                sft = self.fields.get(f"{ft.name}.{subname}")
                if sft is not None:
                    self._index_values(sft, values, parsed)
            # dynamic text fields also index into their .keyword subfield
            kw_ft = self.fields.get(f"{ft.name}.keyword")
            if (kw_ft is not None and isinstance(ft, TextFieldType)
                    and "keyword" not in ft.subfields):
                self._index_values(kw_ft, values, parsed)

    def _index_values(self, ft: MappedFieldType, values: List[Any],
                      parsed: ParsedDocument):
        for value in values:
            if value is None:
                continue
            typed = ft.parse(value)
            if typed is None:
                continue
            if ft.docvalue_kind == "postings":
                toks = parsed.text_tokens.setdefault(ft.name, [])
                # position gap of 100 between the values of one field
                base = toks[-1].position + 100 if toks else 0
                toks.extend(Token(t.term, base + t.position, t.start_offset,
                                  t.end_offset)
                            for t in self.analyzer.analyze(typed))
            elif ft.docvalue_kind == "term":
                parsed.keyword_terms.setdefault(ft.name, []).append(typed)
            elif ft.docvalue_kind == "vector":
                parsed.vectors[ft.name] = typed
                parsed.vector_similarity[ft.name] = ft.similarity
            else:
                parsed.numeric_values.setdefault(ft.name, []).append(
                    float(typed))
