"""Document mapping for the `_search` slices (counterpart of
elasticsearch_tpu/index/mapper.py): a document parses into per-field
token lists (text, analyzed), term lists (keyword, untokenized),
numeric doc values (numbers, booleans and dates, as float64) and dense
vectors (float32).

Field types, with the reference's class names and ``parse``: ``text``
(its ``analyzer`` and ``search_analyzer`` names resolved through the
index's AnalysisRegistry: ``get(name)`` when the index has the name,
else its ``default``), ``keyword``, ``long``, ``integer``,
``short``, ``byte``, ``double``, ``float``, ``half_float``, ``boolean``
(1.0 / 0.0), ``date`` (epoch milliseconds, from
``strict_date_optional_time||epoch_millis``) and ``dense_vector`` (a
float32 [dims] row of the segment's vector slab; its JSON array is one
value). An explicit mapping may give a field multi-fields
(``"fields"``): every value indexes into the field and into each of
them. ``rank_feature`` is a positive float doc value (its
``positive_score_impact`` read by the rank_feature query);
``rank_features`` is an object of feature -> positive float, each key
its own numeric column ``{field}.{key}`` (the text_expansion query
reads them). ``completion`` holds suggestion inputs (a string, a list,
or ``{"input", "weight", "contexts"}``) for the completion suggester's
prefix index (index/segment.py ``CompletionValues``).

The other field types of the reference, each into ordinary numeric and
keyword columns: ``ip`` (the address as a number: ``float(int(ip))``,
so a float32 column on the device), the six range types
(``integer_range`` ... ``ip_range``: ``{f}.lo`` / ``{f}.hi``, an open
bound moved one float64 ``nextafter`` inward), ``geo_point``
(``{f}.lat`` / ``{f}.lon``; the five point forms of common/geo.py),
``geo_shape`` (its bounding box in ``{f}.min_lat`` ... ``{f}.max_lon``),
``join`` (the relation name as a keyword term of ``{f}``, a child's
parent id under ``{f}#parent``), ``percolator`` (a stored query,
validated and kept in ``_source``), ``constant_keyword`` (the first
value pins the constant; nothing is indexed), ``wildcard`` (a
keyword), ``flattened`` (every leaf a term of ``{f}`` and of
``{f}.{path}``), ``token_count`` (the analyzed token count),
``murmur3`` (the value's 32-bit murmur3 hash), ``annotated_text``
(``[anchor](value&value)`` markup: the plain text analyzed, each value a
verbatim token at the anchor's first position) and
``search_as_you_type`` (a text field with ``._2gram``/``._3gram``
shingle subfields and an ``._index_prefix`` keyword of edge n-grams).
A ``nested`` object indexes flattened (``nested_paths``): the nested
query verifies each candidate against its ``_source`` objects.

Dynamic mapping follows the reference's ``_infer_type``: a bool maps to
``boolean``, an int to ``long``, a float to ``float``, a date-shaped
string to ``date`` and any other string to ``text`` with a ``.keyword``
subfield (``ignore_above`` 256).
"""

from __future__ import annotations

import datetime as _dt
import ipaddress
import json
import re
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple
from urllib.parse import unquote

import numpy as np

from elasticsearch_tpu_torch.analysis.analyzers import (AnalysisRegistry,
                                                        Analyzer,
                                                        is_builtin_standard)
from elasticsearch_tpu_torch.analysis.tokenizers import Token


class MapperParsingException(ValueError):
    """A mapping or document this slice cannot take."""


class StrictDynamicMappingException(MapperParsingException):
    """A document with a field that a ``dynamic: strict`` mapping does
    not map."""

    error_type = "strict_dynamic_mapping_exception"


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

    def to_mapping(self) -> Dict[str, Any]:
        return {"type": self.type_name, **self.params}


class TextFieldType(MappedFieldType):
    type_name = "text"
    docvalue_kind = "postings"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        # resolved through the index's AnalysisRegistry when used (a
        # name the index lacks falls to its default, as the reference's)
        self.analyzer_name = self.params.get("analyzer", "standard")
        self.search_analyzer_name = self.params.get("search_analyzer",
                                                    self.analyzer_name)

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


class IpFieldType(MappedFieldType):
    """An IPv4 or IPv6 address as the number ``float(int(ip))``, as the
    reference keeps it: the device column is float32, so addresses
    above 2^24 share a column value with their float32 neighbours."""

    type_name = "ip"
    docvalue_kind = "numeric"

    def parse(self, value):
        try:
            return float(int(ipaddress.ip_address(str(value))))
        except ValueError:
            raise MapperParsingException(
                f"'{value}' is not an IP string literal.")


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


class RankFeatureFieldType(MappedFieldType):
    """A positive float feature (the reference's RankFeatureFieldType):
    a numeric doc value the rank_feature query scores; a value <= 0 is
    refused."""

    type_name = "rank_feature"
    docvalue_kind = "numeric"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.positive_score_impact = bool(
            self.params.get("positive_score_impact", True))

    def parse(self, value):
        v = float(value)
        if v <= 0:
            raise MapperParsingException(
                f"[rank_feature] fields do not support negative or zero "
                f"values, got [{v}] for field [{self.name}]")
        return v


class RankFeaturesFieldType(MappedFieldType):
    """A sparse map of feature -> positive float (the reference's
    RankFeaturesFieldType): each key lands in its own numeric column
    ``{field}.{key}``."""

    type_name = "rank_features"
    docvalue_kind = "rank_features"

    def parse(self, value):
        if not isinstance(value, dict):
            raise MapperParsingException(
                f"[rank_features] field [{self.name}] expects an object")
        out = {}
        for k, v in value.items():
            if float(v) <= 0:
                raise MapperParsingException(
                    f"[rank_features] fields do not support negative or "
                    f"zero values, got [{v}] for feature [{k}]")
            out[str(k)] = float(v)
        return out


class JoinFieldType(MappedFieldType):
    """Parent/child relations within one index: the relation name is a
    keyword term of the field, a child's parent id a term of
    ``{field}#parent`` (parents and children share the index's one
    shard)."""

    type_name = "join"
    docvalue_kind = "join"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        rels = self.params.get("relations", {})
        self.relations = {p: (c if isinstance(c, list) else [c])
                          for p, c in rels.items()}

    def parent_of(self, child: str) -> Optional[str]:
        for parent, children in self.relations.items():
            if child in children:
                return parent
        return None

    def children_of(self, parent: str) -> List[str]:
        return self.relations.get(parent, [])

    def to_mapping(self):
        return {"type": "join", "relations": {
            p: (c[0] if len(c) == 1 else c)
            for p, c in self.relations.items()}}


class GeoPointFieldType(MappedFieldType):
    """A latitude/longitude point in the numeric columns ``{field}.lat``
    and ``{field}.lon``: every geo predicate is elementwise math over
    them (common/geo.py)."""

    type_name = "geo_point"
    docvalue_kind = "geo"

    def parse(self, value):
        from elasticsearch_tpu_torch.common.geo import parse_geo_point
        return parse_geo_point(value)


class GeoShapeFieldType(MappedFieldType):
    """A GeoJSON geometry kept as its bounding box in the four numeric
    columns ``{field}.min_lat`` / ``.min_lon`` / ``.max_lat`` /
    ``.max_lon``: the geo_shape query relates boxes."""

    type_name = "geo_shape"
    docvalue_kind = "geoshape"

    def parse(self, value):
        from elasticsearch_tpu_torch.common.geo import shape_bbox
        if isinstance(value, str):
            raise MapperParsingException(
                f"geo_shape [{self.name}]: WKT input not supported, use "
                f"GeoJSON")
        return shape_bbox(value)


class _RangeFieldType(MappedFieldType):
    """A [lo, hi] interval in the numeric columns ``{field}.lo`` and
    ``{field}.hi``; ``gt``/``lt`` move the bound one float64
    ``nextafter`` inward (the float32 column rounds that step away)."""

    docvalue_kind = "range"
    value_type: type = None   # set per subclass

    def parse(self, value):
        if not isinstance(value, dict):
            raise MapperParsingException(
                f"error parsing field [{self.name}]: expected an object "
                f"with gt/gte/lt/lte bounds")
        vt = self.value_type(self.name)
        lo, hi = -np.inf, np.inf
        for k, v in value.items():
            if k in ("gte", "from"):
                lo = float(vt.parse(v))
            elif k == "gt":
                lo = np.nextafter(float(vt.parse(v)), np.inf)
            elif k in ("lte", "to"):
                hi = float(vt.parse(v))
            elif k == "lt":
                hi = np.nextafter(float(vt.parse(v)), -np.inf)
            else:
                raise MapperParsingException(
                    f"error parsing field [{self.name}]: unknown bound [{k}]")
        return (lo, hi)


class IntegerRangeFieldType(_RangeFieldType):
    type_name = "integer_range"
    value_type = IntegerFieldType


class LongRangeFieldType(_RangeFieldType):
    type_name = "long_range"
    value_type = LongFieldType


class FloatRangeFieldType(_RangeFieldType):
    type_name = "float_range"
    value_type = FloatFieldType


class DoubleRangeFieldType(_RangeFieldType):
    type_name = "double_range"
    value_type = DoubleFieldType


class DateRangeFieldType(_RangeFieldType):
    type_name = "date_range"
    value_type = DateFieldType


class IpRangeFieldType(_RangeFieldType):
    type_name = "ip_range"
    value_type = IpFieldType


class WildcardFieldType(KeywordFieldType):
    """A keyword; the wildcard and regexp queries scan its term
    dictionary."""

    type_name = "wildcard"


class ConstantKeywordFieldType(MappedFieldType):
    """One value for every doc of the index: the mapping's ``value``, or
    the first value a document supplies; any other value is refused.
    Nothing is indexed: term and exists answer from the constant."""

    type_name = "constant_keyword"
    docvalue_kind = "constant"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.value = self.params.get("value")

    def parse(self, value):
        if self.value is None:
            # the first supplied value pins the constant
            self.value = str(value)
            self.params["value"] = self.value
            return None
        if str(value) != self.value:
            raise MapperParsingException(
                f"[constant_keyword] field [{self.name}] only accepts values "
                f"that are equal to the value defined in the mappings "
                f"[{self.value}], but got [{value}]")
        return None


class FlattenedFieldType(MappedFieldType):
    """A whole JSON object as keyword terms: the root field matches any
    leaf value, ``{field}.{path}`` that key's values."""

    type_name = "flattened"
    docvalue_kind = "flattened"

    def parse(self, value):
        if not isinstance(value, dict):
            raise MapperParsingException(
                f"[flattened] field [{self.name}] expects an object")
        leaves: List[Tuple[str, str]] = []

        def walk(obj, prefix=""):
            for k, v in obj.items():
                p = f"{prefix}{k}"
                if isinstance(v, dict):
                    walk(v, f"{p}.")
                elif isinstance(v, list):
                    for item in v:
                        if isinstance(item, dict):
                            walk(item, f"{p}.")
                        else:
                            leaves.append((p, str(item)))
                else:
                    leaves.append((p, str(v)))

        walk(value)
        return leaves


class TokenCountFieldType(MappedFieldType):
    """The number of analyzed tokens of the value, a numeric column."""

    type_name = "token_count"
    docvalue_kind = "token_count"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.analyzer_name = self.params.get("analyzer", "standard")

    def parse(self, value):
        return str(value)


def murmur3_hash(key: str) -> int:
    """32-bit murmur3 (x86, seed 0) over the UTF-16LE bytes of ``key``,
    as a signed int (the reference's Murmur3HashFunction)."""
    data = key.encode("utf-16-le")
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = 0
    rounded = len(data) & ~0x3
    for i in range(0, rounded, 4):
        (k,) = struct.unpack_from("<i", data, i)
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = len(data) & 0x3
    if tail >= 3:
        k ^= data[rounded + 2] << 16
    if tail >= 2:
        k ^= data[rounded + 1] << 8
    if tail >= 1:
        k ^= data[rounded]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h - 0x100000000 if h >= 0x80000000 else h


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def murmur3_hash_array(keys: Sequence[str]) -> np.ndarray:
    """``murmur3_hash`` of every key, as int32, in numpy: the keys'
    UTF-16 code units laid out in rows (one a key, zero padded), mixed
    a 4-byte block (two code units) a round over every row that has
    that block, then each row's 2-byte tail and the finalizer. Equal
    bit for bit to the scalar function."""
    n = len(keys)
    if n == 0:
        return np.zeros(0, np.int32)
    units = np.frombuffer("".join(keys).encode("utf-16-le"), np.uint16)
    lens = np.fromiter(map(len, keys), np.int64, n)
    if int(lens.sum()) != len(units):
        # characters outside the BMP take two code units each
        lens = np.fromiter((len(k.encode("utf-16-le")) // 2 for k in keys),
                           np.int64, n)
    width = max(2, int(lens.max()) + (int(lens.max()) & 1))
    rows = np.zeros((n, width), np.uint32)
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    row_of = np.repeat(np.arange(n), lens)
    rows[row_of, np.arange(len(units)) - starts[row_of]] = units
    c1, c2 = np.uint32(0xCC9E2D51), np.uint32(0x1B873593)
    h = np.zeros(n, np.uint32)
    blocks = lens // 2
    for j in range(width // 2):
        has = blocks > j
        k = rows[:, 2 * j] | (rows[:, 2 * j + 1] << np.uint32(16))
        k = _rotl32(k * c1, 15) * c2
        mixed = _rotl32(h ^ k, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        h = np.where(has, mixed, h)
    tail = (lens & 1) == 1
    k = rows[np.arange(n), np.maximum(lens - 1, 0)]
    k = _rotl32(k * c1, 15) * c2
    h = np.where(tail, h ^ k, h)
    h ^= (2 * lens).astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h.view(np.int32)


class Murmur3FieldType(MappedFieldType):
    """The murmur3 hash of the value, a numeric column."""

    type_name = "murmur3"
    docvalue_kind = "numeric"

    def parse(self, value):
        return float(murmur3_hash(str(value)))


_ANNOTATION_RE = re.compile(r"\[([^\]\[]*)\]\(([^\)\(]*)\)")


def parse_annotated_text(text_plus_markup: str):
    """``"[John Smith](John%20Smith&Person)"`` -> (plain text, [(start,
    end, [values])]): url-decoded values separated by ``&``; a
    ``key=value`` pair is refused."""
    plain: List[str] = []
    plain_len = 0
    annotations = []
    last = 0
    for m in _ANNOTATION_RE.finditer(text_plus_markup):
        if m.start() > last:
            seg = text_plus_markup[last:m.start()]
            plain.append(seg)
            plain_len += len(seg)
        start, anchor = plain_len, m.group(1)
        plain.append(anchor)
        plain_len += len(anchor)
        last = m.end()
        values = []
        for pair in m.group(2).split("&"):
            if "=" in pair:
                raise MapperParsingException(
                    "key=value pairs are not supported in annotations")
            if pair:
                values.append(unquote(pair))
        if values:
            annotations.append((start, plain_len, values))
    plain.append(text_plus_markup[last:])
    return "".join(plain), annotations


class AnnotatedTextFieldType(TextFieldType):
    """Text whose markup adds each annotation value as a verbatim token
    at the anchor's first position (``parse_annotated_text``)."""

    type_name = "annotated_text"


class SearchAsYouTypeFieldType(TextFieldType):
    """A text field with shingle subfields ``._2gram`` / ``._3gram`` (up
    to ``max_shingle_size``) and an ``._index_prefix`` keyword of each
    token's prefixes, for match_bool_prefix."""

    type_name = "search_as_you_type"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.max_shingle_size = int(self.params.get("max_shingle_size", 3))


class ShingleSubFieldType(TextFieldType):
    """A search_as_you_type ``._{n}gram`` subfield: queries analyze with
    the field's search analyzer (its own, the standard one by name),
    then shingle to width n. Not mappable and left out of
    ``to_mapping``."""

    type_name = "text"

    def __init__(self, name, shingle_size: int, params=None):
        super().__init__(name, params)
        self.shingle_size = shingle_size


class PercolatorFieldType(MappedFieldType):
    """A stored query (percolate's reverse search): validated when the
    document is indexed, kept in ``_source``."""

    type_name = "percolator"
    docvalue_kind = "stored_query"

    def parse(self, value):
        if not isinstance(value, dict):
            raise MapperParsingException(
                f"percolator field [{self.name}] expects a query object")
        from elasticsearch_tpu_torch.search.queries import parse_query
        try:
            parse_query(value)
        except Exception as e:
            raise MapperParsingException(
                f"percolator field [{self.name}]: invalid query: {e}")
        return value


class CompletionFieldType(MappedFieldType):
    """Suggestion inputs with optional weights and category contexts,
    served by the weighted prefix index (index/segment.py
    CompletionValues). A value is a string, a list of strings, or
    ``{"input": [...], "weight": N, "contexts": {name: [values]}}``."""

    type_name = "completion"
    docvalue_kind = "completion"

    def parse(self, value):
        """A list of (input, weight, frozenset of "name=value")."""
        entries = []
        specs = value if isinstance(value, list) and any(
            isinstance(v, dict) for v in value) else [value]
        for spec in specs:
            if isinstance(spec, str):
                entries.append((spec, 1.0, frozenset()))
                continue
            if isinstance(spec, list):
                entries.extend((str(v), 1.0, frozenset()) for v in spec)
                continue
            if not isinstance(spec, dict):
                raise MapperParsingException(
                    f"failed to parse completion field [{self.name}]")
            inputs = spec.get("input", [])
            if isinstance(inputs, str):
                inputs = [inputs]
            weight = float(spec.get("weight", 1.0))
            ctx = set()
            for cname, cvals in (spec.get("contexts") or {}).items():
                if isinstance(cvals, str):
                    cvals = [cvals]
                ctx.update(f"{cname}={v}" for v in cvals)
            entries.extend((str(i), weight, frozenset(ctx)) for i in inputs)
        return entries


FIELD_TYPES = {cls.type_name: cls for cls in (
    TextFieldType, KeywordFieldType, LongFieldType, IntegerFieldType,
    ShortFieldType, ByteFieldType, DoubleFieldType, FloatFieldType,
    HalfFloatFieldType, BooleanFieldType, DateFieldType, IpFieldType,
    DenseVectorFieldType, RankFeatureFieldType, RankFeaturesFieldType,
    CompletionFieldType, JoinFieldType, PercolatorFieldType,
    GeoPointFieldType, GeoShapeFieldType, IntegerRangeFieldType,
    LongRangeFieldType, FloatRangeFieldType, DoubleRangeFieldType,
    DateRangeFieldType, IpRangeFieldType, WildcardFieldType,
    ConstantKeywordFieldType, TokenCountFieldType, Murmur3FieldType,
    SearchAsYouTypeFieldType, FlattenedFieldType, AnnotatedTextFieldType)}


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
    # field -> (input, weight, contexts) entries (completion fields)
    completion_entries: Dict[str, List[Any]] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Document mapper / parser
# ---------------------------------------------------------------------------

_DYNAMIC_DATE_RE = re.compile(r"\d{4}[-/]\d{2}[-/]\d{2}([T ].*)?$")


def _field_type(path: str, conf: Dict[str, Any]) -> MappedFieldType:
    type_name = conf.get("type", "object")
    cls = FIELD_TYPES.get(type_name)
    if cls is None:
        raise MapperParsingException(
            f"No handler for type [{type_name}] declared on field [{path}]")
    return cls(path, {k: v for k, v in conf.items()
                      if k not in ("type", "fields")})


class DocumentMapper:
    """Field map of one index: dotted path -> MappedFieldType. The
    mapping's ``dynamic`` decides what an unmapped field does: ``true``
    (the default) maps it from its first value, ``false`` leaves it
    unindexed (it stays in ``_source``), ``strict`` refuses the
    document. A field's ``copy_to`` indexes its values into the target
    fields too. ``nested_paths`` holds the paths mapped ``nested``.
    ``analysis`` is the index's AnalysisRegistry: a text field indexes
    with its ``analyzer`` and queries with its ``search_analyzer``
    (``index_analyzer``, ``search_analyzer``)."""

    def __init__(self, mappings: Optional[Dict[str, Any]] = None,
                 analysis: Optional[AnalysisRegistry] = None):
        self.fields: Dict[str, MappedFieldType] = {}
        self.analysis = analysis or AnalysisRegistry()
        self.dynamic = "true"
        self.nested_paths: set = set()
        if mappings:
            self._add_properties("", mappings.get("properties", {}))
            self.dynamic = str(mappings.get("dynamic", "true")).lower()

    def field_type(self, name: str) -> Optional[MappedFieldType]:
        return self.fields.get(name)

    def index_analyzer(self, ft: Optional[MappedFieldType]) -> Analyzer:
        """The analyzer ``ft`` indexes with (``standard`` by name for a
        field without one)."""
        return self.analysis.resolve(getattr(ft, "analyzer_name",
                                             "standard"))

    def search_analyzer(self, ft: Optional[MappedFieldType]) -> Analyzer:
        """The analyzer a query on ``ft`` analyzes with: its
        ``search_analyzer``, else its ``analyzer``, else ``standard``."""
        return self.analysis.resolve(getattr(
            ft, "search_analyzer_name",
            getattr(ft, "analyzer_name", "standard")))

    def standard_analyzed(self, ft: Optional[MappedFieldType]) -> bool:
        """Whether ``ft`` indexes and searches with the builtin standard
        analyzer itself, the one the fast path's C++ tokenizer mirrors
        (an index whose ``analysis`` redefines ``standard`` or
        ``default`` fails this for its fields)."""
        return (is_builtin_standard(self.index_analyzer(ft))
                and is_builtin_standard(self.search_analyzer(ft)))

    def _add_properties(self, prefix: str, props: Dict[str, Any]):
        for name, conf in props.items():
            path = f"{prefix}{name}"
            type_name = conf.get("type", "object")
            if type_name in ("object", "nested"):
                # a nested object indexes flattened; the nested query
                # restores the per-object correlation from _source
                if type_name == "nested":
                    self.nested_paths.add(path)
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
            if isinstance(ft, SearchAsYouTypeFieldType):
                for n in range(2, ft.max_shingle_size + 1):
                    sub = f"{path}._{n}gram"
                    self.fields[sub] = ShingleSubFieldType(sub, n)
                pre = f"{path}._index_prefix"
                self.fields[pre] = KeywordFieldType(pre)

    def to_mapping(self) -> Dict[str, Any]:
        """The mapping as the reference re-emits it: each field's type
        and parameters, multi-fields under their parent's ``fields``,
        the search_as_you_type subfields left out, and each nested path
        with its ``type``."""
        props: Dict[str, Any] = {}
        sub_paths = {f"{p}.{s}" for p, ft in self.fields.items()
                     for s in ft.subfields}
        for path, ft in sorted(self.fields.items()):
            if (isinstance(ft, ShingleSubFieldType)
                    or path.endswith("._index_prefix") or path in sub_paths):
                continue
            node = props
            parts = path.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {}).setdefault("properties", {})
            out = ft.to_mapping()
            if ft.subfields:
                out["fields"] = {s: self.fields[f"{path}.{s}"].to_mapping()
                                 for s in ft.subfields}
            node[parts[-1]] = out
        for npath in sorted(self.nested_paths):
            node = props
            parts = npath.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {}).setdefault("properties", {})
            node.setdefault(parts[-1], {})["type"] = "nested"
        return {"properties": props}

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

    def join_parent_routing(self, source: Dict[str, Any]) -> Optional[str]:
        """The parent id when ``source`` is a join child (the routing key
        the reference derives for it), else None."""
        for path, ft in self.fields.items():
            if not isinstance(ft, JoinFieldType):
                continue
            cur: Any = source
            for part in path.split("."):
                if not isinstance(cur, dict) or part not in cur:
                    cur = None
                    break
                cur = cur[part]
            if isinstance(cur, dict) and cur.get("parent") is not None:
                return str(cur["parent"])
        return None

    def _parse_join(self, path: str, ft: "JoinFieldType", value,
                    parsed: ParsedDocument):
        """``"rel"``, ``{"name": rel}`` or ``{"name": rel, "parent": id}``:
        the relation a term of the field, the parent id one of
        ``{field}#parent``; an unknown relation, or a child without its
        parent, is refused."""
        if isinstance(value, str):
            rel, parent = value, None
        elif isinstance(value, dict):
            rel, parent = value.get("name"), value.get("parent")
        else:
            raise MapperParsingException(f"failed to parse join field [{path}]")
        known = set(ft.relations) | {c for cs in ft.relations.values()
                                     for c in cs}
        if rel not in known:
            raise MapperParsingException(
                f"unknown join name [{rel}] for field [{path}]")
        if parent is None and ft.parent_of(rel) is not None:
            raise MapperParsingException(
                f"[parent] is missing for join field [{path}]")
        parsed.keyword_terms.setdefault(path, []).append(rel)
        if parent is not None:
            parsed.keyword_terms.setdefault(f"{path}#parent", []).append(
                str(parent))

    def _parse_object(self, prefix: str, obj: Dict[str, Any],
                      parsed: ParsedDocument):
        for key, value in obj.items():
            path = f"{prefix}{key}"
            ft = self.fields.get(path)
            if isinstance(ft, JoinFieldType):
                self._parse_join(path, ft, value, parsed)
                continue
            if isinstance(ft, PercolatorFieldType):
                ft.parse(value)     # validated; the query stays in _source
                continue
            if ft is not None and ft.docvalue_kind in (
                    "geo", "geoshape", "range", "rank_features",
                    "flattened", "completion"):
                # an object-valued field type: its object is ONE value
                if ft.docvalue_kind == "geo":
                    from elasticsearch_tpu_torch.common.geo import \
                        is_point_value
                    values = [value] if is_point_value(value) else list(value)
                else:
                    values = (list(value) if isinstance(value, (list, tuple))
                              else [value])
                self._index_values(ft, values, parsed)
                continue
            if isinstance(value, dict):
                self._parse_object(f"{path}.", value, parsed)
                continue
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
                if self.dynamic == "strict":
                    raise StrictDynamicMappingException(
                        f"mapping set to strict, dynamic introduction of "
                        f"[{path}] within [_doc] is not allowed")
                if self.dynamic == "false":
                    continue
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
            copy_to = ft.params.get("copy_to")
            if copy_to:
                for target in ([copy_to] if isinstance(copy_to, str)
                               else copy_to):
                    tft = self.fields.get(target)
                    if tft is not None and tft is not ft:
                        self._index_values(tft, values, parsed)
            # dynamic text fields also index into their .keyword subfield
            kw_ft = self.fields.get(f"{ft.name}.keyword")
            if (kw_ft is not None and isinstance(ft, TextFieldType)
                    and "keyword" not in ft.subfields):
                self._index_values(kw_ft, values, parsed)

    def _index_shingles(self, ft: "SearchAsYouTypeFieldType",
                        toks: List[Token], parsed: ParsedDocument):
        """The ``._{n}gram`` shingle subfields (a 100-position gap
        between values) and the ``._index_prefix`` keyword: every
        token's prefixes of up to 20 characters."""
        terms = [t.term for t in toks]
        for n in range(2, ft.max_shingle_size + 1):
            out = parsed.text_tokens.setdefault(f"{ft.name}._{n}gram", [])
            base = out[-1].position + 100 if out else 0
            for i in range(len(terms) - n + 1):
                out.append(Token(" ".join(terms[i:i + n]), base + i, -1, -1))
        prefixes = parsed.keyword_terms.setdefault(
            f"{ft.name}._index_prefix", [])
        for term in terms:
            for plen in range(1, min(len(term), 20) + 1):
                prefixes.append(term[:plen])

    def _index_text(self, ft: TextFieldType, text: str,
                    parsed: ParsedDocument):
        """A text value's tokens after the field's earlier values (a
        position gap of 100); an annotated_text value's annotations as
        verbatim tokens at their anchor's first position, the value's
        tokens re-sorted by position (stable: the text token first)."""
        annotations = []
        if isinstance(ft, AnnotatedTextFieldType):
            text, annotations = parse_annotated_text(text)
        analyzer = self.index_analyzer(ft)
        toks = parsed.text_tokens.get(ft.name)
        if (toks is None and not annotations
                and not isinstance(ft, SearchAsYouTypeFieldType)):
            # the field's first value: the standard analyzer's ASCII
            # terms alone (a TermRun), any other analyzer's Tokens
            parsed.text_tokens[ft.name] = analyzer.index_terms(text)
            return
        toks = parsed.text_tokens[ft.name] = list(toks or ())
        base = toks[-1].position + 100 if toks else 0
        new_toks = analyzer.analyze(text)
        if base:
            new_toks = [Token(t.term, base + t.position, t.start_offset,
                              t.end_offset) for t in new_toks]
        toks.extend(new_toks)
        if annotations:
            n_ann = 0
            for start, end, values in annotations:
                anchor = [t for t in new_toks if t.start_offset >= start
                          and t.end_offset <= end]
                pos = (anchor[0].position if anchor
                       else (new_toks[-1].position + 1 if new_toks
                             else base))
                toks.extend(Token(v, pos, start, end) for v in values)
                n_ann += len(values)
            tail = sorted(toks[len(toks) - len(new_toks) - n_ann:],
                          key=lambda t: t.position)
            toks[len(toks) - len(tail):] = tail
        if isinstance(ft, SearchAsYouTypeFieldType):
            self._index_shingles(ft, new_toks, parsed)

    def _index_values(self, ft: MappedFieldType, values: List[Any],
                      parsed: ParsedDocument):
        kind = ft.docvalue_kind
        for value in values:
            if value is None:
                continue
            typed = ft.parse(value)
            if typed is None:
                continue
            if kind == "postings":
                self._index_text(ft, typed, parsed)
            elif kind == "term":
                parsed.keyword_terms.setdefault(ft.name, []).append(typed)
            elif kind == "vector":
                parsed.vectors[ft.name] = typed
                parsed.vector_similarity[ft.name] = ft.similarity
            elif kind == "completion":
                parsed.completion_entries.setdefault(ft.name, []).extend(
                    typed)
            elif kind == "rank_features":
                for feat, v in typed.items():
                    parsed.numeric_values.setdefault(
                        f"{ft.name}.{feat}", []).append(v)
            elif kind == "range":
                lo, hi = typed
                parsed.numeric_values.setdefault(f"{ft.name}.lo",
                                                 []).append(lo)
                parsed.numeric_values.setdefault(f"{ft.name}.hi",
                                                 []).append(hi)
            elif kind == "flattened":
                for path, term in typed:
                    parsed.keyword_terms.setdefault(ft.name, []).append(term)
                    parsed.keyword_terms.setdefault(
                        f"{ft.name}.{path}", []).append(term)
            elif kind == "token_count":
                parsed.numeric_values.setdefault(ft.name, []).append(
                    float(len(self.index_analyzer(ft).analyze(typed))))
            elif kind == "geo":
                lat, lon = typed
                parsed.numeric_values.setdefault(f"{ft.name}.lat",
                                                 []).append(lat)
                parsed.numeric_values.setdefault(f"{ft.name}.lon",
                                                 []).append(lon)
            elif kind == "geoshape":
                for suffix, v in zip(("min_lat", "min_lon", "max_lat",
                                      "max_lon"), typed):
                    parsed.numeric_values.setdefault(
                        f"{ft.name}.{suffix}", []).append(v)
            else:
                parsed.numeric_values.setdefault(ft.name, []).append(
                    float(typed))
