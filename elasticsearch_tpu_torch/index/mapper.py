"""Document mapping for the `_search` BM25 slice (counterpart of
elasticsearch_tpu/index/mapper.py), reduced to ``text`` fields: a
document parses into per-field token lists.

Explicit mappings may declare only ``text`` fields with the standard
analyzer; other field types belong to later slices and are refused.
Dynamic mapping maps a string value to a ``text`` field and leaves
every other value in ``_source`` only.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.analysis.analyzers import (SUPPORTED,
                                                        StandardAnalyzer)
from elasticsearch_tpu_torch.analysis.tokenizers import Token


class MapperParsingException(ValueError):
    """A mapping or document this slice cannot take."""


@dataclass
class ParsedDocument:
    doc_id: str
    source: bytes
    # field -> analyzed tokens
    text_tokens: Dict[str, List[Token]] = field(default_factory=dict)


class DocumentMapper:
    """Field map of one index: dotted path -> "text"."""

    def __init__(self, mappings: Optional[Dict[str, Any]] = None):
        self.fields: Dict[str, str] = {}
        self.analyzer = StandardAnalyzer()
        if mappings:
            props = mappings.get("properties", {})
            self._add_properties("", props)

    def _add_properties(self, prefix: str, props: Dict[str, Any]):
        for name, spec in props.items():
            path = f"{prefix}{name}"
            if "properties" in spec and "type" not in spec:
                self._add_properties(f"{path}.", spec["properties"])
                continue
            ftype = spec.get("type", "object")
            if ftype != "text":
                raise MapperParsingException(
                    f"field [{path}] has type [{ftype}]: this slice of the "
                    f"port indexes text fields only")
            for key in ("analyzer", "search_analyzer"):
                if spec.get(key, "standard") not in SUPPORTED:
                    raise MapperParsingException(
                        f"field [{path}] asks for analyzer "
                        f"[{spec[key]}]: this slice has the standard "
                        f"analyzer only")
            self.fields[path] = "text"

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
            values = value if isinstance(value, list) else [value]
            if values and isinstance(values[0], dict):
                for v in values:
                    self._parse_object(f"{path}.", v, parsed)
                continue
            if path not in self.fields:
                if not any(isinstance(v, str) for v in values):
                    continue
                self.fields[path] = "text"
            toks = parsed.text_tokens.setdefault(path, [])
            for v in values:
                if v is None:
                    continue
                # position gap of 100 between the values of one field
                base = toks[-1].position + 100 if toks else 0
                toks.extend(Token(t.term, base + t.position, t.start_offset,
                                  t.end_offset)
                            for t in self.analyzer.analyze(str(v)))
