"""Script contexts (counterpart of elasticsearch_tpu/script/contexts.py,
reduced to the contexts the port serves: the aggregations' and the
update context of ``_update``; the ingest context waits with ingest).

Plain dicts and lists are the Map and List types inside the
interpreter, so ``state``, ``states`` and ``params`` (of
``scripted_metric``, ``bucket_script`` and ``bucket_selector``) bind
directly; host objects that are not plain data go through
``ContextShim`` adapters. ``DocValues`` is the ``doc`` of a
``scripted_metric`` map script: one document's first doc value per
field (``doc['f'].value``, ``.empty``, ``.size()``, ``.getValue()``),
read from the segment's host columns, as the reference's scripted-metric
doc shim.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from elasticsearch_tpu_torch.script.interp import (ContextShim, PainlessError,
                                                   compile_painless)


class _Value(ContextShim):
    """One field of ``doc``: its first value, or None."""

    def __init__(self, value):
        self._v = value

    def pl_get(self, name):
        if name == "value":
            if self._v is None:
                raise PainlessError(
                    "A document doesn't have a value for a field")
            return self._v
        if name == "empty":
            return self._v is None
        raise PainlessError(f"unknown field [{name}]")

    def pl_call(self, name, args):
        if name == "size":
            return 0 if self._v is None else 1
        if name == "getValue":
            return self.pl_get("value")
        raise PainlessError(f"unknown method [{name}]")


class DocValues(ContextShim):
    """``doc`` of document ``d`` of ``seg``: a numeric column's first
    value as a float, else a keyword column's first term, else
    nothing."""

    def __init__(self, seg, d: int):
        self._seg = seg
        self._d = d

    def pl_index(self, field):
        seg, d = self._seg, self._d
        nv = seg.numerics.get(field)
        if nv is not None:
            return _Value(None if bool(nv.missing[d])
                          else float(nv.values[d]))
        kv = seg.keywords.get(field)
        if kv is not None:
            ords = kv.all_ords[kv.offsets[d]: kv.offsets[d + 1]]
            return _Value(kv.terms[ords[0]] if len(ords) else None)
        return _Value(None)



class UpdateCtx(ContextShim):
    """``ctx`` of an update script (reindex/worker.py ``_Ctx``): the
    ``_source`` map, ``_index``/``_id``/``_version``, and the mutable
    ``op``."""

    def __init__(self, ctx):
        self._ctx = ctx

    def pl_get(self, name):
        if name == "_source":
            return self._ctx._source._data
        if name == "op":
            return self._ctx.op
        if name in ("_index", "_id", "_version"):
            return getattr(self._ctx, name)
        raise PainlessError(f"unknown ctx field [{name}]")

    def pl_set(self, name, value):
        if name == "op":
            self._ctx.op = value
            return
        raise PainlessError(f"cannot write ctx.{name}")

    def pl_index(self, key):
        return self.pl_get(key)


def run_update_script(source: str, ctx,
                      params: Optional[Dict[str, Any]] = None) -> None:
    script = compile_painless(source)
    script.execute({"ctx": UpdateCtx(ctx), "params": dict(params or {})})


def try_compile(source: str) -> bool:
    """True when ``source`` compiles as Painless (the update script keeps
    the legacy expression engine for what does not)."""
    try:
        compile_painless(source)
        return True
    except Exception:
        return False
