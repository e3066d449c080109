"""The update-script context of ``_update`` and the `_bulk` update item
(the port's copy of elasticsearch_tpu/reindex/worker.py's update-script
part: ``_SourceProxy``, ``_Ctx``, ``UpdateScript`` and
``compile_update_script``). A script mutates ``ctx._source`` and may set
``ctx.op`` to ``none`` (a noop) or ``delete``. The scroll and bulk
worker behind `_reindex` and `_update_by_query` is a later slice.
"""

from __future__ import annotations

import ast
from typing import Any, Dict, Optional

from elasticsearch_tpu_torch.common.errors import ScriptException
from elasticsearch_tpu_torch.script import contexts as _plctx
from elasticsearch_tpu_torch.script.interp import PainlessError


_ALLOWED_STMT = (ast.Module, ast.Assign, ast.AugAssign, ast.Expr, ast.If,
                 ast.Pass)
_ALLOWED_EXPR = (
    ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare, ast.Call, ast.IfExp,
    ast.Attribute, ast.Subscript, ast.Name, ast.Constant, ast.List,
    ast.Dict, ast.Tuple, ast.Load, ast.Store, ast.Add, ast.Sub, ast.Mult,
    ast.Div, ast.Mod, ast.Pow, ast.FloorDiv, ast.USub, ast.UAdd, ast.Not,
    ast.And, ast.Or, ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
    ast.In, ast.NotIn, ast.Is, ast.IsNot,
)


class _SourceProxy:
    """``ctx._source``: attribute/item access onto the source dict, so the
    painless idioms ``ctx._source.counter += 1`` and
    ``ctx._source['tags'] = [...]`` both work."""

    def __init__(self, source: Dict[str, Any]):
        object.__setattr__(self, "_data", source)

    def __getattr__(self, name):
        try:
            v = self._data[name]
        except KeyError:
            return None
        return _SourceProxy(v) if isinstance(v, dict) else v

    def __setattr__(self, name, value):
        self._data[name] = value

    def __getitem__(self, name):
        return getattr(self, name)

    def __setitem__(self, name, value):
        self._data[name] = value

    def __contains__(self, name):
        return name in self._data

    def remove(self, name):
        self._data.pop(name, None)

    def containsKey(self, name):  # painless Map surface
        return name in self._data

    def get(self, name, default=None):
        return self._data.get(name, default)


class _Ctx:
    """The update-script ``ctx`` variable (Elasticsearch's UpdateHelper:
    _source, _index, _id, _version, and the mutable ``op``)."""

    def __init__(self, source, index, doc_id, version):
        self._source = _SourceProxy(source)
        self._index = index
        self._id = doc_id
        self._version = version
        self.op = "index"


_SAFE_FUNCS = {
    "abs": abs, "min": min, "max": max, "round": round, "len": len,
    "str": str, "int": int, "float": float, "bool": bool,
}


def _painless_to_python(source: str) -> str:
    """Normalize painless-isms (``;`` statement ends, ``&&``/``||``/``!``)
    to python, WITHOUT touching quoted string literals."""
    out = []
    quote = None
    i = 0
    n = len(source)
    while i < n:
        c = source[i]
        if quote is not None:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(source[i + 1])
                i += 2
                continue
            if c == quote:
                quote = None
            i += 1
            continue
        if c in "'\"":
            quote = c
            out.append(c)
            i += 1
            continue
        two = source[i:i + 2]
        if two == "&&":
            out.append(" and ")
            i += 2
        elif two == "||":
            out.append(" or ")
            i += 2
        elif two == "!=":
            out.append("!=")
            i += 2
        elif c == "!":
            out.append(" not ")
            i += 1
        elif c == ";":
            out.append("\n")  # statement end; indentation of the next
            i += 1            # physical line still governs blocks
            while i < n and source[i] == " ":
                i += 1
        else:
            out.append(c)
            i += 1
    lines = [l for l in "".join(out).split("\n") if l.strip()]
    return "\n".join(lines)


class UpdateScript:
    """A compiled update-context script: Painless through the port's
    interpreter (script/), else the legacy expression translation for
    what it cannot parse."""

    def __init__(self, source: str, params: Optional[Dict[str, Any]] = None):
        self.source = source
        self.params = params or {}
        self._painless = _plctx.try_compile(source)
        if self._painless:
            self._code = None
            return
        py = _painless_to_python(source)
        try:
            tree = ast.parse(py, mode="exec")
        except SyntaxError as e:
            raise ScriptException(f"compile error in script [{source}]: {e}")
        for node in ast.walk(tree):
            if not isinstance(node, _ALLOWED_STMT + _ALLOWED_EXPR):
                raise ScriptException(
                    f"illegal construct [{type(node).__name__}] in script")
            if isinstance(node, ast.Name) and node.id not in (
                    "ctx", "params") and node.id not in _SAFE_FUNCS:
                raise ScriptException(f"unknown variable [{node.id}]")
            if isinstance(node, ast.Attribute) and node.attr.startswith("__"):
                raise ScriptException("dunder access is not allowed")
        self._code = compile(tree, "<update-script>", "exec")

    def run(self, ctx: _Ctx) -> None:
        if self._painless:
            try:
                _plctx.run_update_script(self.source, ctx, self.params)
            except PainlessError as e:
                raise ScriptException(str(e))
            return
        scope = dict(_SAFE_FUNCS)
        scope["ctx"] = ctx
        scope["params"] = _ScriptParams(self.params)
        exec(self._code, {"__builtins__": {}}, scope)


class _ScriptParams(dict):
    def __init__(self, d):
        super().__init__(d)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise ScriptException(f"missing script parameter [{name}]")


def compile_update_script(spec: Any) -> Optional[UpdateScript]:
    if spec is None:
        return None
    if isinstance(spec, str):
        return UpdateScript(spec)
    return UpdateScript(spec.get("source", ""), spec.get("params"))
