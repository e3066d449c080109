"""Script engine: a sandboxed expression language evaluated over whole
device columns (counterpart of elasticsearch_tpu/search/script.py).

Painless compiles to JVM bytecode run per document; here the expression
is parsed with Python's ``ast`` module against a strict node allowlist
and evaluated ONCE over whole device tensors: ``doc['f'].value`` is an
[n] float32 column, ``cosineSimilarity(...)`` one matrix product, so a
script_score is a handful of elementwise torch ops, not a per-doc loop.

Supported surface (the score-script context):
- arithmetic / comparisons / boolean ops, parentheses
- ``doc['field'].value``, ``.size()``, ``.empty``: numeric doc values
- ``_score``: the subquery's score column
- ``params.name`` / ``params['name']``: request parameters
- ``cosineSimilarity(params.qv, 'field')``, ``dotProduct(...)``,
  ``l2norm(...)``: dense-vector functions (search/queries.py)
- ``Math.log/log10/sqrt/exp/abs/min/max/pow/floor/ceil``, ``Math.E``,
  ``Math.PI``, ``saturation``, ``sigmoid``

Float32 semantics: the reference's ``Math`` functions are ``jnp``
functions, which take Python numbers and compute in float32 (the
reference runs without x64). Torch's take tensors, so every ``Math``
function lifts its Python-number arguments to float32 tensors on the
device of its tensor argument (the CPU when it has none) and never
computes in Python's float64 ``math``. Arithmetic between Python
numbers stays Python arithmetic in both packages. ``.size()`` is an
int32 column, as the reference's.

A straight-line statement script (locals, then ``return expr``) folds
into one expression (``_desugar_straightline``); any other statement
script runs the Painless interpreter (script/) per matched doc on the
host, over at most ``SCRIPT_INTERP_MAX_DOCS`` docs: its score, mask and
columns come back through the tracked readback funnel
(ops/device.py ``readback``). Compilation is cached per source string.

``StoredScripts`` is a node's ``PUT /_scripts/{id}`` store, kept in
``_scripts.json`` under its data path (the reference's file, byte for
byte); search/queries.py ``resolve_script_source`` reads the serving
node's store for a script given by ``id``.
"""

from __future__ import annotations

import ast
import json
import os
import re
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import ScriptException
from elasticsearch_tpu_torch.ops.device import readback

_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare,
    ast.Call, ast.Attribute, ast.Subscript, ast.Name, ast.Constant,
    ast.Load, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod, ast.Pow,
    ast.FloorDiv, ast.USub, ast.UAdd, ast.Not, ast.And, ast.Or,
    ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.IfExp,
)


def _lift(*args) -> List[torch.Tensor]:
    """``args`` as tensors: Python numbers become float32 tensors on the
    device of the first tensor argument (the CPU when there is none)."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               torch.device("cpu"))
    return [a if isinstance(a, torch.Tensor)
            else torch.full((), a, dtype=torch.float32, device=dev)
            for a in args]


def _unary(fn):
    return staticmethod(lambda x: fn(*_lift(x)))


def _binary(fn):
    return staticmethod(lambda x, y: fn(*_lift(x, y)))


class _Math:
    log = _unary(torch.log)
    log10 = _unary(torch.log10)
    sqrt = _unary(torch.sqrt)
    exp = _unary(torch.exp)
    abs = _unary(torch.abs)
    min = _binary(torch.minimum)
    max = _binary(torch.maximum)
    pow = _binary(torch.pow)
    floor = _unary(torch.floor)
    ceil = _unary(torch.ceil)
    E = float(np.e)
    PI = float(np.pi)


class _DocColumn:
    """`doc['field']`: .value / .size() / .empty like the painless doc
    map, over a float32 column and its bool missing mask."""

    def __init__(self, values, missing):
        self.value = values
        self._missing = missing

    def size(self):
        return (~self._missing).to(torch.int32)

    @property
    def empty(self):
        return self._missing


class _Params:
    def __init__(self, params: Dict[str, Any]):
        self._params = params

    def __getattr__(self, name):
        try:
            return self._params[name]
        except KeyError:
            raise ScriptException(f"missing script parameter [{name}]")

    def __getitem__(self, name):
        return getattr(self, name)


class ScriptContext:
    """Everything a score script may touch, columnar (built by the query
    layer per segment, or per launch row on the plan path)."""

    def __init__(self, doc_columns: Callable[[str], _DocColumn],
                 params: Dict[str, Any],
                 score=None,
                 vector_fns: Optional[Dict[str, Callable]] = None,
                 mask=None):
        self._doc_columns = doc_columns
        self.params = _Params(params)
        self.score = score
        self.vector_fns = vector_fns or {}
        # matched-doc mask: the statement tier iterates THIS, not
        # score > 0 (filter-only subqueries match with score 0)
        self.mask = mask


class _Doc:
    def __init__(self, ctx: ScriptContext):
        self._ctx = ctx

    def __getitem__(self, field: str) -> _DocColumn:
        return self._ctx._doc_columns(field)


# the per-context allowlist (ref: painless per-context whitelists)
_ALLOWED_NAMES = {
    "doc", "params", "_score", "Math", "saturation", "sigmoid",
    "cosineSimilarity", "dotProduct", "l2norm", "True", "False",
}


# the attributes the score context defines: torch tensors are mutable
# (``doc['f'].value.zero_()`` would overwrite the resident column), so
# every other attribute is refused, not only the private ones
_DOC_ATTRS = {"value", "size", "empty", "getValue"}
_MATH_ATTRS = {n for n in vars(_Math) if not n.startswith("_")}


def _validate(tree: ast.AST, source: str):
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ScriptException(
                f"compile error: [{type(node).__name__}] is not allowed in "
                f"scripts: [{source}]")
        if isinstance(node, ast.Attribute):
            owner = (node.value.id if isinstance(node.value, ast.Name)
                     else None)
            allowed = (not node.attr.startswith("_")
                       if owner == "params" else
                       node.attr in (_MATH_ATTRS if owner == "Math"
                                     else _DOC_ATTRS))
            if not allowed:
                raise ScriptException(
                    f"compile error: access to [{node.attr}] is not "
                    f"allowed")
        if isinstance(node, ast.Name) and node.id not in _ALLOWED_NAMES:
            raise ScriptException(
                f"compile error: unknown variable [{node.id}]")


_cache: Dict[str, Any] = {}
_cache_lock = threading.Lock()

# per-doc interpretation cap: a statement script (loops, branches) runs
# the interpreter doc by doc on the host; above this many docs the
# request must use the expression form instead (a 400, not minutes of
# host time)
SCRIPT_INTERP_MAX_DOCS = 200_000

_DECL_RE = re.compile(
    r"^(def|double|float)\s+(\w+)\s*=(?!=)\s*(.+)$", re.S)
_ASSIGN_RE = re.compile(r"^()(\w+)\s*=(?!=)\s*(.+)$", re.S)
# int/int division truncates in painless (Java semantics) but not in
# the folded float evaluation: any literal-by-literal / or % bails
_INT_DIV_RE = re.compile(r"(?<![\w.])\d+\s*[/%]\s*\d+(?![\w.])")


def _desugar_straightline(source: str) -> Optional[str]:
    """Fold a straight-line statement script (local declarations and
    reassignments followed by ``return expr``) into ONE expression by
    symbolic substitution, so it rides the vectorized tier instead of
    the per-doc interpreter. None when the script has control flow,
    strings, or a statement shape the fold cannot prove safe: those keep
    the interpreter's semantics."""
    # string literals (doc['field'] keys) hide behind \x00N\x00
    # placeholders so ';' splitting and \b-substitution never touch
    # their contents; they are restored into the folded expression
    lits: List[str] = []

    def _mask(m):
        lits.append(m.group(0))
        return f"\x00{len(lits) - 1}\x00"

    masked = re.sub(r"'[^'\n]*'|\"[^\"\n]*\"", _mask, source)
    if "'" in masked or '"' in masked:
        return None           # unterminated / escaped quoting: bail
    if _INT_DIV_RE.search(masked):
        return None           # Java int division truncates; float won't
    stmts = [s.strip() for s in masked.split(";") if s.strip()]
    if not stmts or not re.match(r"return\b", stmts[-1]):
        return None
    env: Dict[str, str] = {}

    def subst(expr: str) -> str:
        for name, rep in env.items():
            expr = re.sub(rf"\b{re.escape(name)}\b", rep, expr)
        return expr

    has_div = re.search(r"[/%]", masked) is not None
    for s in stmts[:-1]:
        m = _DECL_RE.match(s) or _ASSIGN_RE.match(s)
        if m is None:
            return None
        typ, name, expr = m.group(1), m.group(2), m.group(3)
        if typ == "def" and has_div:
            return None       # a def local could be int-typed: / or %
        env[name] = "(" + subst(expr) + ")"
    ret = stmts[-1][len("return"):].strip()
    if not ret:
        return None
    return re.sub(r"\x00(\d+)\x00", lambda m: lits[int(m.group(1))],
                  subst(ret))


def compile_script(source: str):
    """Parse and validate; returns a callable(ctx) -> column or number,
    whose ``vectorized`` says its tier:

    1. expression scripts, including straight-line statement scripts
       folded by :func:`_desugar_straightline`: torch ops over whole
       device columns;
    2. statement scripts with control flow (if/for/while, functions:
       anything the expression grammar rejects): the Painless
       interpreter (script/) per matched doc on the host.
    """
    with _cache_lock:
        code = _cache.get(source)
    if code is None:
        expr_src = source
        try:
            tree = ast.parse(expr_src, mode="eval")
            _validate(tree, expr_src)
        except (SyntaxError, ScriptException):
            folded = _desugar_straightline(source)
            if folded is None:
                return _compile_painless_score(source)
            try:
                expr_src = folded
                tree = ast.parse(expr_src, mode="eval")
                _validate(tree, expr_src)
            except (SyntaxError, ScriptException):
                return _compile_painless_score(source)
        code = compile(tree, "<script>", "eval")
        with _cache_lock:
            _cache[source] = code

    def run(ctx: ScriptContext):
        namespace = {
            "doc": _Doc(ctx),
            "params": ctx.params,
            "_score": ctx.score,
            "Math": _Math,
            "saturation": lambda v, pivot: v / (v + pivot),
            "sigmoid": lambda v, k, a: v ** a / (k ** a + v ** a),
        }
        namespace.update(ctx.vector_fns)
        try:
            return eval(code, {"__builtins__": {}}, namespace)  # noqa: S307
        except ScriptException:
            raise
        except Exception as e:
            raise ScriptException(f"runtime error: {e} in script [{source}]")

    run.vectorized = True      # expression tier: whole columns
    return run


def as_column(value, n: int, device) -> torch.Tensor:
    """A script's result as a float32 [n] column on ``device``: a column
    is cast, a number (a script that reads no column) broadcast, as the
    reference's ``jnp.broadcast_to(jnp.asarray(v, jnp.float32), (n,))``."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32).broadcast_to(n)
    return torch.full((n,), float(np.float32(value)), dtype=torch.float32,
                      device=device)


def _compile_painless_score(source: str):
    """Statement-script score path: parse with the full Painless
    compiler now (errors surface when the query parses), evaluate per
    matched doc when it runs."""
    from elasticsearch_tpu_torch.script.interp import (ContextShim,
                                                       PainlessError,
                                                       compile_painless)
    try:
        script = compile_painless(source)
    except PainlessError as e:
        raise ScriptException(str(e))
    except ScriptException:
        raise
    except Exception as e:
        raise ScriptException(f"compile error: {e}: [{source}]")

    class _DocShim(ContextShim):
        def __init__(self, cols, i):
            self._cols = cols
            self._i = i

        def pl_index(self, field):
            vals, miss = self._cols(field)
            v = vals[self._i]
            # numpy scalars -> plain Python numbers (the interpreter's
            # type checks and Java semantics key on int/float)
            return _PlCol(v.item() if hasattr(v, "item") else v,
                          bool(miss[self._i]))

        def pl_call(self, name, args):
            if name == "containsKey":
                try:
                    self._cols(args[0])
                    return True
                except Exception:
                    return False
            raise PainlessError(f"unknown method [{name}] on doc")

    class _PlCol(ContextShim):
        def __init__(self, value, missing):
            self._value = value
            self._missing = missing

        def pl_get(self, name):
            if name == "value":
                if self._missing:
                    raise PainlessError(
                        "A document doesn't have a value for a field")
                return self._value
            if name == "empty":
                return self._missing
            raise PainlessError(f"unknown field [{name}]")

        def pl_call(self, name, args):
            if name == "size":
                return 0 if self._missing else 1
            if name == "getValue":
                return self.pl_get("value")
            raise PainlessError(f"unknown method [{name}]")

    def run(ctx: ScriptContext):
        base = ctx.score if ctx.score is not None else ctx.mask
        if base is None:
            raise ScriptException(
                "statement scripts require a scored context")
        nd = int(base.shape[0])
        if nd > SCRIPT_INTERP_MAX_DOCS:
            raise ScriptException(
                f"statement script over {nd} docs exceeds the "
                f"interpreter budget ({SCRIPT_INTERP_MAX_DOCS}); "
                f"use the expression form (vectorized) instead")
        col_cache: Dict[str, tuple] = {}

        def cols(field):
            hit = col_cache.get(field)
            if hit is None:
                c = ctx._doc_columns(field)
                hit = readback("search.script.statement_column", c.value,
                               c._missing)
                col_cache[field] = hit
            return hit

        score_np = (readback("search.script.statement_score", ctx.score)
                    if ctx.score is not None else None)
        mask_np = (readback("search.script.statement_mask", ctx.mask)
                   if ctx.mask is not None else None)
        params = dict(ctx.params._params)
        out = np.zeros(nd, np.float32)
        # iterate the MATCHED docs: the mask when available (filter-only
        # subqueries match with base score 0), else score > 0
        if mask_np is not None:
            idxs = np.nonzero(mask_np)[0]
        else:
            idxs = np.nonzero(score_np > 0)[0]
        for i in idxs:
            env = {"doc": _DocShim(cols, int(i)),
                   "params": params,
                   "_score": (float(score_np[i])
                              if score_np is not None else 0.0)}
            try:
                v = script.execute(env)
            except PainlessError as e:
                raise ScriptException(str(e))
            out[i] = float(v) if v is not None else 0.0
        return torch.from_numpy(out).to(base.device)

    run.vectorized = False     # per-doc interpreter tier
    return run


class StoredScripts:
    """The node's stored scripts, ``{id: {"lang", "source"}}``,
    persisted to ``_scripts.json`` under ``data_path`` on every change
    (the reference's cluster-state ScriptMetadata)."""

    def __init__(self, data_path: str):
        self._path = os.path.join(data_path, "_scripts.json")
        self._scripts: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        if os.path.exists(self._path):
            with open(self._path) as fh:
                self._scripts = json.load(fh)

    def _persist_locked(self) -> None:
        tmp = self._path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._scripts, fh)
        os.replace(tmp, self._path)

    def put(self, script_id: str, script: Dict[str, Any]) -> None:
        if not isinstance(script, dict) or "source" not in script:
            raise ScriptException("stored script requires [script.source]")
        with self._lock:
            self._scripts[script_id] = {
                "lang": script.get("lang", "painless"),
                "source": script["source"]}
            self._persist_locked()

    def get(self, script_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._scripts.get(script_id)

    def delete(self, script_id: str) -> bool:
        with self._lock:
            if script_id not in self._scripts:
                return False
            del self._scripts[script_id]
            self._persist_locked()
            return True
