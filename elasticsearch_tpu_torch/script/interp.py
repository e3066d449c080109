"""Sandboxed tree-walking interpreter for the Painless AST.

The reference compiles to JVM bytecode with per-context whitelists
(ref: modules/lang-painless/.../PainlessScriptEngine.java, the
org.elasticsearch.script.*.txt whitelist files) and guards runaway
scripts with a loop counter (ref: Compiler settings MAX_LOOP_COUNTER).
This interpreter mirrors those contracts:

- Java semantics where they differ from Python: integer division
  truncates toward zero, % takes the dividend's sign, `+` with a string
  operand concatenates via Java-style toString, int shifts.
- values are plain Python objects; METHOD allowlists are keyed by
  python type — there is no route from a script value to arbitrary
  Python attributes (field access only resolves Map keys, allowlisted
  properties, and context shims).
- execution budget: ops counter raised on every statement and loop
  iteration; exceeding it aborts the script.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import ScriptException
from elasticsearch_tpu_torch.script.painless import parse_program

MAX_OPS = 1_000_000


class PainlessError(ScriptException):
    pass


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Thrown(PainlessError):
    """A script-thrown exception (throw new IllegalArgumentException(..))."""


def _java_str(v) -> str:
    if v is None:
        return "null"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return f"{v:.1f}"
    if isinstance(v, list):
        return "[" + ", ".join(_java_str(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_java_str(k)}={_java_str(x)}"
                               for k, x in v.items()) + "}"
    return str(v)


def _java_div(a, b):
    if isinstance(a, int) and isinstance(b, int):
        if b == 0:
            raise PainlessError("/ by zero")
        q = abs(a) // abs(b)
        return q if (a >= 0) == (b >= 0) else -q
    return a / b


def _java_mod(a, b):
    if isinstance(a, int) and isinstance(b, int):
        if b == 0:
            raise PainlessError("/ by zero")
        return a - _java_div(a, b) * b
    return math.fmod(a, b)


def _num(v, what="operand"):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise PainlessError(f"cannot apply numeric op to {what} "
                            f"[{_java_str(v)}]")
    return v


def _truthy(v) -> bool:
    if not isinstance(v, bool):
        raise PainlessError(
            f"condition is not a boolean: [{_java_str(v)}]")
    return v


# ----------------------------------------------------------------- methods
# per-type instance-method allowlists (the whitelist .txt analogue)

def _substring(s, a, b=None):
    n = len(s)
    b = n if b is None else b
    if a < 0 or b > n or a > b:
        raise PainlessError(f"substring({a},{b}) out of range for "
                            f"length {n}")
    return s[a:b]


_STR_METHODS: Dict[str, Callable] = {
    "length": lambda s: len(s),
    "isEmpty": lambda s: len(s) == 0,
    "contains": lambda s, x: x in s,
    "startsWith": lambda s, x: s.startswith(x),
    "endsWith": lambda s, x: s.endswith(x),
    "indexOf": lambda s, x, f=0: s.find(x, f),
    "lastIndexOf": lambda s, x: s.rfind(x),
    "substring": _substring,
    "toLowerCase": lambda s: s.lower(),
    "toUpperCase": lambda s: s.upper(),
    "trim": lambda s: s.strip(),
    "strip": lambda s: s.strip(),
    "replace": lambda s, a, b: s.replace(a, b),
    "split": lambda s, sep: _split_java(s, sep),
    "charAt": lambda s, i: s[i],
    "equals": lambda s, o: s == o,
    "equalsIgnoreCase": lambda s, o: isinstance(o, str)
    and s.lower() == o.lower(),
    "compareTo": lambda s, o: (s > o) - (s < o),
    "concat": lambda s, o: s + o,
    "toString": _java_str,
    "hashCode": lambda s: hash(s) & 0x7FFFFFFF,
    "matches": lambda s, p: __import__("re").fullmatch(p, s) is not None,
    "repeat": lambda s, n: s * n,
    "toCharArray": lambda s: list(s),
    "join": lambda s, parts: s.join(_java_str(p) for p in parts),
}


def _split_java(s: str, sep: str):
    import re
    out = re.split(sep, s)
    while out and out[-1] == "":
        out.pop()
    return out


def _list_remove(lst, x):
    # Java List.remove(int) removes BY INDEX, remove(Object) by value
    if isinstance(x, int) and not isinstance(x, bool):
        if x < 0 or x >= len(lst):
            raise PainlessError(f"index {x} out of bounds")
        return lst.pop(x)
    try:
        lst.remove(x)
        return True
    except ValueError:
        return False


def _list_sort(lst, cmp=None):
    if cmp is None:
        lst.sort()
    else:
        import functools
        lst.sort(key=functools.cmp_to_key(
            lambda a, b: int(cmp(a, b))))
    return None


_LIST_METHODS: Dict[str, Callable] = {
    "add": lambda l, *a: (l.insert(a[0], a[1]) if len(a) == 2
                          else l.append(a[0])) or True,
    "addAll": lambda l, o: l.extend(o) or True,
    "get": lambda l, i: _list_get(l, i),
    "set": lambda l, i, v: _list_set(l, i, v),
    "size": lambda l: len(l),
    "isEmpty": lambda l: len(l) == 0,
    "contains": lambda l, x: x in l,
    "indexOf": lambda l, x: l.index(x) if x in l else -1,
    "remove": _list_remove,
    "removeIf": lambda l, pred: _remove_if(l, pred),
    "clear": lambda l: l.clear(),
    "sort": _list_sort,
    "reverse": lambda l: l.reverse(),
    "toString": _java_str,
    "hashCode": lambda l: 0,
    "subList": lambda l, a, b: l[a:b],
    "forEach": lambda l, fn: [fn(x) for x in list(l)] and None,
}


def _list_get(lst, i):
    if not isinstance(i, int) or i < 0 or i >= len(lst):
        raise PainlessError(f"index [{i}] out of bounds for list of "
                            f"size [{len(lst)}]")
    return lst[i]


def _list_set(lst, i, v):
    old = _list_get(lst, i)
    lst[i] = v
    return old


def _remove_if(lst, pred):
    kept = [x for x in lst if not _truthy(pred(x))]
    changed = len(kept) != len(lst)
    lst[:] = kept
    return changed


_MAP_METHODS: Dict[str, Callable] = {
    "put": lambda m, k, v: m.__setitem__(k, v),
    "putAll": lambda m, o: m.update(o),
    "get": lambda m, k: m.get(k),
    "getOrDefault": lambda m, k, d: m.get(k, d),
    "containsKey": lambda m, k: k in m,
    "containsValue": lambda m, v: v in m.values(),
    "remove": lambda m, k: m.pop(k, None),
    "keySet": lambda m: list(m.keys()),
    "values": lambda m: list(m.values()),
    "entrySet": lambda m: [_MapEntry(k, v) for k, v in m.items()],
    "size": lambda m: len(m),
    "isEmpty": lambda m: len(m) == 0,
    "clear": lambda m: m.clear(),
    "toString": _java_str,
    "computeIfAbsent": lambda m, k, fn: m.setdefault(k, fn(k)),
    "merge": lambda m, k, v, fn: m.__setitem__(
        k, v if k not in m or m[k] is None else fn(m[k], v)) or m.get(k),
    "forEach": lambda m, fn: [fn(k, v)
                              for k, v in list(m.items())] and None,
}


class _MapEntry:
    def __init__(self, k, v):
        self._k = k
        self._v = v

    def getKey(self):
        return self._k

    def getValue(self):
        return self._v


_ENTRY_METHODS = {"getKey": _MapEntry.getKey, "getValue": _MapEntry.getValue}

_NUM_METHODS: Dict[str, Callable] = {
    "toString": _java_str,
    "intValue": lambda v: int(v),
    "longValue": lambda v: int(v),
    "doubleValue": lambda v: float(v),
    "floatValue": lambda v: float(v),
    "equals": lambda v, o: v == o,
    "compareTo": lambda v, o: (v > o) - (v < o),
}

_BOOL_METHODS = {"toString": _java_str, "equals": lambda v, o: v is o}


# ------------------------------------------------------------ static refs
class _StaticClass:
    def __init__(self, name, methods: Dict[str, Callable],
                 consts: Dict[str, Any] = None):
        self.name = name
        self.methods = methods
        self.consts = consts or {}


_MATH = _StaticClass("Math", {
    "abs": abs, "max": max, "min": min,
    "pow": lambda a, b: float(a) ** b, "sqrt": math.sqrt,
    "log": math.log, "log10": math.log10, "exp": math.exp,
    "floor": math.floor, "ceil": math.ceil,
    "round": lambda v: math.floor(v + 0.5),
    "random": None,   # installed per-engine (determinism control)
    "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "atan": math.atan, "atan2": math.atan2, "asin": math.asin,
    "acos": math.acos, "cbrt": lambda v: math.copysign(
        abs(v) ** (1 / 3), v),
    "hypot": math.hypot, "signum": lambda v: float((v > 0) - (v < 0)),
    "toDegrees": math.degrees, "toRadians": math.radians,
}, {"PI": math.pi, "E": math.e})


def _parse_int(s, radix=10):
    try:
        return int(s, radix)
    except (ValueError, TypeError):
        raise PainlessError(f"NumberFormatException: [{s}]")


def _parse_float(s):
    try:
        return float(s)
    except (ValueError, TypeError):
        raise PainlessError(f"NumberFormatException: [{s}]")


_STATICS: Dict[str, _StaticClass] = {
    "Math": _MATH,
    "Integer": _StaticClass("Integer", {
        "parseInt": _parse_int, "toString": _java_str,
        "valueOf": _parse_int if False else lambda v: int(v),
        "compare": lambda a, b: (a > b) - (a < b),
        "max": max, "min": min,
    }, {"MAX_VALUE": 2**31 - 1, "MIN_VALUE": -2**31}),
    "Long": _StaticClass("Long", {
        "parseLong": _parse_int, "toString": _java_str,
        "valueOf": lambda v: int(v),
        "compare": lambda a, b: (a > b) - (a < b),
        "max": max, "min": min,
    }, {"MAX_VALUE": 2**63 - 1, "MIN_VALUE": -2**63}),
    "Double": _StaticClass("Double", {
        "parseDouble": _parse_float, "toString": _java_str,
        "valueOf": lambda v: float(v),
        "isNaN": lambda v: isinstance(v, float) and math.isnan(v),
        "isInfinite": lambda v: isinstance(v, float) and math.isinf(v),
        "compare": lambda a, b: (a > b) - (a < b),
        "max": max, "min": min,
    }, {"MAX_VALUE": 1.7976931348623157e308, "NaN": float("nan"),
        "POSITIVE_INFINITY": float("inf"),
        "NEGATIVE_INFINITY": float("-inf")}),
    "Float": _StaticClass("Float", {
        "parseFloat": _parse_float, "valueOf": lambda v: float(v),
    }),
    "Boolean": _StaticClass("Boolean", {
        "parseBoolean": lambda s: s == "true",
        "valueOf": lambda s: s == "true" if isinstance(s, str) else bool(s),
        "toString": _java_str,
    }, {"TRUE": True, "FALSE": False}),
    "String": _StaticClass("String", {
        "valueOf": _java_str,
        "join": lambda sep, parts: sep.join(_java_str(p) for p in parts),
        "format": lambda fmt, *a: _java_format(fmt, a),
    }),
    "Objects": _StaticClass("Objects", {
        "equals": lambda a, b: a == b,
        "isNull": lambda a: a is None,
        "nonNull": lambda a: a is not None,
        "requireNonNull": lambda a: a if a is not None else
        (_ for _ in ()).throw(PainlessError("NullPointerException")),
        "hashCode": lambda a: 0 if a is None else hash(str(a)) & 0x7FFF,
        "toString": _java_str,
    }),
    "Collections": _StaticClass("Collections", {
        "sort": _list_sort,
        "reverse": lambda l: l.reverse(),
        "emptyList": lambda: [],
        "emptyMap": lambda: {},
        "max": max, "min": min,
        "unmodifiableList": lambda l: list(l),
        "unmodifiableMap": lambda m: dict(m),
        "shuffle": lambda l: None,   # deterministic no-op by design
        "singletonList": lambda x: [x],
    }),
    "Arrays": _StaticClass("Arrays", {
        "asList": lambda *a: list(a),
        "toString": _java_str,
    }),
}


def _java_format(fmt, args):
    # minimal %s/%d/%f/%x support
    try:
        return fmt % tuple(args)
    except (TypeError, ValueError) as e:
        raise PainlessError(f"format error: {e}")


_CONSTRUCTORS: Dict[str, Callable] = {
    "ArrayList": lambda *a: list(a[0]) if a else [],
    "HashMap": lambda *a: dict(a[0]) if a else {},
    "LinkedHashMap": lambda *a: dict(a[0]) if a else {},
    "TreeMap": lambda *a: dict(sorted((a[0] if a else {}).items())),
    "HashSet": lambda *a: list(dict.fromkeys(a[0])) if a else [],
    "StringBuilder": lambda *a: _StringBuilder(a[0] if a else ""),
    "String": lambda *a: str(a[0]) if a else "",
    "IllegalArgumentException": lambda *a: _make_thrown(a),
    "RuntimeException": lambda *a: _make_thrown(a),
    "Exception": lambda *a: _make_thrown(a),
}


def _make_thrown(args):
    return _Thrown(_java_str(args[0]) if args else "script exception")


class _StringBuilder:
    def __init__(self, initial=""):
        self._parts = [str(initial)]

    def append(self, v):
        self._parts.append(_java_str(v))
        return self

    def toString(self):
        return "".join(self._parts)

    def length(self):
        return sum(len(p) for p in self._parts)


_SB_METHODS = {
    "append": _StringBuilder.append,
    "toString": _StringBuilder.toString,
    "length": _StringBuilder.length,
}


class ContextShim:
    """Base for host objects exposed to scripts (ctx views, doc maps).
    Subclasses define pl_get/pl_set/pl_call; everything else is sealed."""

    def pl_get(self, name):
        raise PainlessError(f"unknown field [{name}]")

    def pl_set(self, name, value):
        raise PainlessError(f"cannot write [{name}]")

    def pl_call(self, name, args):
        raise PainlessError(f"unknown method [{name}]")

    def pl_contains(self, key):
        return False

    def pl_index(self, key):
        return self.pl_get(key)

    def pl_index_set(self, key, value):
        self.pl_set(key, value)


# -------------------------------------------------------------- interpreter
class Interp:
    def __init__(self, funcs: Dict[str, tuple], env: Dict[str, Any],
                 max_ops: int = MAX_OPS):
        self.funcs = funcs
        self.globals = env
        self.ops = 0
        self.max_ops = max_ops

    def tick(self):
        self.ops += 1
        if self.ops > self.max_ops:
            raise PainlessError(
                f"script exceeded the allowed number of statements "
                f"[{self.max_ops}] (runaway loop?)")

    # ------------------------------------------------------------- stmts
    def run_block(self, stmts: List[tuple], scope: Dict[str, Any]):
        for st in stmts:
            self.exec_stmt(st, scope)

    def exec_stmt(self, st: tuple, scope):
        self.tick()
        tag = st[0]
        if tag == "expr":
            self.eval(st[1], scope)
        elif tag == "decl":
            for name, init in st[2]:
                scope[name] = self.eval(init, scope) \
                    if init is not None else None
        elif tag == "if":
            if _truthy(self.eval(st[1], scope)):
                self.exec_stmt(st[2], scope)
            elif st[3] is not None:
                self.exec_stmt(st[3], scope)
        elif tag == "block":
            child = _ChildScope(scope)
            self.run_block(st[1], child)
        elif tag == "while":
            while _truthy(self.eval(st[1], scope)):
                self.tick()
                try:
                    self.exec_stmt(st[2], scope)
                except _Break:
                    break
                except _Continue:
                    continue
        elif tag == "dowhile":
            while True:
                self.tick()
                try:
                    self.exec_stmt(st[1], scope)
                except _Break:
                    break
                except _Continue:
                    pass
                if not _truthy(self.eval(st[2], scope)):
                    break
        elif tag == "for":
            child = _ChildScope(scope)
            if st[1] is not None:
                self.exec_stmt(st[1], child)
            while st[2] is None or _truthy(self.eval(st[2], child)):
                self.tick()
                try:
                    self.exec_stmt(st[4], child)
                except _Break:
                    break
                except _Continue:
                    pass
                if st[3] is not None:
                    self.exec_stmt(st[3], child)
        elif tag == "foreach":
            it = self.eval(st[2], scope)
            if isinstance(it, dict):
                it = list(it.keys())
            if isinstance(it, str):
                it = list(it)
            if not isinstance(it, list):
                raise PainlessError(
                    f"cannot iterate over [{_java_str(it)}]")
            child = _ChildScope(scope)
            for v in list(it):
                self.tick()
                child[st[1]] = v
                try:
                    self.exec_stmt(st[3], child)
                except _Break:
                    break
                except _Continue:
                    continue
        elif tag == "break":
            raise _Break()
        elif tag == "continue":
            raise _Continue()
        elif tag == "return":
            raise _Return(self.eval(st[1], scope)
                          if st[1] is not None else None)
        elif tag == "throw":
            v = self.eval(st[1], scope)
            raise v if isinstance(v, _Thrown) else _Thrown(_java_str(v))
        elif tag == "trycatch":
            try:
                self.exec_stmt(st[1], scope)
            except (_Break, _Continue, _Return):
                raise
            except PainlessError as e:
                child = _ChildScope(scope)
                child[st[2]] = _CaughtException(str(e))
                self.exec_stmt(st[3], child)
        else:
            raise PainlessError(f"unknown statement [{tag}]")

    # -------------------------------------------------------------- exprs
    def eval(self, e: tuple, scope):
        tag = e[0]
        if tag == "num" or tag == "str" or tag == "bool":
            return e[1]
        if tag == "null":
            return None
        if tag == "name":
            return self.lookup(e[1], scope)
        if tag == "list":
            return [self.eval(x, scope) for x in e[1]]
        if tag == "map":
            return {self.eval(k, scope): self.eval(v, scope)
                    for k, v in e[1]}
        if tag == "binop":
            return self.binop(e[1], e[2], e[3], scope)
        if tag == "unary":
            v = self.eval(e[2], scope)
            if e[1] == "!":
                return not _truthy(v)
            if e[1] == "-":
                return -_num(v)
            if e[1] == "+":
                return +_num(v)
            if e[1] == "~":
                if isinstance(v, bool) or not isinstance(v, int):
                    raise PainlessError("~ requires an integer")
                return ~v
        if tag == "ternary":
            return (self.eval(e[2], scope)
                    if _truthy(self.eval(e[1], scope))
                    else self.eval(e[3], scope))
        if tag == "elvis":
            v = self.eval(e[1], scope)
            return v if v is not None else self.eval(e[2], scope)
        if tag == "assign":
            return self.assign(e[1], e[2], e[3], scope)
        if tag == "preinc":
            delta = 1 if e[1] == "++" else -1
            v = _num(self.read_target(e[2], scope)) + delta
            self.write_target(e[2], v, scope)
            return v
        if tag == "postinc":
            v = _num(self.read_target(e[2], scope))
            self.write_target(e[2], v + (1 if e[1] == "++" else -1),
                              scope)
            return v
        if tag == "field":
            obj = self.eval(e[1], scope)
            if obj is None:
                if e[3]:            # null-safe ?.
                    return None
                raise PainlessError(
                    f"null pointer: cannot access [{e[2]}] on null")
            return self.get_field(obj, e[2])
        if tag == "index":
            obj = self.eval(e[1], scope)
            key = self.eval(e[2], scope)
            return self.get_index(obj, key)
        if tag == "call":
            return self.call(e, scope)
        if tag == "new":
            ctor = _CONSTRUCTORS.get(e[1])
            if ctor is None:
                raise PainlessError(
                    f"unknown type [{e[1]}] for new")
            args = [self.eval(a, scope) for a in e[2]]
            out = ctor(*args)
            if isinstance(out, _Thrown):
                return out
            return out
        if tag == "cast":
            return self.cast(e[1], self.eval(e[2], scope))
        if tag == "instanceof":
            return self.isinstance_of(self.eval(e[1], scope), e[2])
        if tag == "lambda":
            params, body = e[1], e[2]

            def fn(*args, _params=params, _body=body, _scope=scope):
                child = _ChildScope(_scope)
                for p, a in zip(_params, args):
                    child[p] = a
                if _body[0] == "block":
                    try:
                        self.exec_stmt(_body, child)
                    except _Return as r:
                        return r.value
                    return None
                return self.eval(_body, child)
            return fn
        raise PainlessError(f"unknown expression [{tag}]")

    def lookup(self, name, scope):
        s = scope
        while s is not None:
            if name in s:
                return s[name]
            s = getattr(s, "parent", None)
        if name in _STATICS:
            return _STATICS[name]
        raise PainlessError(f"variable [{name}] is not defined")

    def binop(self, op, ae, be, scope):
        if op == "&&":
            return _truthy(self.eval(ae, scope)) \
                and _truthy(self.eval(be, scope))
        if op == "||":
            return _truthy(self.eval(ae, scope)) \
                or _truthy(self.eval(be, scope))
        a = self.eval(ae, scope)
        b = self.eval(be, scope)
        if op == "+":
            if isinstance(a, str) or isinstance(b, str):
                return _java_str(a) + _java_str(b) \
                    if not (isinstance(a, str) and isinstance(b, str)) \
                    else a + b
            if isinstance(a, list) and isinstance(b, list):
                return a + b
            return _num(a) + _num(b)
        if op == "-":
            return _num(a) - _num(b)
        if op == "*":
            return _num(a) * _num(b)
        if op == "/":
            return _java_div(_num(a), _num(b))
        if op == "%":
            return _java_mod(_num(a), _num(b))
        if op in ("==", "==="):
            return a is b if op == "===" else a == b
        if op in ("!=", "!=="):
            return a is not b if op == "!==" else a != b
        if op in ("<", "<=", ">", ">="):
            try:
                if op == "<":
                    return a < b
                if op == "<=":
                    return a <= b
                if op == ">":
                    return a > b
                return a >= b
            except TypeError:
                raise PainlessError(
                    f"cannot compare [{_java_str(a)}] with "
                    f"[{_java_str(b)}]")
        if op in ("&", "|", "^"):
            if isinstance(a, bool) and isinstance(b, bool):
                return {"&": a and b, "|": a or b, "^": a != b}[op]
            if isinstance(a, int) and isinstance(b, int):
                return {"&": a & b, "|": a | b, "^": a ^ b}[op]
            raise PainlessError(f"bad operands for {op}")
        if op in ("<<", ">>", ">>>"):
            if not isinstance(a, int) or not isinstance(b, int) \
                    or isinstance(a, bool) or isinstance(b, bool):
                raise PainlessError(f"shift requires integers")
            if op == "<<":
                return a << (b & 63)
            if op == ">>":
                return a >> (b & 63)
            return (a & 0xFFFFFFFFFFFFFFFF) >> (b & 63)
        raise PainlessError(f"unknown operator [{op}]")

    # --------------------------------------------------------- l-values
    def read_target(self, t, scope):
        if t[0] == "name":
            return self.lookup(t[1], scope)
        if t[0] == "field":
            return self.eval(t, scope)
        if t[0] == "index":
            return self.eval(t, scope)
        raise PainlessError("invalid assignment target")

    def write_target(self, t, value, scope):
        if t[0] == "name":
            s = scope
            while s is not None:
                if t[1] in s:
                    s[t[1]] = value
                    return
                s = getattr(s, "parent", None)
            scope[t[1]] = value
            return
        if t[0] == "field":
            obj = self.eval(t[1], scope)
            self.set_field(obj, t[2], value)
            return
        if t[0] == "index":
            obj = self.eval(t[1], scope)
            key = self.eval(t[2], scope)
            self.set_index(obj, key, value)
            return
        raise PainlessError("invalid assignment target")

    def assign(self, op, target, value_expr, scope):
        value = self.eval(value_expr, scope)
        if op != "=":
            cur = self.read_target(target, scope)
            binop = op[0]
            value = self.binop(
                binop, ("num", 0), ("num", 0), scope) \
                if False else self._apply_compound(binop, cur, value)
        self.write_target(target, value, scope)
        return value

    def _apply_compound(self, op, a, b):
        if op == "+":
            if isinstance(a, str) or isinstance(b, str):
                return _java_str(a) + _java_str(b) \
                    if not (isinstance(a, str) and isinstance(b, str)) \
                    else a + b
            return _num(a) + _num(b)
        if op == "-":
            return _num(a) - _num(b)
        if op == "*":
            return _num(a) * _num(b)
        if op == "/":
            return _java_div(_num(a), _num(b))
        if op == "%":
            return _java_mod(_num(a), _num(b))
        if op in ("&", "|", "^"):
            if isinstance(a, bool) and isinstance(b, bool):
                return {"&": a and b, "|": a or b, "^": a != b}[op]
            return {"&": a & b, "|": a | b, "^": a ^ b}[op]
        raise PainlessError(f"unknown compound operator [{op}=]")

    # ------------------------------------------------- member resolution
    def get_field(self, obj, name):
        if isinstance(obj, ContextShim):
            return obj.pl_get(name)
        if isinstance(obj, dict):
            return obj.get(name)
        if isinstance(obj, _StaticClass):
            if name in obj.consts:
                return obj.consts[name]
            raise PainlessError(
                f"unknown static field [{obj.name}.{name}]")
        if isinstance(obj, str) and name == "length":
            return len(obj)
        if isinstance(obj, list) and name == "length":
            return len(obj)
        raise PainlessError(
            f"unknown field [{name}] on [{type(obj).__name__}]")

    def set_field(self, obj, name, value):
        if isinstance(obj, ContextShim):
            obj.pl_set(name, value)
            return
        if isinstance(obj, dict):
            obj[name] = value
            return
        raise PainlessError(f"cannot write field [{name}]")

    def get_index(self, obj, key):
        if isinstance(obj, ContextShim):
            return obj.pl_index(key)
        if isinstance(obj, list):
            return _list_get(obj, key)
        if isinstance(obj, dict):
            return obj.get(key)
        if isinstance(obj, str):
            return obj[key]
        raise PainlessError(
            f"cannot index [{type(obj).__name__}]")

    def set_index(self, obj, key, value):
        if isinstance(obj, ContextShim):
            obj.pl_index_set(key, value)
            return
        if isinstance(obj, list):
            _list_get(obj, key)
            obj[key] = value
            return
        if isinstance(obj, dict):
            obj[key] = value
            return
        raise PainlessError(f"cannot index-assign "
                            f"[{type(obj).__name__}]")

    def call(self, e, scope):
        _, obj_expr, name, arg_exprs, nullsafe = e
        args = [self.eval(a, scope) for a in arg_exprs]
        if obj_expr is None:
            # bare call: user function, then context function
            fn = self.funcs.get(name)
            if fn is not None:
                return self.call_user_function(fn, args)
            ctx_fn = self.lookup_fn(name, scope)
            if ctx_fn is not None:
                return ctx_fn(*args)
            raise PainlessError(f"unknown function [{name}]")
        obj = self.eval(obj_expr, scope)
        if obj is None:
            if nullsafe:
                return None
            raise PainlessError(
                f"null pointer: cannot call [{name}] on null")
        return self.call_method(obj, name, args)

    def lookup_fn(self, name, scope):
        try:
            v = self.lookup(name, scope)
        except PainlessError:
            return None
        return v if callable(v) else None

    def call_user_function(self, fn: tuple, args):
        _, _name, params, body = fn
        if len(args) != len(params):
            raise PainlessError(
                f"function [{_name}] expects {len(params)} arguments")
        child = _ChildScope(self.globals)
        for p, a in zip(params, args):
            child[p] = a
        try:
            self.exec_stmt(body, child)
        except _Return as r:
            return r.value
        return None

    def call_method(self, obj, name, args):
        if isinstance(obj, ContextShim):
            return obj.pl_call(name, args)
        if isinstance(obj, _StaticClass):
            fn = obj.methods.get(name)
            if fn is None:
                raise PainlessError(
                    f"unknown static method [{obj.name}.{name}]")
            return fn(*args)
        table = None
        if isinstance(obj, str):
            table = _STR_METHODS
        elif isinstance(obj, bool):
            table = _BOOL_METHODS
        elif isinstance(obj, (int, float)):
            table = _NUM_METHODS
        elif isinstance(obj, list):
            table = _LIST_METHODS
        elif isinstance(obj, dict):
            table = _MAP_METHODS
        elif isinstance(obj, _MapEntry):
            table = _ENTRY_METHODS
        elif isinstance(obj, _StringBuilder):
            table = _SB_METHODS
        elif isinstance(obj, _CaughtException):
            table = _EXC_METHODS
        if table is None or name not in table:
            raise PainlessError(
                f"unknown method [{name}] on "
                f"[{type(obj).__name__}]")
        try:
            return table[name](obj, *args)
        except PainlessError:
            raise
        except (_Break, _Continue, _Return):
            raise
        except Exception as exc:
            raise PainlessError(f"runtime error in [{name}]: {exc}")

    def cast(self, typ, v):
        base = typ.rstrip("[]")
        if base in ("int", "long", "short", "byte", "char"):
            if isinstance(v, str) and base == "char" and len(v) == 1:
                return v
            return int(_num(v, f"({typ}) cast"))
        if base in ("float", "double"):
            return float(_num(v, f"({typ}) cast"))
        if base == "boolean":
            return _truthy(v)
        if base == "String":
            return v if v is None else _java_str(v)
        return v    # reference casts are dynamic no-ops

    def isinstance_of(self, v, typ) -> bool:
        base = typ.rstrip("[]")
        if base in ("int", "long", "short", "byte", "Integer", "Long"):
            return isinstance(v, int) and not isinstance(v, bool)
        if base in ("float", "double", "Float", "Double"):
            return isinstance(v, float)
        if base in ("boolean", "Boolean"):
            return isinstance(v, bool)
        if base in ("String", "CharSequence"):
            return isinstance(v, str)
        if base in ("List", "ArrayList", "Collection"):
            return isinstance(v, list)
        if base in ("Map", "HashMap"):
            return isinstance(v, dict)
        if base in ("Object", "def"):
            return v is not None
        if base == "Number":
            return isinstance(v, (int, float)) \
                and not isinstance(v, bool)
        return False


class _CaughtException(ContextShim):
    def __init__(self, message):
        self._message = message

    def pl_call(self, name, args):
        if name == "getMessage" or name == "toString":
            return self._message
        raise PainlessError(f"unknown method [{name}] on exception")


_EXC_METHODS = {
    "getMessage": lambda e: e._message,
    "toString": lambda e: e._message,
}


class _ChildScope(dict):
    """Lexical child scope: reads fall through to the parent; writes to
    names DEFINED in a parent update the parent (Painless scoping)."""

    def __init__(self, parent):
        super().__init__()
        self.parent = parent


# ------------------------------------------------------------- entry point

# names a script may reference without declaring: the union of every
# context's bindings (ref: each Painless context whitelist declares its
# variables; undefined names are COMPILE errors, which also keeps
# legacy python-style scripts flowing to their fallback engines)
DEFAULT_GLOBALS = frozenset({
    "ctx", "params", "doc", "_score", "_value", "state", "states",
    "emit",
})


def _collect_declared(node, out):
    """All names a program declares (locals, loop vars, catch vars,
    function names/params, lambda params)."""
    if not isinstance(node, tuple):
        if isinstance(node, list):
            for x in node:
                _collect_declared(x, out)
        return
    tag = node[0]
    if tag == "decl":
        for name, init in node[2]:
            out.add(name)
            _collect_declared(init, out)
        return
    if tag == "foreach":
        out.add(node[1])
        _collect_declared(node[2], out)
        _collect_declared(node[3], out)
        return
    if tag == "trycatch":
        out.add(node[2])
        _collect_declared(node[1], out)
        _collect_declared(node[3], out)
        return
    if tag == "func":
        out.add(node[1])
        out.update(node[2])
        _collect_declared(node[3], out)
        return
    if tag == "lambda":
        out.update(node[1])
        _collect_declared(node[2], out)
        return
    for child in node[1:]:
        _collect_declared(child, out)


def _collect_names(node, out, calls):
    if not isinstance(node, tuple):
        if isinstance(node, list):
            for x in node:
                _collect_names(x, out, calls)
        return
    if node[0] == "name":
        out.add(node[1])
    if node[0] == "call" and node[1] is None:
        calls.add(node[2])
    if node[0] in ("field", "call") and isinstance(node[2], str) \
            and node[2].startswith("__"):
        # no legitimate Painless member is dunder-named; reject at
        # compile (the python-internals escape shape)
        raise PainlessError(
            f"compile error: access to [{node[2]}] is not allowed")
    for child in node[1:]:
        _collect_names(child, out, calls)


# bare functions the contexts may bind (score-context vector/feature
# functions — search/script.py vector_fns — plus runtime-field emit)
DEFAULT_FUNCTIONS = frozenset({
    "saturation", "sigmoid", "cosineSimilarity", "dotProduct", "l2norm",
    "emit",
})


class PainlessScript:
    """A compiled script: parsed once, executable against per-call
    environments (the ScriptService compilation-cache unit)."""

    def __init__(self, source: str):
        self.source = source
        funcs, stmts = parse_program(source)
        self.functions = {f[1]: f for f in funcs}
        self.statements = stmts
        # semantic pass: undefined variables are compile errors (ref:
        # Painless's semantic phase — and the dual-engine contract: a
        # python-style script like `x == True` must FAIL Painless
        # compilation so its legacy engine still serves it)
        declared = set()
        used = set()
        called = set()
        for f in funcs:
            _collect_declared(f, declared)
        for st in stmts:
            _collect_declared(st, declared)
            _collect_names(st, used, called)
        for f in funcs:
            _collect_names(f, used, called)
        unknown = (used - declared - DEFAULT_GLOBALS
                   - set(_STATICS) - set(self.functions))
        if unknown:
            raise PainlessError(
                f"compile error: unknown variable "
                f"[{sorted(unknown)[0]}] in [{source}]")
        bad_calls = (called - set(self.functions) - declared
                     - DEFAULT_FUNCTIONS)
        if bad_calls:
            raise PainlessError(
                f"compile error: unknown function "
                f"[{sorted(bad_calls)[0]}] in [{source}]")

    def execute(self, env: Dict[str, Any],
                max_ops: int = MAX_OPS) -> Any:
        """Run with `env` as the global scope; returns the `return`
        value, or the last expression-statement's value (Painless
        returns the last expression for expression-style scripts)."""
        interp = Interp(self.functions, dict(env), max_ops=max_ops)
        scope = _ChildScope(interp.globals)
        last = None
        try:
            for i, st in enumerate(self.statements):
                if st[0] == "expr" and i == len(self.statements) - 1:
                    last = interp.eval(st[1], scope)
                else:
                    interp.exec_stmt(st, scope)
        except _Return as r:
            return r.value
        except (_Break, _Continue):
            raise PainlessError(
                "break/continue outside of a loop")
        return last


_compile_cache: Dict[str, PainlessScript] = {}


def compile_painless(source: str) -> PainlessScript:
    script = _compile_cache.get(source)
    if script is None:
        script = PainlessScript(source)
        if len(_compile_cache) < 2048:
            _compile_cache[source] = script
    return script
