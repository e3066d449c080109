"""Painless lexer + parser (ref: modules/lang-painless/.../Compiler.java:55,
grammar in PainlessLexer.g4 / PainlessParser.g4).

The reference compiles an ANTLR parse tree to JVM bytecode; here a compact
recursive-descent parser builds a tuple-tagged AST that interp.py walks.
The surface covered is the working core of the language: statements,
typed / `def` locals, all control flow, functions, lambdas, list/map
literals, `new` construction, null-safe access, elvis, casts, instanceof,
compound assignment and pre/post increment.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from elasticsearch_tpu_torch.common.errors import ScriptException


class ParseError(ScriptException):
    pass


# --------------------------------------------------------------------- lexer

_PUNCT3 = (">>>", "===", "!==", "<<=", ">>=")
_PUNCT2 = ("==", "!=", "<=", ">=", "&&", "||", "+=", "-=", "*=", "/=",
           "%=", "++", "--", "?.", "?:", "->", "<<", ">>", "|=", "&=",
           "^=", "::")
_PUNCT1 = "+-*/%=<>!&|^~?:;,.(){}[]"

KEYWORDS = {
    "if", "else", "while", "do", "for", "in", "continue", "break",
    "return", "new", "try", "catch", "throw", "this", "instanceof",
    "null", "true", "false", "def",
}

# type-ish identifiers that start declarations (any other `ID ID` pair is
# also treated as a declaration, Painless-style)
PRIMITIVE_TYPES = {
    "def", "int", "long", "short", "byte", "char", "float", "double",
    "boolean", "void",
}


class Tok:
    __slots__ = ("kind", "val", "pos")

    def __init__(self, kind: str, val: Any, pos: int):
        self.kind = kind      # num str id punct eof
        self.val = val
        self.pos = pos

    def __repr__(self):
        return f"Tok({self.kind},{self.val!r})"


def lex(src: str) -> List[Tok]:
    toks: List[Tok] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "/" and i + 1 < n and src[i + 1] == "/":
            j = src.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and src[i + 1] == "*":
            j = src.find("*/", i + 2)
            if j < 0:
                raise ParseError("unterminated comment")
            i = j + 2
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            is_float = False
            while j < n and (src[j].isdigit() or src[j] in ".eE"
                             or (src[j] in "+-" and j > i
                                 and src[j - 1] in "eE")):
                if src[j] in ".eE":
                    is_float = True
                j += 1
            text = src[i:j]
            if j < n and src[j] in "lLfFdD":
                if src[j] in "fFdD":
                    is_float = True
                j += 1
            try:
                val = float(text) if is_float else int(text, 0)
            except ValueError:
                raise ParseError(f"bad number literal [{text}]")
            toks.append(Tok("num", val, i))
            i = j
            continue
        if c in "'\"":
            j = i + 1
            out = []
            while j < n and src[j] != c:
                if src[j] == "\\" and j + 1 < n:
                    esc = src[j + 1]
                    out.append({"n": "\n", "t": "\t", "r": "\r",
                                "\\": "\\", "'": "'", '"': '"',
                                "0": "\0"}.get(esc, esc))
                    j += 2
                else:
                    out.append(src[j])
                    j += 1
            if j >= n:
                raise ParseError("unterminated string literal")
            toks.append(Tok("str", "".join(out), i))
            i = j + 1
            continue
        if c.isalpha() or c == "_" or c == "$":
            j = i
            while j < n and (src[j].isalnum() or src[j] in "_$"):
                j += 1
            toks.append(Tok("id", src[i:j], i))
            i = j
            continue
        three = src[i:i + 3]
        if three in _PUNCT3:
            toks.append(Tok("punct", three, i))
            i += 3
            continue
        two = src[i:i + 2]
        if two in _PUNCT2:
            toks.append(Tok("punct", two, i))
            i += 2
            continue
        if c in _PUNCT1:
            toks.append(Tok("punct", c, i))
            i += 1
            continue
        raise ParseError(f"unexpected character [{c}]")
    toks.append(Tok("eof", None, n))
    return toks


# -------------------------------------------------------------------- parser
#
# AST nodes are tuples tagged with a string head:
#   ("block", [stmts])            ("decl", type, [(name, init|None)])
#   ("if", cond, then, els)       ("while", cond, body)
#   ("dowhile", body, cond)       ("for", init, cond, update, body)
#   ("foreach", name, iter, body) ("break",) ("continue",)
#   ("return", expr|None)         ("expr", expr)
#   ("throw", expr)               ("trycatch", body, var, handler)
#   ("func", name, [params], body)
# expressions:
#   ("num", v) ("str", v) ("bool", v) ("null",)
#   ("name", id) ("list", [..]) ("map", [(k, v)])
#   ("assign", op, target, value)       op in = += -= *= /= %=
#   ("ternary", c, a, b) ("elvis", a, b)
#   ("binop", op, a, b) ("unary", op, a)
#   ("preinc", op, target) ("postinc", op, target)
#   ("field", obj, name, nullsafe) ("index", obj, key)
#   ("call", obj|None, name, [args], nullsafe)   obj None = bare call
#   ("new", type, [args]) ("cast", type, expr)
#   ("instanceof", expr, type) ("lambda", [params], body_expr_or_block)


class Parser:
    def __init__(self, toks: List[Tok], src: str):
        self.toks = toks
        self.i = 0
        self.src = src

    # ---------------------------------------------------------- helpers
    def peek(self, ahead=0) -> Tok:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at(self, kind: str, val=None, ahead=0) -> bool:
        t = self.peek(ahead)
        return t.kind == kind and (val is None or t.val == val)

    def expect(self, kind: str, val=None) -> Tok:
        t = self.next()
        if t.kind != kind or (val is not None and t.val != val):
            got = t.val if t.val is not None else t.kind
            raise ParseError(
                f"expected [{val or kind}] but found [{got}]")
        return t

    def eat(self, kind: str, val=None) -> bool:
        if self.at(kind, val):
            self.i += 1
            return True
        return False

    # ------------------------------------------------------------ types
    def at_type_start(self) -> bool:
        t = self.peek()
        if t.kind != "id" or t.val in KEYWORDS - {"def"}:
            return t.kind == "id" and t.val == "def"
        if t.val in PRIMITIVE_TYPES:
            return True
        # `ID ID` / `ID <` / `ID [` `]` — a declaration, Java-style
        nxt = self.peek(1)
        if nxt.kind == "id" and nxt.val not in KEYWORDS:
            return True
        if nxt.kind == "punct" and nxt.val == "<":
            return self._generic_decl_lookahead()
        if (nxt.kind == "punct" and nxt.val == "["
                and self.at("punct", "]", 2)):
            return True
        return False

    def _generic_decl_lookahead(self) -> bool:
        # ID '<' ... '>' ID  → declaration with generics
        j = self.i + 2
        depth = 1
        while j < len(self.toks) and depth:
            t = self.toks[j]
            if t.kind == "punct" and t.val == "<":
                depth += 1
            elif t.kind == "punct" and t.val == ">":
                depth -= 1
            elif t.kind == "punct" and t.val == ">>":
                depth -= 2
            elif t.kind in ("eof", ) or (t.kind == "punct"
                                         and t.val in ";{}"):
                return False
            j += 1
        return (j < len(self.toks) and self.toks[j].kind == "id")

    def parse_type(self) -> str:
        name = self.expect("id").val
        while self.eat("punct", "."):
            name += "." + self.expect("id").val
        if self.eat("punct", "<"):        # skip generic args
            depth = 1
            while depth:
                t = self.next()
                if t.kind == "eof":
                    raise ParseError("unterminated generic type")
                if t.kind == "punct" and t.val == "<":
                    depth += 1
                elif t.kind == "punct" and t.val == ">":
                    depth -= 1
                elif t.kind == "punct" and t.val == ">>":
                    depth -= 2
        while self.at("punct", "[") and self.at("punct", "]", 1):
            self.next()
            self.next()
            name += "[]"
        return name

    # ------------------------------------------------------- statements
    def parse_program(self) -> Tuple[list, list]:
        """Returns (functions, statements)."""
        funcs = []
        stmts = []
        while not self.at("eof"):
            f = self.try_parse_function()
            if f is not None:
                funcs.append(f)
            else:
                break
        while not self.at("eof"):
            stmts.append(self.parse_statement())
        return funcs, stmts

    def try_parse_function(self) -> Optional[tuple]:
        # TYPE ID '(' ... ')' '{'  (functions precede statements,
        # PainlessParser.g4 `source: function* statement*`)
        save = self.i
        try:
            if not self.at_type_start():
                return None
            self.parse_type()
            if not self.at("id"):
                self.i = save
                return None
            name = self.next().val
            if not self.at("punct", "("):
                self.i = save
                return None
            self.next()
            params = []
            while not self.at("punct", ")"):
                self.parse_type()
                params.append(self.expect("id").val)
                if not self.at("punct", ")"):
                    self.expect("punct", ",")
            self.next()
            if not self.at("punct", "{"):
                self.i = save
                return None
            body = self.parse_block()
            return ("func", name, params, body)
        except ParseError:
            self.i = save
            return None

    def parse_block(self) -> tuple:
        self.expect("punct", "{")
        stmts = []
        while not self.eat("punct", "}"):
            if self.at("eof"):
                raise ParseError("unexpected end of script; missing '}'")
            stmts.append(self.parse_statement())
        return ("block", stmts)

    def parse_statement(self) -> tuple:
        t = self.peek()
        if t.kind == "punct" and t.val == "{":
            return self.parse_block()
        if t.kind == "id":
            kw = t.val
            if kw == "if":
                self.next()
                self.expect("punct", "(")
                cond = self.parse_expression()
                self.expect("punct", ")")
                then = self.parse_statement()
                els = None
                if self.eat("id", "else"):
                    els = self.parse_statement()
                return ("if", cond, then, els)
            if kw == "while":
                self.next()
                self.expect("punct", "(")
                cond = self.parse_expression()
                self.expect("punct", ")")
                if self.eat("punct", ";"):
                    return ("while", cond, ("block", []))
                return ("while", cond, self.parse_statement())
            if kw == "do":
                self.next()
                body = self.parse_statement()
                self.expect("id", "while")
                self.expect("punct", "(")
                cond = self.parse_expression()
                self.expect("punct", ")")
                self.eat("punct", ";")
                return ("dowhile", body, cond)
            if kw == "for":
                return self.parse_for()
            if kw == "break":
                self.next()
                self.eat("punct", ";")
                return ("break",)
            if kw == "continue":
                self.next()
                self.eat("punct", ";")
                return ("continue",)
            if kw == "return":
                self.next()
                if self.eat("punct", ";"):
                    return ("return", None)
                e = self.parse_expression()
                self.eat("punct", ";")
                return ("return", e)
            if kw == "throw":
                self.next()
                e = self.parse_expression()
                self.eat("punct", ";")
                return ("throw", e)
            if kw == "try":
                self.next()
                body = self.parse_block()
                self.expect("id", "catch")
                self.expect("punct", "(")
                self.parse_type()
                var = self.expect("id").val
                self.expect("punct", ")")
                handler = self.parse_block()
                return ("trycatch", body, var, handler)
        if self.at_type_start():
            return self.parse_declaration()
        e = self.parse_expression()
        self.eat("punct", ";")
        return ("expr", e)

    def parse_for(self) -> tuple:
        self.expect("id", "for")
        self.expect("punct", "(")
        # for-each: for (TYPE ID : expr) / for (ID in expr)
        save = self.i
        if self.at_type_start():
            try:
                self.parse_type()
                name = self.expect("id").val
                if self.eat("punct", ":") or self.eat("id", "in"):
                    it = self.parse_expression()
                    self.expect("punct", ")")
                    return ("foreach", name, it, self.parse_statement())
            except ParseError:
                pass
            self.i = save
        init = None
        if not self.at("punct", ";"):
            if self.at_type_start():
                init = self.parse_declaration(consume_semi=False)
            else:
                init = ("expr", self.parse_expression())
        self.expect("punct", ";")
        cond = None
        if not self.at("punct", ";"):
            cond = self.parse_expression()
        self.expect("punct", ";")
        update = None
        if not self.at("punct", ")"):
            update = ("expr", self.parse_expression())
        self.expect("punct", ")")
        if self.eat("punct", ";"):
            body = ("block", [])
        else:
            body = self.parse_statement()
        return ("for", init, cond, update, body)

    def parse_declaration(self, consume_semi=True) -> tuple:
        typ = self.parse_type()
        decls = []
        while True:
            name = self.expect("id").val
            init = None
            if self.eat("punct", "="):
                init = self.parse_assignment()
            decls.append((name, init))
            if not self.eat("punct", ","):
                break
        if consume_semi:
            self.eat("punct", ";")
        return ("decl", typ, decls)

    # ------------------------------------------------------ expressions
    def parse_expression(self) -> tuple:
        return self.parse_assignment()

    def parse_assignment(self) -> tuple:
        left = self.parse_ternary()
        t = self.peek()
        if t.kind == "punct" and t.val in ("=", "+=", "-=", "*=", "/=",
                                           "%=", "|=", "&=", "^="):
            self.next()
            if left[0] not in ("name", "field", "index"):
                raise ParseError("invalid assignment target")
            value = self.parse_assignment()
            return ("assign", t.val, left, value)
        return left

    def parse_ternary(self) -> tuple:
        cond = self.parse_elvis()
        if self.eat("punct", "?"):
            a = self.parse_assignment()
            self.expect("punct", ":")
            b = self.parse_assignment()
            return ("ternary", cond, a, b)
        return cond

    def parse_elvis(self) -> tuple:
        a = self.parse_or()
        if self.eat("punct", "?:"):
            b = self.parse_elvis()
            return ("elvis", a, b)
        return a

    def _binop_level(self, ops, sub):
        e = sub()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.val in ops:
                self.next()
                e = ("binop", t.val, e, sub())
            else:
                return e

    def parse_or(self):
        return self._binop_level(("||",), self.parse_and)

    def parse_and(self):
        return self._binop_level(("&&",), self.parse_bitor)

    def parse_bitor(self):
        return self._binop_level(("|",), self.parse_bitxor)

    def parse_bitxor(self):
        return self._binop_level(("^",), self.parse_bitand)

    def parse_bitand(self):
        return self._binop_level(("&",), self.parse_equality)

    def parse_equality(self):
        return self._binop_level(("==", "!=", "===", "!=="),
                                 self.parse_relational)

    def parse_relational(self):
        e = self.parse_shift()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.val in ("<", "<=", ">", ">="):
                self.next()
                e = ("binop", t.val, e, self.parse_shift())
            elif t.kind == "id" and t.val == "instanceof":
                self.next()
                e = ("instanceof", e, self.parse_type())
            else:
                return e

    def parse_shift(self):
        return self._binop_level(("<<", ">>", ">>>"), self.parse_additive)

    def parse_additive(self):
        return self._binop_level(("+", "-"), self.parse_multiplicative)

    def parse_multiplicative(self):
        return self._binop_level(("*", "/", "%"), self.parse_unary)

    def parse_unary(self) -> tuple:
        t = self.peek()
        if t.kind == "punct" and t.val in ("!", "-", "+", "~"):
            self.next()
            return ("unary", t.val, self.parse_unary())
        if t.kind == "punct" and t.val in ("++", "--"):
            self.next()
            target = self.parse_unary()
            return ("preinc", t.val, target)
        # cast: '(' TYPE ')' unary — lookahead for ( ID ) not-an-operator
        if t.kind == "punct" and t.val == "(":
            save = self.i
            self.next()
            if self.at("id") and self.peek().val not in KEYWORDS:
                try:
                    typ = self.parse_type()
                    if self.at("punct", ")"):
                        nxt = self.peek(1)
                        castable = (
                            nxt.kind in ("num", "str", "id")
                            or (nxt.kind == "punct"
                                and nxt.val in ("(", "[", "!", "~")))
                        if castable and nxt.kind == "id" \
                                and nxt.val in KEYWORDS - {
                                    "null", "true", "false", "new", "this"}:
                            castable = False
                        if castable:
                            self.next()
                            return ("cast", typ, self.parse_unary())
                except ParseError:
                    pass
            self.i = save
        return self.parse_postfix()

    def parse_postfix(self) -> tuple:
        e = self.parse_primary()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.val in (".", "?."):
                nullsafe = t.val == "?."
                self.next()
                name = self.expect("id").val
                if self.eat("punct", "("):
                    args = self.parse_args()
                    e = ("call", e, name, args, nullsafe)
                else:
                    e = ("field", e, name, nullsafe)
            elif t.kind == "punct" and t.val == "[":
                self.next()
                key = self.parse_expression()
                self.expect("punct", "]")
                e = ("index", e, key)
            elif t.kind == "punct" and t.val in ("++", "--"):
                self.next()
                e = ("postinc", t.val, e)
            else:
                return e

    def parse_args(self) -> list:
        args = []
        while not self.at("punct", ")"):
            args.append(self.parse_expression())
            if not self.at("punct", ")"):
                self.expect("punct", ",")
        self.next()
        return args

    def parse_primary(self) -> tuple:
        t = self.peek()
        if t.kind == "num":
            self.next()
            return ("num", t.val)
        if t.kind == "str":
            self.next()
            return ("str", t.val)
        if t.kind == "id":
            if t.val == "true":
                self.next()
                return ("bool", True)
            if t.val == "false":
                self.next()
                return ("bool", False)
            if t.val == "null":
                self.next()
                return ("null",)
            if t.val == "new":
                self.next()
                typ = self.parse_type()
                if self.eat("punct", "("):
                    return ("new", typ, self.parse_args())
                if self.eat("punct", "["):   # new int[n]
                    size = self.parse_expression()
                    self.expect("punct", "]")
                    return ("new", typ + "[]", [size])
                raise ParseError(f"expected ( after new {typ}")
            # lambda: ID '->' ...
            if self.peek(1).kind == "punct" and self.peek(1).val == "->":
                name = self.next().val
                self.next()
                return ("lambda", [name], self._lambda_body())
            self.next()
            if self.eat("punct", "("):
                return ("call", None, t.val, self.parse_args(), False)
            return ("name", t.val)
        if t.kind == "punct" and t.val == "(":
            # lambda: (a, b) -> ...
            save = self.i
            try:
                self.next()
                params = []
                if not self.at("punct", ")"):
                    while True:
                        if self.at_type_start() \
                                and self.peek(1).kind == "id":
                            self.parse_type()
                        params.append(self.expect("id").val)
                        if not self.eat("punct", ","):
                            break
                self.expect("punct", ")")
                if self.at("punct", "->"):
                    self.next()
                    return ("lambda", params, self._lambda_body())
                raise ParseError("not a lambda")
            except ParseError:
                self.i = save
            self.next()
            e = self.parse_expression()
            self.expect("punct", ")")
            return e
        if t.kind == "punct" and t.val == "[":
            self.next()
            # map literal [:] / ['k': v, ...] vs list literal [a, b]
            if self.eat("punct", ":"):
                self.expect("punct", "]")
                return ("map", [])
            if self.at("punct", "]"):
                self.next()
                return ("list", [])
            first = self.parse_expression()
            if self.eat("punct", ":"):
                pairs = [(first, self.parse_expression())]
                while self.eat("punct", ","):
                    k = self.parse_expression()
                    self.expect("punct", ":")
                    pairs.append((k, self.parse_expression()))
                self.expect("punct", "]")
                return ("map", pairs)
            items = [first]
            while self.eat("punct", ","):
                items.append(self.parse_expression())
            self.expect("punct", "]")
            return ("list", items)
        raise ParseError(f"unexpected token [{t.val}]")

    def _lambda_body(self):
        if self.at("punct", "{"):
            return self.parse_block()
        return self.parse_assignment()


def parse_program(source: str) -> Tuple[list, list]:
    """(functions, statements) for a Painless source string."""
    p = Parser(lex(source), source)
    try:
        return p.parse_program()
    except ParseError:
        raise
    except ScriptException:
        raise
    except Exception as e:  # defensive: parser bugs surface as compile errors
        raise ParseError(f"compile error: {e}")
