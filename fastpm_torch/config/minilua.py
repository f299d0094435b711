"""A small tree-walking Lua interpreter for parameter files.

The reference's configuration files are Lua programs (README.rst
"Commandline Interface"; src/lua-main.c embeds Lua 5.3). This module
implements the Lua subset those files use so existing .lua parameter
files run unchanged: assignments, tables, arithmetic/comparison/logic,
string concat, if/elseif/else, numeric and generic for, while, functions
(including dotted names and closures), local variables, and the usual
small stdlib surface (pairs/ipairs/error/print/tostring/tonumber,
math.*, string.format, table.insert, #).

Lua semantics honored: 1-based tables, nil removes keys, integer/float
distinction is cosmetic (all numbers are Python floats unless integral),
`..` concatenation formats numbers like Lua's %.14g.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["run", "LuaError", "LuaTable", "lua_to_py"]


class LuaError(Exception):
    pass


# ------------------------------------------------------------------
# Lexer
# ------------------------------------------------------------------

KEYWORDS = {
    "and", "break", "do", "else", "elseif", "end", "false", "for",
    "function", "if", "in", "local", "nil", "not", "or", "repeat",
    "return", "then", "true", "until", "while",
}

TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<longcomment>--\[(?P<lceq>=*)\[.*?\](?P=lceq)\])
  | (?P<comment>--[^\n]*)
  | (?P<longstr>\[(?P<lseq>=*)\[(?P<lsbody>.*?)\](?P=lseq)\])
  | (?P<number>0[xX][0-9a-fA-F]+|\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_]\w*)
  | (?P<dstr>"(?:\\.|[^"\\])*")
  | (?P<sstr>'(?:\\.|[^'\\])*')
  | (?P<op>\.\.\.|\.\.|==|~=|<=|>=|//|<<|>>|::|[-+*/%^#<>=(){}\[\];:,.])
""", re.VERBOSE | re.DOTALL)

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "a": "\a", "b": "\b",
            "f": "\f", "v": "\v", "\\": "\\", '"': '"', "'": "'",
            "\n": "\n"}


def _unescape(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        ch = s[i]
        if ch == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt in _ESCAPES:
                out.append(_ESCAPES[nxt])
                i += 2
                continue
            if nxt.isdigit():
                j = i + 1
                while j < len(s) and j < i + 4 and s[j].isdigit():
                    j += 1
                out.append(chr(int(s[i + 1:j])))
                i = j
                continue
        out.append(ch)
        i += 1
    return "".join(out)


def tokenize(src: str) -> List[Tuple[str, Any, int]]:
    tokens = []
    pos = 0
    line = 1
    n = len(src)
    while pos < n:
        m = TOKEN_RE.match(src, pos)
        if not m:
            raise LuaError(f"lex error at line {line}: {src[pos:pos+20]!r}")
        text = m.group(0)
        line += text.count("\n")
        pos = m.end()
        if m.lastgroup in ("ws", "comment", "longcomment"):
            continue
        kind = m.lastgroup
        if kind == "number":
            if text.lower().startswith("0x"):
                tokens.append(("number", float(int(text, 16)), line))
            else:
                tokens.append(("number", float(text), line))
        elif kind == "name":
            if text in KEYWORDS:
                tokens.append((text, text, line))
            else:
                tokens.append(("name", text, line))
        elif kind in ("dstr", "sstr"):
            tokens.append(("string", _unescape(text[1:-1]), line))
        elif kind == "longstr":
            body = m.group("lsbody")
            if body.startswith("\n"):
                body = body[1:]
            tokens.append(("string", body, line))
        else:
            tokens.append((text, text, line))
    tokens.append(("<eof>", None, line))
    return tokens


# ------------------------------------------------------------------
# Parser -> AST (tuples)
# ------------------------------------------------------------------

class Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i][0]

    def peek_val(self):
        return self.toks[self.i][1]

    def line(self):
        return self.toks[self.i][2]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind):
        t = self.next()
        if t[0] != kind:
            raise LuaError(f"line {t[2]}: expected {kind!r}, got {t[0]!r}")
        return t

    def accept(self, kind):
        if self.peek() == kind:
            return self.next()
        return None

    # ---- statements ----

    def parse_chunk(self, terminators=("<eof>",)):
        stmts = []
        while self.peek() not in terminators:
            if self.accept(";"):
                continue
            stmts.append(self.parse_statement())
            if stmts and stmts[-1][0] in ("return", "break"):
                break
        return ("block", stmts)

    def parse_statement(self):
        t = self.peek()
        if t == "if":
            return self.parse_if()
        if t == "while":
            self.next()
            cond = self.parse_expr()
            self.expect("do")
            body = self.parse_chunk(("end",))
            self.expect("end")
            return ("while", cond, body)
        if t == "repeat":
            self.next()
            body = self.parse_chunk(("until",))
            self.expect("until")
            cond = self.parse_expr()
            return ("repeat", body, cond)
        if t == "for":
            return self.parse_for()
        if t == "function":
            self.next()
            # function Name{.Name}[:Name] (params) body end
            name = self.expect("name")[1]
            target = ("name", name)
            is_method = False
            while self.peek() in (".", ":"):
                sep = self.next()[0]
                key = self.expect("name")[1]
                target = ("index", target, ("const", key))
                if sep == ":":
                    is_method = True
                    break
            fn = self.parse_function_body(is_method)
            return ("assign", [target], [fn])
        if t == "local":
            self.next()
            if self.accept("function"):
                name = self.expect("name")[1]
                fn = self.parse_function_body(False)
                return ("localfunc", name, fn)
            names = [self.expect("name")[1]]
            while self.accept(","):
                names.append(self.expect("name")[1])
            exprs = []
            if self.accept("="):
                exprs = [self.parse_expr()]
                while self.accept(","):
                    exprs.append(self.parse_expr())
            return ("local", names, exprs)
        if t == "return":
            self.next()
            exprs = []
            if self.peek() not in ("end", "else", "elseif", "until", "<eof>", ";"):
                exprs = [self.parse_expr()]
                while self.accept(","):
                    exprs.append(self.parse_expr())
            return ("return", exprs)
        if t == "break":
            self.next()
            return ("break",)
        if t == "do":
            self.next()
            body = self.parse_chunk(("end",))
            self.expect("end")
            return ("do", body)
        # expression statement: function call or assignment
        expr = self.parse_suffixed()
        if self.peek() in ("=", ","):
            targets = [expr]
            while self.accept(","):
                targets.append(self.parse_suffixed())
            self.expect("=")
            exprs = [self.parse_expr()]
            while self.accept(","):
                exprs.append(self.parse_expr())
            for tgt in targets:
                if tgt[0] not in ("name", "index"):
                    raise LuaError("cannot assign to this expression")
            return ("assign", targets, exprs)
        if expr[0] not in ("call", "method"):
            raise LuaError(f"line {self.line()}: syntax error near {self.peek()!r}")
        return ("exprstat", expr)

    def parse_if(self):
        self.expect("if")
        clauses = []
        cond = self.parse_expr()
        self.expect("then")
        body = self.parse_chunk(("elseif", "else", "end"))
        clauses.append((cond, body))
        while self.peek() == "elseif":
            self.next()
            c = self.parse_expr()
            self.expect("then")
            b = self.parse_chunk(("elseif", "else", "end"))
            clauses.append((c, b))
        els = None
        if self.accept("else"):
            els = self.parse_chunk(("end",))
        self.expect("end")
        return ("if", clauses, els)

    def parse_for(self):
        self.expect("for")
        name1 = self.expect("name")[1]
        if self.accept("="):
            start = self.parse_expr()
            self.expect(",")
            stop = self.parse_expr()
            step = None
            if self.accept(","):
                step = self.parse_expr()
            self.expect("do")
            body = self.parse_chunk(("end",))
            self.expect("end")
            return ("fornum", name1, start, stop, step, body)
        names = [name1]
        while self.accept(","):
            names.append(self.expect("name")[1])
        self.expect("in")
        exprs = [self.parse_expr()]
        while self.accept(","):
            exprs.append(self.parse_expr())
        self.expect("do")
        body = self.parse_chunk(("end",))
        self.expect("end")
        return ("forin", names, exprs, body)

    def parse_function_body(self, is_method):
        self.expect("(")
        params = ["self"] if is_method else []
        varargs = False
        if self.peek() != ")":
            while True:
                if self.accept("..."):
                    varargs = True
                    break
                params.append(self.expect("name")[1])
                if not self.accept(","):
                    break
        self.expect(")")
        body = self.parse_chunk(("end",))
        self.expect("end")
        return ("function", params, varargs, body)

    # ---- expressions (precedence climbing) ----

    BINPREC = {
        "or": (1, 1), "and": (2, 2),
        "<": (3, 3), ">": (3, 3), "<=": (3, 3), ">=": (3, 3),
        "~=": (3, 3), "==": (3, 3),
        "..": (5, 4),  # right assoc
        "+": (6, 6), "-": (6, 6),
        "*": (7, 7), "/": (7, 7), "%": (7, 7), "//": (7, 7),
        "^": (10, 9),  # right assoc
    }
    UNARY_PREC = 8

    def parse_expr(self, limit=0):
        t = self.peek()
        if t in ("not", "-", "#"):
            op = self.next()[0]
            operand = self.parse_expr(self.UNARY_PREC)
            left = ("unop", op, operand)
        else:
            left = self.parse_simple()
        while True:
            op = self.peek()
            prec = self.BINPREC.get(op)
            if prec is None or prec[0] <= limit:
                break
            self.next()
            right = self.parse_expr(prec[1])
            left = ("binop", op, left, right)
        return left

    def parse_simple(self):
        t, v, line = self.toks[self.i]
        if t == "number":
            self.next()
            return ("const", v)
        if t == "string":
            self.next()
            return ("const", v)
        if t == "nil":
            self.next()
            return ("const", None)
        if t == "true":
            self.next()
            return ("const", True)
        if t == "false":
            self.next()
            return ("const", False)
        if t == "function":
            self.next()
            return self.parse_function_body(False)
        if t == "{":
            return self.parse_table()
        if t == "...":
            self.next()
            return ("vararg",)
        return self.parse_suffixed()

    def parse_primary(self):
        t, v, line = self.toks[self.i]
        if t == "name":
            self.next()
            return ("name", v)
        if t == "(":
            self.next()
            e = self.parse_expr()
            self.expect(")")
            return ("paren", e)
        raise LuaError(f"line {line}: unexpected {t!r}")

    def parse_suffixed(self):
        e = self.parse_primary()
        while True:
            t = self.peek()
            if t == ".":
                self.next()
                key = self.expect("name")[1]
                e = ("index", e, ("const", key))
            elif t == "[":
                self.next()
                k = self.parse_expr()
                self.expect("]")
                e = ("index", e, k)
            elif t == "(":
                self.next()
                args = []
                if self.peek() != ")":
                    args.append(self.parse_expr())
                    while self.accept(","):
                        args.append(self.parse_expr())
                self.expect(")")
                e = ("call", e, args)
            elif t == "{":
                e = ("call", e, [self.parse_table()])
            elif t == "string":
                s = self.next()[1]
                e = ("call", e, [("const", s)])
            elif t == ":":
                self.next()
                mname = self.expect("name")[1]
                if self.peek() == "(":
                    self.next()
                    args = []
                    if self.peek() != ")":
                        args.append(self.parse_expr())
                        while self.accept(","):
                            args.append(self.parse_expr())
                    self.expect(")")
                elif self.peek() == "string":
                    args = [("const", self.next()[1])]
                elif self.peek() == "{":
                    args = [self.parse_table()]
                else:
                    raise LuaError("method call needs arguments")
                e = ("method", e, mname, args)
            else:
                break
        return e

    def parse_table(self):
        self.expect("{")
        items = []  # ("arr", expr) | ("kv", keyexpr, valexpr)
        while self.peek() != "}":
            if self.peek() == "[":
                self.next()
                k = self.parse_expr()
                self.expect("]")
                self.expect("=")
                v = self.parse_expr()
                items.append(("kv", k, v))
            elif (self.peek() == "name"
                  and self.toks[self.i + 1][0] == "="):
                k = self.next()[1]
                self.next()
                v = self.parse_expr()
                items.append(("kv", ("const", k), v))
            else:
                items.append(("arr", self.parse_expr()))
            if not (self.accept(",") or self.accept(";")):
                break
        self.expect("}")
        return ("table", items)


# ------------------------------------------------------------------
# Runtime values
# ------------------------------------------------------------------

class LuaTable:
    """Lua table: hash part + 1-based array conventions."""

    def __init__(self, items: Optional[Dict] = None):
        self.hash: Dict[Any, Any] = dict(items or {})

    def get(self, key):
        key = _normkey(key)
        return self.hash.get(key)

    def set(self, key, value):
        key = _normkey(key)
        if value is None:
            self.hash.pop(key, None)
        else:
            self.hash[key] = value

    def length(self):
        n = 0
        while (n + 1) in self.hash:
            n += 1
        return n

    def items_ordered(self):
        """pairs() order: array part first, then other keys."""
        n = self.length()
        for i in range(1, n + 1):
            yield i, self.hash[i]
        for k, v in self.hash.items():
            if isinstance(k, int) and 1 <= k <= n:
                continue
            yield k, v

    def __repr__(self):
        return f"LuaTable({self.hash!r})"


def _normkey(key):
    if isinstance(key, float) and key.is_integer():
        return int(key)
    return key


def lua_to_py(v):
    """Deep-convert to Python: array tables -> lists, else dicts."""
    if isinstance(v, LuaTable):
        n = v.length()
        extra = {k for k in v.hash if not (isinstance(k, int) and 1 <= k <= n)}
        if not extra:
            return [lua_to_py(v.hash[i]) for i in range(1, n + 1)]
        return {k: lua_to_py(val) for k, val in v.hash.items()}
    return v


def py_to_lua(v):
    if isinstance(v, (list, tuple)):
        return LuaTable({i + 1: py_to_lua(x) for i, x in enumerate(v)})
    if isinstance(v, dict):
        return LuaTable({k: py_to_lua(x) for k, x in v.items()})
    return v


class LuaFunction:
    def __init__(self, params, varargs, body, env):
        self.params = params
        self.varargs = varargs
        self.body = body
        self.env = env


class Env:
    def __init__(self, parent=None, globals_=None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent
        self.globals = globals_ if globals_ is not None else (
            parent.globals if parent else self.vars)

    def lookup(self, name):
        e = self
        while e is not None:
            if name in e.vars:
                return e.vars[name]
            e = e.parent
        return self.globals.get(name)

    def assign(self, name, value):
        e = self
        while e is not None:
            if name in e.vars:
                e.vars[name] = value
                return
            e = e.parent
        self.globals[name] = value

    def declare(self, name, value):
        self.vars[name] = value


class _Break(Exception):
    pass


class _Return(Exception):
    def __init__(self, values):
        self.values = values


# ------------------------------------------------------------------
# Evaluator
# ------------------------------------------------------------------

def _truthy(v):
    return v is not None and v is not False


def _tostring(v):
    if v is None:
        return "nil"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, float):
        if v.is_integer() and abs(v) < 1e16:
            return str(int(v))
        return "%.14g" % v
    if isinstance(v, int):
        return str(v)
    return str(v)


def _tonumber(v):
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return None
    return None


def _arith(op, a, b):
    x = _tonumber(a)
    y = _tonumber(b)
    if x is None or y is None:
        raise LuaError(f"arithmetic on non-number ({a!r} {op} {b!r})")
    if op == "+":
        return x + y
    if op == "-":
        return x - y
    if op == "*":
        return x * y
    if op == "/":
        return x / y
    if op == "%":
        return x - math.floor(x / y) * y
    if op == "//":
        return float(math.floor(x / y))
    if op == "^":
        return x ** y
    raise LuaError(f"unknown arithmetic op {op}")


class Interpreter:
    def __init__(self, globals_: Dict[str, Any]):
        self.genv = globals_

    # ---- entry ----

    def exec_block(self, block, env):
        for stmt in block[1]:
            self.exec_stmt(stmt, env)

    def exec_stmt(self, stmt, env):
        op = stmt[0]
        if op == "assign":
            values = self._eval_list(stmt[2], env, len(stmt[1]))
            for tgt, val in zip(stmt[1], values):
                self._assign_target(tgt, val, env)
        elif op == "local":
            values = self._eval_list(stmt[2], env, len(stmt[1]))
            for name, val in zip(stmt[1], values):
                env.declare(name, val)
        elif op == "localfunc":
            env.declare(stmt[1], None)
            fn = self.eval_expr(stmt[2], env)
            env.vars[stmt[1]] = fn
        elif op == "exprstat":
            self.eval_expr(stmt[1], env)
        elif op == "if":
            for cond, body in stmt[1]:
                if _truthy(self.eval_expr(cond, env)):
                    self.exec_block(body, Env(env))
                    return
            if stmt[2] is not None:
                self.exec_block(stmt[2], Env(env))
        elif op == "while":
            while _truthy(self.eval_expr(stmt[1], env)):
                try:
                    self.exec_block(stmt[2], Env(env))
                except _Break:
                    break
        elif op == "repeat":
            while True:
                benv = Env(env)
                try:
                    self.exec_block(stmt[1], benv)
                except _Break:
                    break
                if _truthy(self.eval_expr(stmt[2], benv)):
                    break
        elif op == "fornum":
            _, name, e1, e2, e3, body = stmt
            start = _tonumber(self.eval_expr(e1, env))
            stop = _tonumber(self.eval_expr(e2, env))
            step = _tonumber(self.eval_expr(e3, env)) if e3 else 1.0
            i = start
            while (step > 0 and i <= stop + 1e-12) or \
                  (step < 0 and i >= stop - 1e-12):
                benv = Env(env)
                benv.declare(name, i)
                try:
                    self.exec_block(body, benv)
                except _Break:
                    break
                i += step
        elif op == "forin":
            _, names, exprs, body = stmt
            vals = [self.eval_expr(e, env) for e in exprs]
            itf = vals[0]
            if callable(itf) or isinstance(itf, LuaFunction):
                state = vals[1] if len(vals) > 1 else None
                ctrl = vals[2] if len(vals) > 2 else None
                while True:
                    rets = self._call(itf, [state, ctrl])
                    if not isinstance(rets, tuple):
                        rets = (rets,)
                    if rets[0] is None:
                        break
                    ctrl = rets[0]
                    benv = Env(env)
                    for idx, nm in enumerate(names):
                        benv.declare(nm, rets[idx] if idx < len(rets) else None)
                    try:
                        self.exec_block(body, benv)
                    except _Break:
                        break
            else:
                raise LuaError("for-in over non-iterator")
        elif op == "do":
            self.exec_block(stmt[1], Env(env))
        elif op == "return":
            values = [self.eval_expr(e, env) for e in stmt[1]]
            raise _Return(tuple(values))
        elif op == "break":
            raise _Break()
        else:
            raise LuaError(f"unknown statement {op}")

    def _assign_target(self, tgt, val, env):
        if tgt[0] == "name":
            env.assign(tgt[1], val)
        elif tgt[0] == "index":
            obj = self.eval_expr(tgt[1], env)
            key = self.eval_expr(tgt[2], env)
            if isinstance(obj, LuaTable):
                obj.set(key, val)
            elif isinstance(obj, dict):
                obj[key] = val
            else:
                raise LuaError(f"cannot index {obj!r}")
        else:
            raise LuaError("bad assignment target")

    def _eval_list(self, exprs, env, want):
        values = []
        for i, e in enumerate(exprs):
            v = self.eval_expr(e, env, multi=(i == len(exprs) - 1))
            if isinstance(v, tuple):
                if i == len(exprs) - 1:
                    values.extend(v)
                else:
                    values.append(v[0] if v else None)
            else:
                values.append(v)
        while len(values) < want:
            values.append(None)
        return values

    def eval_expr(self, e, env, multi=False):
        op = e[0]
        if op == "const":
            return e[1]
        if op == "name":
            return env.lookup(e[1])
        if op == "paren":
            v = self.eval_expr(e[1], env)
            return v[0] if isinstance(v, tuple) else v
        if op == "index":
            obj = self.eval_expr(e[1], env)
            key = self.eval_expr(e[2], env)
            return self._index(obj, key)
        if op == "call":
            fn = self.eval_expr(e[1], env)
            args = self._eval_list(e[2], env, 0)
            ret = self._call(fn, args)
            if isinstance(ret, tuple) and not multi:
                return ret[0] if ret else None
            return ret
        if op == "method":
            obj = self.eval_expr(e[1], env)
            fn = self._index(obj, e[2])
            args = [obj] + self._eval_list(e[3], env, 0)
            ret = self._call(fn, args)
            if isinstance(ret, tuple) and not multi:
                return ret[0] if ret else None
            return ret
        if op == "function":
            return LuaFunction(e[1], e[2], e[3], env)
        if op == "table":
            t = LuaTable()
            arr = 1
            for item in e[1]:
                if item[0] == "arr":
                    t.set(arr, self.eval_expr(item[1], env))
                    arr += 1
                else:
                    k = self.eval_expr(item[1], env)
                    t.set(k, self.eval_expr(item[2], env))
            return t
        if op == "vararg":
            return env.lookup("...")
        if op == "binop":
            bop = e[1]
            if bop == "and":
                left = self.eval_expr(e[2], env)
                return self.eval_expr(e[3], env) if _truthy(left) else left
            if bop == "or":
                left = self.eval_expr(e[2], env)
                return left if _truthy(left) else self.eval_expr(e[3], env)
            a = self.eval_expr(e[2], env)
            b = self.eval_expr(e[3], env)
            if bop == "..":
                return _tostring(a) + _tostring(b)
            if bop == "==":
                return self._eq(a, b)
            if bop == "~=":
                return not self._eq(a, b)
            if bop in ("<", ">", "<=", ">="):
                if isinstance(a, str) and isinstance(b, str):
                    pass
                else:
                    a = _tonumber(a)
                    b = _tonumber(b)
                    if a is None or b is None:
                        raise LuaError("comparison of non-numbers")
                return {"<": a < b, ">": a > b,
                        "<=": a <= b, ">=": a >= b}[bop]
            return _arith(bop, a, b)
        if op == "unop":
            v = self.eval_expr(e[2], env)
            if e[1] == "-":
                n = _tonumber(v)
                if n is None:
                    raise LuaError("unary minus on non-number")
                return -n
            if e[1] == "not":
                return not _truthy(v)
            if e[1] == "#":
                if isinstance(v, LuaTable):
                    return float(v.length())
                if isinstance(v, str):
                    return float(len(v))
                raise LuaError("length of non-table")
        raise LuaError(f"unknown expression {op}")

    def _eq(self, a, b):
        if isinstance(a, bool) or isinstance(b, bool):
            return a is b
        if a is None or b is None:
            return a is b
        return a == b

    def _index(self, obj, key):
        if isinstance(obj, LuaTable):
            return obj.get(key)
        if isinstance(obj, dict):
            return obj.get(key)
        if isinstance(obj, str):
            return _STRING_LIB.get(key)
        if obj is None:
            raise LuaError(f"attempt to index a nil value (key {key!r})")
        raise LuaError(f"cannot index {type(obj).__name__}")

    def _call(self, fn, args):
        if isinstance(fn, LuaFunction):
            env = Env(fn.env)
            for i, p in enumerate(fn.params):
                env.declare(p, args[i] if i < len(args) else None)
            if fn.varargs:
                env.declare("...", tuple(args[len(fn.params):]))
            try:
                self.exec_block(fn.body, env)
            except _Return as r:
                return r.values if len(r.values) != 1 else r.values[0]
            return None
        if callable(fn):
            return fn(*args)
        raise LuaError(f"attempt to call a {type(fn).__name__} value")


# ------------------------------------------------------------------
# Standard library subset
# ------------------------------------------------------------------

def _lua_pairs(t, *_):
    if not isinstance(t, LuaTable):
        raise LuaError("pairs on non-table")
    items = list(t.items_ordered())
    idx = [0]

    def it(*_a):
        if idx[0] >= len(items):
            return (None,)
        k, v = items[idx[0]]
        idx[0] += 1
        return (float(k) if isinstance(k, int) else k, v)
    return it


def _lua_ipairs(t, *_):
    idx = [0]

    def it(*_a):
        idx[0] += 1
        v = t.get(idx[0])
        if v is None:
            return (None,)
        return (float(idx[0]), v)
    return it


def _lua_error(msg=None, *_):
    raise LuaError(_tostring(msg))


def _string_format(fmt, *args):
    out = []
    i = 0
    ai = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "%" and i + 1 < len(fmt):
            m = re.match(r"%[-+ #0]*\d*(?:\.\d+)?[diouxXeEfgGqscl%]",
                         fmt[i:])
            if m:
                spec = m.group(0)
                i += len(spec)
                if spec == "%%":
                    out.append("%")
                    continue
                conv = spec[-1]
                arg = args[ai]
                ai += 1
                if conv in "diouxX":
                    out.append(spec.replace("l", "") % int(arg))
                elif conv in "eEfgG":
                    out.append(spec % float(arg))
                elif conv == "q":
                    out.append('"%s"' % str(arg).replace('"', '\\"'))
                else:
                    out.append(spec % _tostring(arg))
                continue
        out.append(ch)
        i += 1
    return "".join(out)


_STRING_LIB = {
    "format": _string_format,
    "upper": lambda s, *_: s.upper(),
    "lower": lambda s, *_: s.lower(),
    "len": lambda s, *_: float(len(s)),
    "sub": lambda s, i, j=None, *_: s[int(i) - 1: int(j) if j else None],
    "rep": lambda s, n, *_: s * int(n),
}


def make_stdlib(output=None):
    def _print(*args):
        line = "\t".join(_tostring(a) for a in args)
        if output is not None:
            output.append(line)
        else:
            print(line)

    def _table_insert(t, a, b=None):
        if b is None:
            t.set(t.length() + 1, a)
        else:
            pos = int(a)
            n = t.length()
            for i in range(n, pos - 1, -1):
                t.set(i + 1, t.get(i))
            t.set(pos, b)

    mathlib = LuaTable({
        "pi": math.pi,
        "floor": lambda x, *_: float(math.floor(x)),
        "ceil": lambda x, *_: float(math.ceil(x)),
        "sqrt": lambda x, *_: math.sqrt(x),
        "abs": lambda x, *_: abs(x),
        "min": lambda *a: float(min(a)),
        "max": lambda *a: float(max(a)),
        "exp": lambda x, *_: math.exp(x),
        "log": lambda x, b=None, *_: (math.log(x, b) if b else math.log(x)),
        "log10": lambda x, *_: math.log10(x),
        "pow": lambda x, y, *_: float(x) ** float(y),
        "sin": lambda x, *_: math.sin(x),
        "cos": lambda x, *_: math.cos(x),
        "tan": lambda x, *_: math.tan(x),
        "huge": math.inf,
    })

    return {
        "pairs": _lua_pairs,
        "ipairs": _lua_ipairs,
        "error": _lua_error,
        "assert": lambda v, msg=None, *_: (
            v if _truthy(v) else _lua_error(msg or "assertion failed!")),
        "print": _print,
        "tostring": _tostring,
        "tonumber": lambda v, *_: _tonumber(v),
        "type": lambda v, *_: (
            "nil" if v is None else
            "boolean" if isinstance(v, bool) else
            "number" if isinstance(v, (int, float)) else
            "string" if isinstance(v, str) else
            "table" if isinstance(v, (LuaTable, dict)) else
            "function"),
        "math": mathlib,
        "string": LuaTable(_STRING_LIB),
        "table": LuaTable({"insert": _table_insert}),
        "tostring": _tostring,
    }


def run(source: str, globals_: Optional[Dict[str, Any]] = None,
        output=None) -> Dict[str, Any]:
    """Execute a Lua chunk; returns the globals dict (mutated in place)."""
    g = dict(make_stdlib(output))
    if globals_:
        g.update(globals_)
    interp = Interpreter(g)
    ast = Parser(tokenize(source)).parse_chunk()
    env = Env(globals_=g)
    try:
        interp.exec_block(ast, env)
    except _Return:
        pass
    return g


def call_function(fn, args=(), globals_: Optional[Dict[str, Any]] = None):
    """Invoke a LuaFunction obtained from run()'s globals (used by the
    fastpm-lua tool to execute a parameter file's `main`,
    src/lua-runtime-config.lua:706-716). The closure environment
    travels with the function; globals_ only seeds the stdlib when the
    function is a bare Python callable."""
    if callable(fn):
        return fn(*args)
    g = globals_ if globals_ is not None else dict(make_stdlib(None))
    return Interpreter(g)._call(fn, list(args))
