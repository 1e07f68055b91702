"""A painless-subset score-script language (the port's copy of
opensearch_tpu.script.painless): the lexer, the parser and the score
back-end.

Supported syntax: arithmetic / comparison / logic / ternary / elvis,
method calls, `doc['field'].value`, `params.x`, `_score`, local `def`
variables, assignment, if/else, loops and return. The score back-end
(`TorchScoreScript`) compiles one expression to elementwise torch ops over
dense doc-value columns, so a `script_score` runs as a few tensor ops over
the whole segment and a batch of queries instead of a per-document
interpreted call. Number literals stay Python floats, as in the
reference, and a Math function turns its Python-number arguments into f32
tensors before it runs, so `Math.log(2)` is an f32 log there too; `%` is
floor modulo and `Math.round` rounds half to even, as jnp's are. The host
evaluator of mutation contexts (update and ingest scripts) is not ported.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field as dc_field
from functools import lru_cache
from typing import Any, Dict, List, Optional, Tuple

import torch

from opensearch_tpu_torch.common.errors import OpenSearchTpuError


class ScriptError(OpenSearchTpuError):
    status = 400
    error_type = "script_exception"


# ------------------------------------------------------------------- lexer

_TOKEN_SPEC = [
    ("NUM", r"\d+\.\d+[fFdD]?|\d+[lLfFdD]?|\.\d+[fFdD]?"),
    ("STR", r"'(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\""),
    ("ID", r"[A-Za-z_][A-Za-z0-9_]*"),
    ("OP", r"\?\:|\+\+|--|\+=|-=|\*=|/=|%=|==|!=|<=|>=|&&|\|\||[-+*/%<>=!?:.,;()\[\]{}]"),
    ("WS", r"\s+|//[^\n]*"),
]
_TOKEN_RE = re.compile("|".join(f"(?P<{n}>{p})" for n, p in _TOKEN_SPEC))

_KEYWORDS = {"if", "else", "for", "while", "def", "return", "true", "false",
             "null", "in", "new"}
_TYPE_NAMES = {"int", "long", "float", "double", "boolean", "String", "Map",
               "List", "Object", "byte", "short", "char"}


def tokenize(src: str) -> List[Tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise ScriptError(f"unexpected character [{src[pos]}] at "
                              f"offset [{pos}]")
        kind = m.lastgroup
        text = m.group(0)
        pos = m.end()
        if kind == "WS":
            continue
        if kind == "ID" and text in _KEYWORDS:
            kind = text.upper()
        out.append((kind, text))
    out.append(("EOF", ""))
    return out


# --------------------------------------------------------------------- AST

@dataclass
class Node:
    pass


@dataclass
class Num(Node):
    value: float
    is_int: bool


@dataclass
class Str(Node):
    value: str


@dataclass
class Bool(Node):
    value: bool


@dataclass
class Null(Node):
    pass


@dataclass
class Var(Node):
    name: str


@dataclass
class Attr(Node):
    obj: Node
    name: str


@dataclass
class Index(Node):
    obj: Node
    key: Node


@dataclass
class Call(Node):
    obj: Optional[Node]     # None = free function (unused today)
    name: str
    args: List[Node]


@dataclass
class Bin(Node):
    op: str
    left: Node
    right: Node


@dataclass
class Un(Node):
    op: str
    value: Node


@dataclass
class Ternary(Node):
    cond: Node
    then: Node
    other: Node


@dataclass
class Elvis(Node):
    value: Node
    fallback: Node


@dataclass
class ListLit(Node):
    items: List[Node]


@dataclass
class MapLit(Node):
    pairs: List[Tuple[Node, Node]]


@dataclass
class Assign(Node):
    target: Node       # Var | Attr | Index
    op: str            # "=", "+=", ...
    value: Node


@dataclass
class If(Node):
    cond: Node
    then: List[Node]
    other: List[Node] = dc_field(default_factory=list)


@dataclass
class For(Node):
    init: Optional[Node]
    cond: Optional[Node]
    step: Optional[Node]
    body: List[Node] = dc_field(default_factory=list)


@dataclass
class ForIn(Node):
    var: str
    iterable: Node
    body: List[Node] = dc_field(default_factory=list)


@dataclass
class While(Node):
    cond: Node
    body: List[Node] = dc_field(default_factory=list)


@dataclass
class Decl(Node):
    name: str
    value: Optional[Node]


@dataclass
class Return(Node):
    value: Optional[Node]


@dataclass
class ExprStmt(Node):
    expr: Node


# ------------------------------------------------------------------ parser

class Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self, offset=0):
        return self.toks[min(self.i + offset, len(self.toks) - 1)]

    def next(self):
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def accept(self, kind, text=None):
        k, t = self.peek()
        if k == kind and (text is None or t == text):
            return self.next()
        return None

    def expect(self, kind, text=None):
        tok = self.accept(kind, text)
        if tok is None:
            k, t = self.peek()
            raise ScriptError(f"unexpected token [{t or k}], expected "
                              f"[{text or kind}]")
        return tok

    # statements

    def parse_program(self) -> List[Node]:
        stmts = []
        while self.peek()[0] != "EOF":
            stmts.append(self.statement())
        return stmts

    def block(self) -> List[Node]:
        if self.accept("OP", "{"):
            stmts = []
            while not self.accept("OP", "}"):
                stmts.append(self.statement())
            return stmts
        return [self.statement()]

    def statement(self) -> Node:
        k, t = self.peek()
        if k == "IF":
            self.next()
            self.expect("OP", "(")
            cond = self.expression()
            self.expect("OP", ")")
            then = self.block()
            other = []
            if self.accept("ELSE"):
                other = self.block()
            return If(cond, then, other)
        if k == "FOR":
            self.next()
            self.expect("OP", "(")
            # for-in:  for (def x : list)  /  for (x in list)
            if (self.peek()[0] in ("DEF", "ID")
                    and (self.peek(1)[1] == ":" or self.peek(2)[1] == ":"
                         or self.peek(1)[0] == "IN" or self.peek(2)[0] == "IN")):
                save = self.i
                self.accept("DEF") or (self.peek()[0] == "ID"
                                       and self.peek()[1] in _TYPE_NAMES
                                       and self.next())
                name_tok = self.accept("ID")
                if name_tok and (self.accept("OP", ":") or self.accept("IN")):
                    iterable = self.expression()
                    self.expect("OP", ")")
                    return ForIn(name_tok[1], iterable, self.block())
                self.i = save
            init = None if self.peek()[1] == ";" else self.simple_statement()
            self.expect("OP", ";")
            cond = None if self.peek()[1] == ";" else self.expression()
            self.expect("OP", ";")
            step = None if self.peek()[1] == ")" else self.simple_statement()
            self.expect("OP", ")")
            return For(init, cond, step, self.block())
        if k == "WHILE":
            self.next()
            self.expect("OP", "(")
            cond = self.expression()
            self.expect("OP", ")")
            return While(cond, self.block())
        if k == "RETURN":
            self.next()
            value = None if self.peek()[1] == ";" or self.peek()[0] == "EOF" \
                else self.expression()
            self.accept("OP", ";")
            return Return(value)
        stmt = self.simple_statement()
        self.accept("OP", ";")
        return stmt

    def simple_statement(self) -> Node:
        k, t = self.peek()
        if k == "OP" and t in ("++", "--"):  # prefix increment statement
            self.next()
            target = self.postfix()
            if not isinstance(target, (Var, Attr, Index)):
                raise ScriptError("invalid increment target")
            return Assign(target, "+=" if t == "++" else "-=", Num(1, True))
        if k == "DEF" or (k == "ID" and t in _TYPE_NAMES
                          and self.peek(1)[0] == "ID"):
            self.next()
            name = self.expect("ID")[1]
            value = None
            if self.accept("OP", "="):
                value = self.expression()
            return Decl(name, value)
        expr = self.expression()
        k, t = self.peek()
        if k == "OP" and t in ("=", "+=", "-=", "*=", "/=", "%="):
            self.next()
            if not isinstance(expr, (Var, Attr, Index)):
                raise ScriptError("invalid assignment target")
            return Assign(expr, t, self.expression())
        if k == "OP" and t in ("++", "--"):
            self.next()
            if not isinstance(expr, (Var, Attr, Index)):
                raise ScriptError("invalid increment target")
            return Assign(expr, "+=" if t == "++" else "-=",
                          Num(1, True))
        return ExprStmt(expr)

    # expressions (precedence climbing)

    def expression(self) -> Node:
        return self.ternary()

    def ternary(self) -> Node:
        cond = self.elvis()
        if self.accept("OP", "?"):
            then = self.expression()
            self.expect("OP", ":")
            other = self.expression()
            return Ternary(cond, then, other)
        return cond

    def elvis(self) -> Node:
        left = self.logic_or()
        if self.accept("OP", "?:"):
            return Elvis(left, self.elvis())
        return left

    def logic_or(self) -> Node:
        left = self.logic_and()
        while self.accept("OP", "||"):
            left = Bin("||", left, self.logic_and())
        return left

    def logic_and(self) -> Node:
        left = self.equality()
        while self.accept("OP", "&&"):
            left = Bin("&&", left, self.equality())
        return left

    def equality(self) -> Node:
        left = self.relational()
        while self.peek()[1] in ("==", "!=") and self.peek()[0] == "OP":
            op = self.next()[1]
            left = Bin(op, left, self.relational())
        return left

    def relational(self) -> Node:
        left = self.additive()
        while self.peek()[1] in ("<", "<=", ">", ">=") and self.peek()[0] == "OP":
            op = self.next()[1]
            left = Bin(op, left, self.additive())
        return left

    def additive(self) -> Node:
        left = self.multiplicative()
        while self.peek()[1] in ("+", "-") and self.peek()[0] == "OP":
            op = self.next()[1]
            left = Bin(op, left, self.multiplicative())
        return left

    def multiplicative(self) -> Node:
        left = self.unary()
        while self.peek()[1] in ("*", "/", "%") and self.peek()[0] == "OP":
            op = self.next()[1]
            left = Bin(op, left, self.unary())
        return left

    def unary(self) -> Node:
        if self.accept("OP", "-"):
            return Un("-", self.unary())
        if self.accept("OP", "!"):
            return Un("!", self.unary())
        if self.accept("OP", "+"):
            return self.unary()
        return self.postfix()

    def postfix(self) -> Node:
        node = self.primary()
        while True:
            if self.accept("OP", "."):
                name = self.expect("ID")[1]
                if self.accept("OP", "("):
                    args = self.call_args()
                    node = Call(node, name, args)
                else:
                    node = Attr(node, name)
            elif self.accept("OP", "["):
                key = self.expression()
                self.expect("OP", "]")
                node = Index(node, key)
            else:
                return node

    def call_args(self) -> List[Node]:
        args = []
        if self.accept("OP", ")"):
            return args
        args.append(self.expression())
        while self.accept("OP", ","):
            args.append(self.expression())
        self.expect("OP", ")")
        return args

    def primary(self) -> Node:
        k, t = self.peek()
        if k == "NUM":
            self.next()
            text = t.rstrip("lLfFdD")
            if "." in text or t[-1] in "fFdD":
                return Num(float(text), False)
            return Num(float(int(text)), True)
        if k == "STR":
            self.next()
            body = t[1:-1]
            body = body.replace("\\'", "'").replace('\\"', '"') \
                       .replace("\\n", "\n").replace("\\t", "\t") \
                       .replace("\\\\", "\\")
            return Str(body)
        if k == "TRUE":
            self.next()
            return Bool(True)
        if k == "FALSE":
            self.next()
            return Bool(False)
        if k == "NULL":
            self.next()
            return Null()
        if k == "NEW":  # new ArrayList() / new HashMap()
            self.next()
            name = self.expect("ID")[1]
            self.expect("OP", "(")
            self.expect("OP", ")")
            if "List" in name:
                return ListLit([])
            if "Map" in name:
                return MapLit([])
            raise ScriptError(f"cannot construct [{name}]")
        if k == "ID":
            self.next()
            return Var(t)
        if k == "OP" and t == "(":
            self.next()
            expr = self.expression()
            self.expect("OP", ")")
            return expr
        if k == "OP" and t == "[":  # [1, 2] list / [:] map literal
            self.next()
            if self.accept("OP", ":"):
                self.expect("OP", "]")
                return MapLit([])
            items = []
            if not self.accept("OP", "]"):
                items.append(self.expression())
                while self.accept("OP", ","):
                    items.append(self.expression())
                self.expect("OP", "]")
            if items and all(isinstance(i, Bin) and i.op == ":" for i in items):
                return MapLit([(i.left, i.right) for i in items])
            return ListLit(items)
        raise ScriptError(f"unexpected token [{t or k}]")


@lru_cache(maxsize=512)
def parse(source: str) -> Tuple[Node, ...]:
    return tuple(Parser(tokenize(source)).parse_program())


def collect_doc_fields(stmts) -> List[str]:
    """Fields the script reads through doc['...'] — what the torch back-end
    must materialize as dense columns."""
    fields: List[str] = []

    def walk(n):
        if isinstance(n, Index) and isinstance(n.obj, Var) \
                and n.obj.name == "doc" and isinstance(n.key, Str):
            if n.key.value not in fields:
                fields.append(n.key.value)
        for f in getattr(n, "__dataclass_fields__", {}):
            v = getattr(n, f)
            if isinstance(v, Node):
                walk(v)
            elif isinstance(v, (list, tuple)):
                for item in v:
                    if isinstance(item, Node):
                        walk(item)
                    elif isinstance(item, tuple):
                        for sub in item:
                            if isinstance(sub, Node):
                                walk(sub)

    for s in stmts:
        walk(s)
    return fields


# ---------------------------------------------------------- torch back-end

_MATH_CONSTS = {"PI": math.pi, "E": math.e}
# jnp.log10 is log(x) times this f32 constant, not a log10 of its own
_ONE_OVER_LN10 = 0.4342944819032518


def _as_tensors(args):
    """Python-number arguments as f32 tensors on the device of the tensor
    arguments."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               None)
    return [a if isinstance(a, torch.Tensor)
            else torch.tensor(a, dtype=torch.float32, device=dev)
            for a in args]


def _inexact(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.to(torch.float32)


def _log10(x: torch.Tensor) -> torch.Tensor:
    x = _inexact(x)
    return torch.log(x) * torch.tensor(_ONE_OVER_LN10, dtype=x.dtype,
                                       device=x.device)


_TORCH_MATH = {
    "log": torch.log, "log10": _log10, "exp": torch.exp,
    "sqrt": torch.sqrt, "abs": torch.abs, "max": torch.maximum,
    "min": torch.minimum, "pow": torch.pow, "floor": torch.floor,
    "ceil": torch.ceil, "round": torch.round,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
}


class TorchScoreScript:
    """A score script compiled to elementwise torch ops.

    `doc['f'].value` reads a dense f32 [Dp] column, `_score` is the child
    query's [B, Dp] scores, numeric `params.x` are f32 [B, 1] per-query
    columns: the result broadcasts to [B, Dp] (a constant expression stays
    a Python number or a 0-dim tensor)."""

    def __init__(self, source: str):
        stmts = parse(source)
        # a score script is one expression (possibly with a return)
        if len(stmts) == 1 and isinstance(stmts[0], ExprStmt):
            self.expr = stmts[0].expr
        elif len(stmts) == 1 and isinstance(stmts[0], Return) \
                and stmts[0].value is not None:
            self.expr = stmts[0].value
        else:
            raise ScriptError(
                "score scripts must be a single expression (the device "
                "back-end compiles expressions; use update/ingest contexts "
                "for statement scripts)")
        self.fields = collect_doc_fields(stmts)
        self.source = source

    def __call__(self, columns: Dict[str, Any], score, params: Dict[str, Any]):
        """columns: field -> (dense values f32 [Dp], exists bool [Dp],
        counts int32 [Dp])."""

        def ev(n):
            if isinstance(n, Num):
                return n.value
            if isinstance(n, Bool):
                return n.value
            if isinstance(n, Var):
                if n.name == "_score":
                    return score
                raise ScriptError(f"variable [{n.name}] is not available in "
                                  f"device score scripts")
            if isinstance(n, Attr):
                if isinstance(n.obj, Var) and n.obj.name == "params":
                    if n.name not in params:
                        raise ScriptError(f"missing script param [{n.name}]")
                    return params[n.name]
                if isinstance(n.obj, Var) and n.obj.name == "Math":
                    if n.name in _MATH_CONSTS:
                        return _MATH_CONSTS[n.name]
                if n.name in ("value", "empty"):
                    col = self._column(n.obj, columns)
                    if n.name == "value":
                        return col[0]
                    return ~col[1]
                raise ScriptError(f"unsupported attribute [{n.name}] in "
                                  f"device score scripts")
            if isinstance(n, Index):
                if isinstance(n.obj, Var) and n.obj.name == "params" \
                        and isinstance(n.key, Str):
                    if n.key.value not in params:
                        raise ScriptError(
                            f"missing script param [{n.key.value}]")
                    return params[n.key.value]
                raise ScriptError("unsupported indexing in device score "
                                  "scripts")
            if isinstance(n, Call):
                if isinstance(n.obj, Var) and n.obj.name == "Math":
                    fn = _TORCH_MATH.get(n.name)
                    if fn is None:
                        raise ScriptError(f"unknown Math method [{n.name}]")
                    return fn(*_as_tensors([ev(a) for a in n.args]))
                if n.name == "size":
                    col = self._column(n.obj, columns)
                    return col[2]
                raise ScriptError(f"unsupported method [{n.name}] in device "
                                  f"score scripts")
            if isinstance(n, Bin):
                a, b = ev(n.left), ev(n.right)
                return {
                    "+": lambda: a + b, "-": lambda: a - b,
                    "*": lambda: a * b, "/": lambda: a / b,
                    "%": lambda: a % b,
                    "==": lambda: a == b, "!=": lambda: a != b,
                    "<": lambda: a < b, "<=": lambda: a <= b,
                    ">": lambda: a > b, ">=": lambda: a >= b,
                    "&&": lambda: a & b, "||": lambda: a | b,
                }[n.op]()
            if isinstance(n, Un):
                v = ev(n.value)
                return -v if n.op == "-" else ~v
            if isinstance(n, Ternary):
                cond, then, other = ev(n.cond), ev(n.then), ev(n.other)
                if not isinstance(cond, torch.Tensor):
                    cond = torch.tensor(bool(cond), device=score.device)
                return torch.where(cond, then, other)
            raise ScriptError(f"unsupported expression "
                              f"[{type(n).__name__}] in device score scripts")

        return ev(self.expr)

    def _column(self, node, columns):
        if isinstance(node, Index) and isinstance(node.obj, Var) \
                and node.obj.name == "doc" and isinstance(node.key, Str):
            field = node.key.value
            if field not in columns:
                raise ScriptError(f"No field found for [{field}] in mapping")
            return columns[field]
        raise ScriptError("doc access must be doc['field']")


@lru_cache(maxsize=256)
def compile_score_script(source: str) -> TorchScoreScript:
    return TorchScoreScript(source)
