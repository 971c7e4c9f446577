"""Parser for the Stan modeling-language subset used by the reference models.

The reference delegates `.stan` files to the external Stan/BridgeStan C++
toolchain (reference smcnuts/model/bridgestan.py:18, README.md:19-23). This
frontend makes the same user asset — a `.stan` file plus a data JSON — work
without any native toolchain: the program is parsed here and interpreted in
torch ops by `compiler.py`, so log-density and gradient come from autograd
(or from a generated in-kernel model) instead of a per-particle C FFI.

The port's own copy of `smcnuts_tpu/stan/parser.py` (which imports no JAX):
the port imports nothing of the JAX package, and both parsers return equal
ASTs for every program (`tests/test_torch_stan_frontend.py`).

Grammar subset (covers reference stan_models/arma/arma.stan and
stan_models/PRMwCD/PRMwCD.stan, plus the common constructs around them):

  program      := block+
  block        := ('data'|'transformed data'|'parameters'|
                   'transformed parameters'|'model'|'generated quantities')
                  '{' statement* '}'
  declaration  := ['array' '[' expr (',' expr)* ']'] type [constraint]
                  ['[' expr (',' expr)* ']']            # vector/matrix dims
                  name ['[' expr (',' expr)* ']']       # old-style array dims
                  ['=' expr] ';'
  type         := 'int' | 'real' | 'vector' | 'row_vector' | 'matrix'
  constraint   := '<' ('lower'|'upper') '=' expr (',' ...) '>'
  statement    := declaration | lvalue ('='|'+='|'-='|'*='|'/=') expr ';'
                | 'target' '+=' expr ';' | expr '~' name '(' args ')' ';'
                | 'for' '(' name 'in' expr ':' expr ')' statement
                | 'if' '(' expr ')' statement ['else' statement]
                | '{' statement* '}' | 'print' | 'reject'
  expr         := ternary with Stan operator precedence; calls may use '|'
                  as the first argument separator (lpdf/lpmf conditioning bar)

Unsupported constructs raise StanSyntaxError with a line number rather than
misparse silently.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional


class StanSyntaxError(Exception):
    pass


# ---------------------------------------------------------------- tokenizer

_TOKEN_RE = re.compile(
    r"""
      (?P<skip>\s+|//[^\n]*|\#[^\n]*|/\*.*?\*/)
    | (?P<str>"[^"\n]*")
    | (?P<real>(?:\d+\.\d*|\.\d+)(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)
    | (?P<int>\d+)
    | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<op>\+=|-=|\*=|/=|\.\*|\./|&&|\|\||==|!=|<=|>=|[-+*/^%<>=(){}\[\],;:|!?~'])
    """,
    re.X | re.S,
)


@dataclasses.dataclass
class Token:
    kind: str  # 'real' | 'int' | 'id' | 'op' | 'eof'
    text: str
    line: int


def tokenize(src: str) -> list[Token]:
    tokens, pos, line = [], 0, 1
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise StanSyntaxError(
                f"line {line}: unexpected character {src[pos]!r}"
            )
        text = m.group(0)
        if m.lastgroup != "skip":
            tokens.append(Token(m.lastgroup, text, line))
        line += text.count("\n")
        pos = m.end()
    tokens.append(Token("eof", "", line))
    return tokens


# ---------------------------------------------------------------- AST nodes


@dataclasses.dataclass
class Num:
    value: Any
    is_int: bool


@dataclasses.dataclass
class Var:
    name: str


@dataclasses.dataclass
class Call:
    name: str
    args: list


@dataclasses.dataclass
class Bin:
    op: str
    left: Any
    right: Any


@dataclasses.dataclass
class Unary:
    op: str
    operand: Any


@dataclasses.dataclass
class Ternary:
    cond: Any
    then: Any
    other: Any


@dataclasses.dataclass
class RangeIdx:
    """1-based inclusive index range `lo:hi` inside brackets (Stan multiple
    indexing, e.g. y[2:T]); lo/hi None = open end."""

    lo: Any
    hi: Any


@dataclasses.dataclass
class Index:
    base: Any
    indices: list


@dataclasses.dataclass
class Constraint:
    lower: Any = None  # expr or None
    upper: Any = None
    offset: Any = None  # affine non-centering: c = offset + multiplier * u
    multiplier: Any = None


@dataclasses.dataclass
class Decl:
    type: str  # 'int' | 'real' | 'vector' | 'row_vector' | 'matrix' | 'tuple'
    name: str
    dims: list  # size exprs; [] for scalar (vector/matrix dims + array dims)
    constraint: Optional[Constraint]
    init: Any = None
    line: int = 0
    subtypes: Any = None  # for 'tuple': [(member_type, [dim exprs]), ...]


@dataclasses.dataclass
class Assign:
    lvalue: Any  # Var or Index
    op: str  # '=', '+=', '-=', '*=', '/='
    expr: Any = None
    line: int = 0


@dataclasses.dataclass
class TargetPlus:
    expr: Any
    line: int = 0


@dataclasses.dataclass
class Sampling:
    lhs: Any
    dist: str
    args: list
    line: int = 0
    # Truncation bounds from `T[lo, hi]` (None when absent / one-sided).
    t_lower: Any = None
    t_upper: Any = None


@dataclasses.dataclass
class For:
    var: str
    lo: Any
    hi: Any
    body: list
    line: int = 0


@dataclasses.dataclass
class While:
    cond: Any
    body: list
    line: int = 0


@dataclasses.dataclass
class Return:
    expr: Any  # None for bare `return;`
    line: int = 0


@dataclasses.dataclass
class Reject:
    """`reject(...)`: a reached reject makes the draw's density -inf in
    Stan. Parameter-dependent `if` is unsupported here, so a reject that
    executes at trace time would reject EVERY draw — the compiler raises
    instead of silently ignoring it. Rejects behind false data-derived
    conditions are simply never reached."""

    line: int = 0


@dataclasses.dataclass
class ExprStmt:
    """Bare call statement, e.g. `add_prior_lp(a);` — evaluated for its
    side effect (a user function's `target +=`)."""

    expr: Any
    line: int = 0


@dataclasses.dataclass
class Break:
    line: int = 0


@dataclasses.dataclass
class Continue:
    line: int = 0


@dataclasses.dataclass
class FuncDef:
    ret_type: str  # 'void' | 'int' | 'real' | 'vector' | 'row_vector' | 'matrix'
    name: str
    params: list  # [(type_str, name), ...]
    body: list
    line: int = 0


@dataclasses.dataclass
class If:
    cond: Any
    then: list
    other: list
    line: int = 0


@dataclasses.dataclass
class Program:
    blocks: dict  # block name -> list of statements


_BLOCK_NAMES = (
    "functions",
    "data",
    "transformed data",
    "parameters",
    "transformed parameters",
    "model",
    "generated quantities",
)

_TYPE_NAMES = ("int", "real", "vector", "row_vector", "matrix")

# Types whose constraint is part of the TYPE (Stan reference manual ch. 10):
# declared like `simplex[K] theta;` — exactly one dimension, the constraining
# transform supplied by the compiler's _ParamSpec (cholesky_factor_corr[K]
# produces a K x K lower-triangular factor from K(K-1)/2 coordinates).
_CONSTRAINED_VEC_TYPES = ("simplex", "ordered", "positive_ordered",
                          "unit_vector", "cholesky_factor_corr",
                          "corr_matrix", "cov_matrix",
                          "cholesky_factor_cov")


class _Parser:
    def __init__(self, tokens: list[Token]):
        self.tokens = tokens
        self.i = 0

    # -- token helpers --
    @property
    def cur(self) -> Token:
        return self.tokens[self.i]

    def peek(self, k=1) -> Token:
        return self.tokens[min(self.i + k, len(self.tokens) - 1)]

    def advance(self) -> Token:
        tok = self.cur
        self.i += 1
        return tok

    def accept(self, text: str) -> bool:
        if self.cur.text == text and self.cur.kind in ("op", "id"):
            self.i += 1
            return True
        return False

    def expect(self, text: str) -> Token:
        if self.cur.text != text:
            raise StanSyntaxError(
                f"line {self.cur.line}: expected {text!r}, got "
                f"{self.cur.text!r}"
            )
        return self.advance()

    def fail(self, msg: str):
        raise StanSyntaxError(f"line {self.cur.line}: {msg}")

    # -- program / blocks --
    def parse_program(self) -> Program:
        blocks = {}
        while self.cur.kind != "eof":
            name = self.advance().text
            if name == "transformed" and self.cur.text in ("data", "parameters"):
                name = f"transformed {self.advance().text}"
            if name == "generated" and self.cur.text == "quantities":
                name = f"generated {self.advance().text}"
            if name not in _BLOCK_NAMES:
                self.fail(f"unknown block {name!r}")
            self.expect("{")
            if name == "functions":
                blocks[name] = self.parse_function_defs()
            else:
                blocks[name] = self.parse_statements_until("}")
            self.expect("}")
        return Program(blocks)

    def parse_function_defs(self) -> list:
        """functions block: `ret_type name(type arg, ...) { body }` per
        definition. Parameter types are unsized (Stan function signatures
        carry no dimensions); `array[] T` / trailing `[]` mark array args."""
        defs = []
        while self.cur.text != "}":
            line = self.cur.line
            ret = self.advance()
            if ret.kind != "id" or (
                ret.text not in _TYPE_NAMES + ("void",)
            ):
                self.fail(f"expected function return type, got {ret.text!r}")
            fname = self.advance()
            if fname.kind != "id":
                self.fail("expected function name")
            self.expect("(")
            params = []
            while self.cur.text != ")":
                self.accept("data")  # data-only qualifier: no-op here
                is_array = False
                if self.accept("array"):
                    self.expect("[")
                    self.expect("]")
                    is_array = True
                ptype = self.advance()
                if ptype.text not in _TYPE_NAMES:
                    self.fail(f"unsupported parameter type {ptype.text!r}")
                pname = self.advance()
                if pname.kind != "id":
                    self.fail("expected parameter name")
                if self.accept("["):  # old-style `real x[]`
                    self.expect("]")
                    is_array = True
                params.append(
                    (("array " if is_array else "") + ptype.text, pname.text)
                )
                if not self.accept(","):
                    break
            self.expect(")")
            self.expect("{")
            body = self.parse_statements_until("}")
            self.expect("}")
            defs.append(FuncDef(ret.text, fname.text, params, body,
                                line=line))
        return defs

    def parse_statements_until(self, closer: str) -> list:
        stmts = []
        while self.cur.text != closer:
            if self.cur.kind == "eof":
                self.fail(f"expected {closer!r} before end of file")
            stmts.append(self.parse_statement())
        return stmts

    # -- statements --
    def _at_declaration(self) -> bool:
        if self.cur.text == "array":
            return True
        if self.cur.text == "tuple" and self.peek().text == "(":
            return True
        if self.cur.kind == "id" and self.cur.text in _CONSTRAINED_VEC_TYPES:
            return self.peek().text == "["
        if self.cur.kind == "id" and self.cur.text in _TYPE_NAMES:
            # A type keyword starting a declaration is followed by '<', '[',
            # or an identifier; bare use as a variable name would not be.
            nxt = self.peek().text
            return nxt in ("<", "[") or self.peek().kind == "id"
        return False

    def parse_statement(self):
        tok = self.cur
        if tok.text == "{":
            self.advance()
            stmts = self.parse_statements_until("}")
            self.expect("}")
            return stmts
        if tok.text == "for":
            return self.parse_for()
        if tok.text == "while":
            return self.parse_while()
        if tok.text == "if":
            return self.parse_if()
        if tok.text == "return":
            self.advance()
            expr = None
            if self.cur.text != ";":
                expr = self.parse_expr()
            self.expect(";")
            return Return(expr, line=tok.line)
        if tok.text == "break":
            self.advance()
            self.expect(";")
            return Break(line=tok.line)
        if tok.text == "continue":
            self.advance()
            self.expect(";")
            return Continue(line=tok.line)
        if tok.text in ("print", "reject"):
            # Skip through the call and ';' (arguments are display-only).
            is_reject = tok.text == "reject"
            self.advance()
            depth = 0
            while not (depth == 0 and self.cur.text == ";"):
                if self.cur.text == "(":
                    depth += 1
                elif self.cur.text == ")":
                    depth -= 1
                self.advance()
            self.expect(";")
            return Reject(line=tok.line) if is_reject else []
        if tok.text == "target":
            self.advance()
            self.expect("+=")
            expr = self.parse_expr()
            self.expect(";")
            return TargetPlus(expr, line=tok.line)
        if self._at_declaration():
            return self.parse_declaration()
        # assignment or sampling statement
        lhs = self.parse_expr()
        if self.cur.text == "~":
            self.advance()
            dist = self.advance()
            if dist.kind != "id":
                self.fail("expected distribution name after '~'")
            self.expect("(")
            args = self.parse_call_args()
            self.expect(")")
            t_lower = t_upper = None
            if self.cur.text == "T":  # truncation T[lo, hi] / T[lo, ] / T[, hi]
                self.advance()
                self.expect("[")
                if self.cur.text != ",":
                    t_lower = self.parse_expr()
                self.expect(",")
                if self.cur.text != "]":
                    t_upper = self.parse_expr()
                self.expect("]")
                if t_lower is None and t_upper is None:
                    self.fail("empty truncation T[,]")
            self.expect(";")
            return Sampling(lhs, dist.text, args, line=tok.line,
                            t_lower=t_lower, t_upper=t_upper)
        for op in ("=", "+=", "-=", "*=", "/="):
            if self.cur.text == op:
                self.advance()
                expr = self.parse_expr()
                self.expect(";")
                if not isinstance(lhs, (Var, Index)):
                    self.fail("invalid assignment target")
                return Assign(lhs, op, expr, line=tok.line)
        if isinstance(lhs, Call) and self.cur.text == ";":
            self.advance()
            return ExprStmt(lhs, line=tok.line)
        self.fail(f"expected statement, got expression near {tok.text!r}")

    def parse_for(self) -> For:
        line = self.cur.line
        self.expect("for")
        self.expect("(")
        var = self.advance()
        if var.kind != "id":
            self.fail("expected loop variable name")
        if self.advance().text != "in":
            self.fail("expected 'in' in for loop")
        lo = self.parse_expr()
        self.expect(":")
        hi = self.parse_expr()
        self.expect(")")
        body = self.parse_statement()
        if not isinstance(body, list):
            body = [body]
        return For(var.text, lo, hi, body, line=line)

    def parse_while(self) -> While:
        line = self.cur.line
        self.expect("while")
        self.expect("(")
        cond = self.parse_expr()
        self.expect(")")
        body = self.parse_statement()
        if not isinstance(body, list):
            body = [body]
        return While(cond, body, line=line)

    def parse_if(self) -> If:
        line = self.cur.line
        self.expect("if")
        self.expect("(")
        cond = self.parse_expr()
        self.expect(")")
        then = self.parse_statement()
        if not isinstance(then, list):
            then = [then]
        other = []
        if self.accept("else"):
            other = self.parse_statement()
            if not isinstance(other, list):
                other = [other]
        return If(cond, then, other, line=line)

    def parse_declaration(self) -> Decl:
        line = self.cur.line
        if self.cur.text == "tuple" and self.peek().text == "(":
            # tuple(type1, type2, ...) name [= init];  (Stan 2.33 tuples;
            # local/TP declarations — arrays of tuples and tuple-typed
            # parameters/data are rejected by the compiler)
            self.advance()
            self.expect("(")
            subtypes = [self._parse_tuple_member(line)]
            while self.accept(","):
                subtypes.append(self._parse_tuple_member(line))
            self.expect(")")
            name = self.advance()
            if name.kind != "id":
                raise StanSyntaxError(
                    f"line {line}: expected variable name, got {name.text!r}"
                )
            init = None
            if self.accept("="):
                init = self.parse_expr()
            self.expect(";")
            return Decl(
                type="tuple", name=name.text, dims=[], constraint=None,
                init=init, line=line, subtypes=subtypes,
            )
        array_dims = []
        if self.accept("array"):
            self.expect("[")
            array_dims.append(self.parse_expr())
            while self.accept(","):
                array_dims.append(self.parse_expr())
            self.expect("]")
        type_tok = self.advance()
        if type_tok.text not in _TYPE_NAMES + _CONSTRAINED_VEC_TYPES:
            raise StanSyntaxError(
                f"line {line}: unsupported type {type_tok.text!r} (supported: "
                f"{', '.join(_TYPE_NAMES + _CONSTRAINED_VEC_TYPES)})"
            )
        constraint = self.parse_constraint()
        if constraint is not None and type_tok.text in _CONSTRAINED_VEC_TYPES:
            raise StanSyntaxError(
                f"line {line}: {type_tok.text} carries its own constraint; "
                "lower/upper bounds cannot be combined with it"
            )
        inner_dims = []
        if type_tok.text in ("vector", "row_vector",
                             "matrix") + _CONSTRAINED_VEC_TYPES:
            self.expect("[")
            inner_dims.append(self.parse_expr())
            while self.accept(","):
                inner_dims.append(self.parse_expr())
            self.expect("]")
        name = self.advance()
        if name.kind != "id":
            raise StanSyntaxError(
                f"line {line}: expected variable name, got {name.text!r}"
            )
        # old-style trailing array dims: real x[N];
        if self.cur.text == "[":
            self.advance()
            array_dims.append(self.parse_expr())
            while self.accept(","):
                array_dims.append(self.parse_expr())
            self.expect("]")
        init = None
        if self.accept("="):
            init = self.parse_expr()
        self.expect(";")
        return Decl(
            type=type_tok.text,
            name=name.text,
            dims=array_dims + inner_dims,
            constraint=constraint,
            init=init,
            line=line,
        )

    def _parse_tuple_member(self, line):
        t = self.advance()
        if t.text == "tuple":
            raise StanSyntaxError(
                f"line {line}: nested tuples are not supported"
            )
        if t.text not in _TYPE_NAMES + _CONSTRAINED_VEC_TYPES:
            raise StanSyntaxError(
                f"line {line}: unsupported tuple member type {t.text!r}"
            )
        dims = []
        if self.cur.text == "[":
            self.advance()
            dims.append(self.parse_expr())
            while self.accept(","):
                dims.append(self.parse_expr())
            self.expect("]")
        return (t.text, dims)

    def parse_constraint(self) -> Optional[Constraint]:
        if self.cur.text != "<":
            return None
        # Lookahead: '<' starts a constraint only if followed by
        # lower/upper/offset/multiplier '='.
        if self.peek().text not in ("lower", "upper", "offset", "multiplier"):
            return None
        self.advance()
        c = Constraint()
        while True:
            kind = self.advance().text
            self.expect("=")
            # Bounds are parsed at additive precedence so the closing '>'
            # is never mistaken for a comparison operator.
            expr = self.parse_additive()
            if kind == "lower":
                c.lower = expr
            elif kind == "upper":
                c.upper = expr
            elif kind == "offset":
                c.offset = expr
            elif kind == "multiplier":
                c.multiplier = expr
            else:
                self.fail(f"unsupported constraint {kind!r}")
            if self.accept(","):
                continue
            self.expect(">")
            return c

    # -- expressions (precedence climbing) --
    def parse_expr(self):
        return self.parse_ternary()

    def parse_ternary(self):
        cond = self.parse_or()
        if self.accept("?"):
            then = self.parse_expr()
            self.expect(":")
            other = self.parse_expr()
            return Ternary(cond, then, other)
        return cond

    def _binop_level(self, ops, next_level):
        node = next_level()
        while self.cur.text in ops and self.cur.kind == "op":
            op = self.advance().text
            node = Bin(op, node, next_level())
        return node

    def parse_or(self):
        return self._binop_level(("||",), self.parse_and)

    def parse_and(self):
        return self._binop_level(("&&",), self.parse_equality)

    def parse_equality(self):
        return self._binop_level(("==", "!="), self.parse_relational)

    def parse_relational(self):
        return self._binop_level(("<", "<=", ">", ">="), self.parse_additive)

    def parse_additive(self):
        return self._binop_level(("+", "-"), self.parse_multiplicative)

    def parse_multiplicative(self):
        return self._binop_level(
            ("*", "/", "%", ".*", "./"), self.parse_unary
        )

    def parse_unary(self):
        if self.cur.text in ("-", "+", "!") and self.cur.kind == "op":
            op = self.advance().text
            return Unary(op, self.parse_unary())
        return self.parse_power()

    def parse_power(self):
        base = self.parse_postfix()
        if self.cur.text == "^":
            self.advance()
            # right-associative; exponent binds unary ops (2^-1 valid)
            return Bin("^", base, self.parse_unary())
        return base

    def parse_index_item(self):
        if self.cur.text == ":":
            self.advance()
            hi = None
            if self.cur.text not in ("]", ","):
                hi = self.parse_expr()
            return RangeIdx(None, hi)
        e = self.parse_expr()
        if self.accept(":"):
            hi = None
            if self.cur.text not in ("]", ","):
                hi = self.parse_expr()
            return RangeIdx(e, hi)
        return e

    def parse_postfix(self):
        node = self.parse_primary()
        while True:
            if self.cur.text == "[":
                self.advance()
                idxs = [self.parse_index_item()]
                while self.accept(","):
                    idxs.append(self.parse_index_item())
                self.expect("]")
                node = Index(node, idxs)
            elif self.cur.text == "'":
                self.advance()
                node = Call("transpose", [node])
            elif (
                self.cur.kind == "real"
                and self.cur.text.startswith(".")
                and self.cur.text[1:].isdigit()
            ):
                # tuple member access t.1 (lexed as the real token '.1')
                k = int(self.cur.text[1:])
                self.advance()
                node = Call("__tuple_get__", [node, Num(k, True)])
            else:
                return node

    def parse_primary(self):
        tok = self.cur
        if tok.kind == "int":
            self.advance()
            return Num(int(tok.text), True)
        if tok.kind == "real":
            self.advance()
            return Num(float(tok.text), False)
        if tok.text == "(":
            self.advance()
            expr = self.parse_expr()
            if self.cur.text == ",":
                # (a, b, ...) tuple expression (Stan 2.33)
                elems = [expr]
                while self.accept(","):
                    elems.append(self.parse_expr())
                self.expect(")")
                return Call("__tuple__", elems)
            self.expect(")")
            return expr
        if tok.text in ("{", "["):
            # Array literal {a, b, c} stacks along a new leading axis;
            # the bracketed matrix-expression literal [a, b, c] is a
            # ROW VECTOR (Stan reference: matrix expressions), and
            # [[..],[..]] / [rv1, rv2] a matrix — so [..]' is the
            # column-vector idiom.
            close = "}" if tok.text == "{" else "]"
            kind = "__stack__" if tok.text == "{" else "__rowvec__"
            self.advance()
            elems = []
            if self.cur.text != close:
                elems.append(self.parse_expr())
                while self.accept(","):
                    elems.append(self.parse_expr())
            self.expect(close)
            return Call(kind, elems)
        if tok.kind == "id":
            self.advance()
            if self.cur.text == "(":
                self.advance()
                args = self.parse_call_args()
                self.expect(")")
                return Call(tok.text, args)
            return Var(tok.text)
        self.fail(f"unexpected token {tok.text!r}")

    def parse_call_args(self) -> list:
        if self.cur.text == ")":
            return []
        args = [self.parse_expr()]
        # conditioning bar in lpdf/lpmf calls: f(y | a, b)
        if self.accept("|"):
            args.append(self.parse_expr())
        while self.accept(","):
            args.append(self.parse_expr())
        return args


def parse(source: str) -> Program:
    """Parse Stan source into a Program AST (subset; see module docstring)."""
    return _Parser(tokenize(source)).parse_program()
