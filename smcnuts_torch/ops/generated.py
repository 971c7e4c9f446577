"""Generated in-kernel models: a user's torch density, differentiated and
simplified at build time, as CUDA source for the NUTS kernel (TPU kernel K7).

The JAX package runs any traced per-particle density inside its Pallas NUTS
kernel through `tile_model_from_logp` (reverse mode, `nuts_pallas.py:1126`)
and `tile_model_from_logp_fwd` (one forward pass a coordinate, `:1674`),
both cleaned up by `_cse_jaxpr` / `_simplify_call` (`:1193`, `:1422`). Here:

- `tile_model_from_logp(logp_fn, dim)` traces `torch.func.grad_and_value`
  of `logp_fn(theta (D,), phi)` with `make_fx` into ATen ops;
- `tile_model_from_logp_fwd(logp_seq_fn, dim)` traces the primal of
  `logp_seq_fn(coords, phi)` alone, as a function of D scalars, and then
  applies this module's own forward rules, one pass a coordinate. A tangent
  that is symbolically zero stays absent, so each pass walks only its
  coordinate's dependency cone, and the primal exists once (tracing
  `torch.func.jvp` instead gives 31k nodes for arma at T=200). Its program
  is emitted in (primal node, pass) order (`_primal_order`), which keeps few
  values live at once (`peak_live`); reverse-mode programs keep the order
  they were built in;
- a forward-mode program's recurrences, runs of steps that repeat the same
  ops in the same shape, are emitted as loops over their steps (`_reroll`,
  `Recurrence`, `_c_recurrences`): the values a step hands on in registers,
  each step's own literals and data a column of the data block, kinds of
  step that the data fold differently chosen by a column, an array of slots
  where the data choose which value a step reads (a gather, an indexed
  accumulator), a loop that reads another's steps in that loop's
  iterations, each loop unrolled by a factor its body's size sets
  (`_unroll`), so the code does not grow with the recurrence; the program
  itself, and so its bits, stay the same (`reroll=False`: straight-line);
- a reverse-mode program whose sums over an axis have summand cones that
  are one body (the same ops in the same shape, reading x[a + i], data and
  literals of their own, and values every summand shares: `_Body`) is split
  over a group of W lanes a particle where the caller asks for W
  (`_choose_group`, `_group_program`):
  the sums are built as W lanes run them (lane l folds summands l, l + W,
  ... in index order, an xor butterfly adds the lane partials), the body is
  emitted once inside a loop over a lane's summands with the data re-laid
  out as a table (entry i summand i's), the values read after the loop
  (such as grad[2 + j]) broadcast by shuffles, and every other node stays
  straight-line in every lane (`Loop`, `_c_loop`).

Both lower the traced graph to a program of scalar operations (`_Scalars`):
every element of a per-particle tensor becomes its own value, so a small
vector of static shape becomes registers, and `sum`, `dot`, `mv` and `mm`
become chains of sequential adds. While it builds, `_Scalars` does what
`_simplify_call` does: value numbering with commutative canonicalisation of
add and mul, float-constant propagation, the identities x*1, x*0, x+0, x-0,
0-x, x/1 and x-x, and lazy scalar coefficients (negation and literal factors
ride symbolically, so x*dx + dx*x costs one multiply and the 2 leaves the
whole accumulation chain as one multiply at its end). A division stays a
true division, as in the JAX package's simplified jaxpr (the plain version
divides tensor by tensor, since ATen's CUDA division by a Python scalar
multiplies by the reciprocal). Operations on constants alone are
folded at build time in float32: Python floats stay literals, tensor
constants (the data) and what is folded from them go to the data block that
the kernel stages in shared memory.

The simplified program is the function that both the kernel and its plain
version compute, so they round alike, op for op:

- `GeneratedModel.graph`, a `torch.fx.GraphModule` over ATen ops on lane
  tensors (P,), is the plain version (`GeneratedModel.logp_and_grad`); the
  plain NUTS tree (`ops/nuts_cuda.nuts_tree_plain`) takes it for a
  `CallableModel` that carries a generated model;
- `GeneratedModel.source` is the same program as a CUDA struct with the
  interface of `csrc/*_model.cuh` (`D`, `kScalars`, `accepts`, a constructor
  from the data block, `logp_grad`); `build_generated` compiles it into one
  `SMCNUTS_ENTRY` of `csrc/nuts_tree.cuh` (a first-stage and a continuation
  instantiation) with the flags of `ops/nuts_cuda.NVCC_FLAGS`.

The same lowering takes a function of many outputs (`lower_function`,
`Function`): an ODE right-hand side and its VJP (`ops/ode.OdeProgram`), in
float32 or float64, its literals rounded, folded and printed in that type
(`_real`); `function_graph` is its plain version, `function_lines` its body
in CUDA C++ for `csrc/ode_dopri5.cuh`. The special functions built from the
program's ops mirror ATen's float code and lower in float32 only.

The program of a split model holds the lanes' partials and lane 0's
butterfly adds as ordinary adds, so the plain version, `count_ops` and
`peak_live` compute what the lanes compute.

What bounds the kernel on an H100: the FP32 instruction rate and latency of
its straight-line program (`GeneratedModel.n_ops` operations a leapfrog),
which `chip_smoke.py` divides by the card's FP32 rate (and by the FMUL+FADD
peak of `ops/peak.py`, what the -fmad=false build can reach); in a split
model also the tree control, which every lane of a group repeats.

Supported ATen ops: add, sub, rsub, mul, div, neg, exp, expm1, log, log1p,
sqrt, rsqrt, reciprocal, pow (an exponent that is not constant as exp(e log
a)), tanh, sigmoid, log_sigmoid, abs, sign, sgn, cos, sin, tan, atan, asin,
acos, sinh, cosh, atan2, erf, erfc (Phi traces as erf), lgamma,
special_i0e, special_i1e, digamma, polygamma of order 1 (trigamma),
special_ndtri, minimum, maximum, logaddexp, logsumexp, where, masked_fill,
the six comparisons and logical_and, sum, cumsum, dot, mv, mm, trace,
diagonal, diag_embed, tril, select and slice by constants,
index_put, stack, cat, unbind, split, the in-place forms of these (an
in-place op on a view writes its base), the dense linear algebra of a
static n (Cholesky, triangular solves, cholesky_solve, solve, inverse,
det, slogdet: the section "Small dense linear algebra" below), the ODE ops
of `ops/ode.py` (reverse mode: the section "Adaptive ODE solves"), the
backward ops that autograd emits for these, the constructors of constant
tensors (arange, eye), bool and integer constants, and the shape-only ops;
torch.special.log_ndtr and torch.linalg.det are replaced while a density is
traced (`log_ndtr`, `_Det`). cos, sin, tan, atan, asin, acos, sinh, cosh,
erf, erfc and lgamma are libdevice calls in the kernel; i0e, i1e, digamma,
trigamma, ndtri and log_ndtr are built from the program's own ops (the
section "Special functions" below says why). Any other op raises
NotImplementedError naming the ATen op and the model (the incomplete gamma
functions igamma and igammac, fmod, logit, among others).
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import dataclasses
import hashlib
import heapq
import math
import operator
import os
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch import nn

# The forward adapter's cap on the dimension, as the JAX frontend's
# (`smcnuts_tpu/stan/compiler.py:2856`): D passes of tracing.
MAX_FORWARD_DIM = 128
# The group width of a reverse-mode program where the caller names none, and
# the threads a block of a grouped program's entry. On an H100 (chip_smoke.py
# phase 11; PERF.md) the generated eight schools split over 2 lanes in blocks
# of 64 threads was its fastest split (W = 4 and 8 slower, the tree control
# that every lane repeats outgrowing the split density) and 1.07x the
# straight-line program at 25 x 512 trees x depth 10, but not faster at the
# shape of its own tempered run (25 x 1024 trees, depth 6: even at phi 1,
# 0.87x at phi 0.1): one thread a particle stays the default.
DEFAULT_GROUP = 1
GROUP_BLOCK = 64

_aten = torch.ops.aten


class _RealType(threading.local):
    """The real type of the program being lowered, in this thread: float32
    for every generated model; an ODE right-hand side (`lower_function`) is
    also lowered in float64, its literals rounded, folded and keyed in
    double (`_real`)."""

    dtype, np, pack = torch.float32, np.float32, "<f"


_REAL = _RealType()


@contextlib.contextmanager
def _real(dtype):
    """Lower in `dtype` (float32 or float64) inside the block."""
    if dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"a generated program computes in float32 or float64, "
                                  f"not {dtype}")
    saved = (_REAL.dtype, _REAL.np, _REAL.pack)
    double = dtype == torch.float64
    _REAL.dtype, _REAL.np, _REAL.pack = (
        (dtype, np.float64, "<d") if double else (dtype, np.float32, "<f"))
    try:
        yield
    finally:
        _REAL.dtype, _REAL.np, _REAL.pack = saved


def _rnd(v) -> float:
    """v rounded to the program's real type (float32 unless `_real` says
    otherwise), as torch rounds a scalar operand of a tensor op."""
    with np.errstate(over="ignore"):
        return float(_REAL.np(v))


def _bits(v: float) -> bytes:
    return struct.pack(_REAL.pack, v)


class _Scaled:
    """A lazy value c * base (base a node, c a float32 constant, c != 1):
    `_simplify_call`'s `_Scaled`. It becomes one multiply (or a negation)
    only where a consumer cannot absorb it."""

    __slots__ = ("c", "base")

    def __init__(self, c: float, base: int):
        self.c, self.base = c, base


@dataclasses.dataclass(frozen=True)
class _Grouped:
    """A sum built at group width W (`_Scalars.reduce`): its summand nodes in
    index order, the lane partials and butterfly adds inside it, and the sum
    itself, lane 0's value after the butterfly."""

    W: int
    items: tuple
    inner: frozenset
    root: int


_BINARY = {"add": np.add, "sub": np.subtract, "mul": np.multiply, "div": np.divide}
# The ops whose value is a bool: the six comparisons, and "and" of two
# predicates (autograd's pow backward masks with one).
_CMP = {"lt": operator.lt, "le": operator.le, "gt": operator.gt,
        "ge": operator.ge, "eq": operator.eq, "ne": operator.ne, "and": operator.and_}
# Unary ops of the program and the torch function that folds or runs each.
_UNARY = {
    "neg": torch.neg, "exp": torch.exp, "log": torch.log, "log1p": torch.log1p,
    "expm1": torch.expm1, "sqrt": torch.sqrt, "tanh": torch.tanh,
    "abs": torch.abs, "lgamma": torch.lgamma, "recip": torch.reciprocal,
    "sign": torch.sign, "cos": torch.cos, "sin": torch.sin, "erf": torch.erf,
    "erfc": torch.erfc, "tan": torch.tan, "atan": torch.atan, "asin": torch.asin,
    "acos": torch.acos, "sinh": torch.sinh, "cosh": torch.cosh,
}


def _fold(op, vals):
    """The value of op on constants in the program's real type (a bool for
    a comparison)."""
    real = _REAL.np
    with np.errstate(all="ignore"):
        if op in _BINARY:
            return float(_BINARY[op](real(vals[0]), real(vals[1])))
        if op in _CMP:
            return bool(_CMP[op](vals[0], vals[1]))
        if op == "where":
            return vals[1] if vals[0] else vals[2]
        t = torch.tensor(vals[0], dtype=_REAL.dtype)
        if op == "pow":
            return float(torch.pow(t, vals[1]))
        return float(_UNARY[op](t))


def _skey(v):
    """Structural key of a program value: node ids, float32 literals by
    their bits, lazy coefficients, folded predicates."""
    if type(v) is int:
        return ("n", v)
    if type(v) is float:
        return ("c", _bits(v))
    if type(v) is bool:
        return ("b", v)
    return ("s", _bits(v.c), v.base)


class _Scalars:
    """A straight-line program of scalar float32 (and bool) operations,
    simplified as it is built. ops[i] = (op, *args): an int argument is a
    node id, a float a float32 literal; "x" (coordinate d), "phi" and "data"
    (index into the data block) are the leaves."""

    def __init__(self, plan=None):
        self.ops = []
        self.memo = {}
        self.known = {}  # data node id -> its value
        self.data = []  # the data block
        # The creation context of the nodes built while `ctx` is set: the
        # forward passes set it to (primal node, pass) (`tile_model_from_logp_fwd`).
        self.ctx = None
        self.keys = {}  # node id -> the ctx it was first created in
        # Every sum over an axis (`reduce`): (summands in index order, the
        # sum). `plan` maps a sum's place in that list to the group width W
        # it is built at; the sums it does not name are folded in sequence.
        self.reductions = []
        self.plan = plan or {}
        self.grouped = []  # the sums built at a width: `_Grouped`
        # The value node of a special function built from the program's ops
        # (`_special`) -> (its kind, its argument): forward mode takes the
        # function's own derivative there, not that of the composition.
        self.rules = {}
        # The adaptive ODE solves the program calls (`OdeCall`); a call node
        # is (kind, "c<k>", *inputs), k its place here, and each of its
        # outputs a node ("elem", call node, "<index>").
        self.calls = []

    # -- leaves and nodes ---------------------------------------------------
    def _append(self, op):
        self.ops.append(op)
        if self.ctx is not None:
            self.keys[len(self.ops) - 1] = self.ctx
        return len(self.ops) - 1

    def leaf(self, op, *attrs):
        return self._append((op,) + attrs)

    def datum(self, v) -> int:
        v = _rnd(v)
        key = ("data", _bits(v))
        hit = self.memo.get(key)
        if hit is None:
            self.data.append(v)
            hit = self.leaf("data", len(self.data) - 1)
            self.known[hit] = v
            self.memo[key] = hit
        return hit

    def node(self, op, *args, commutative=False):
        args = tuple(self.mat(a) for a in args)
        if all(type(a) is not int or a in self.known for a in args):
            v = _fold(op, [self.known[a] if type(a) is int else a for a in args])
            from_data = any(type(a) is int for a in args)
            return self.datum(v) if from_data and type(v) is float else v
        if commutative and _skey(args[1]) < _skey(args[0]):
            args = (args[1], args[0])
        key = (op,) + tuple(_skey(a) for a in args)
        hit = self.memo.get(key)
        if hit is None:
            hit = self.memo[key] = self._append((op,) + args)
        return hit

    def mat(self, v):
        """A lazy coefficient made real: one multiply, or a negation."""
        if isinstance(v, _Scaled):
            if v.c == -1.0:
                return self.node("neg", v.base)
            return self.node("mul", v.base, v.c, commutative=True)
        return v

    # -- the algebra of `_simplify_call` ------------------------------------
    @staticmethod
    def scaled(c, base):
        if type(base) is float:
            return _rnd(c * base)
        if isinstance(base, _Scaled):
            return _Scalars.scaled(_rnd(c * base.c), base.base)
        if c == 1.0:
            return base
        return _Scaled(c, base)

    def add(self, a, b):
        fa, fb = type(a) is float, type(b) is float
        if fa and fb:
            return _fold("add", (a, b))
        if fa and a == 0.0:
            return b
        if fb and b == 0.0:
            return a
        sa, sb = isinstance(a, _Scaled), isinstance(b, _Scaled)
        if sa and sb:
            if a.c == b.c:
                return self.scaled(a.c, self.add(a.base, b.base))
            if a.c == -b.c:
                return self.scaled(a.c, self.sub(a.base, b.base))
        if sb and b.c == -1.0:
            return self.sub(a, b.base)
        if sa and a.c == -1.0:
            return self.sub(b, a.base)
        if _skey(a) == _skey(b):
            return self.mul(2.0, a)
        return self.node("add", a, b, commutative=True)

    def sub(self, a, b):
        fa, fb = type(a) is float, type(b) is float
        if fa and fb:
            return _fold("sub", (a, b))
        if fb and b == 0.0:
            return a
        sa, sb = isinstance(a, _Scaled), isinstance(b, _Scaled)
        if sa and sb:
            if a.c == b.c:
                return self.scaled(a.c, self.sub(a.base, b.base))
            if a.c == -b.c:
                return self.scaled(a.c, self.add(a.base, b.base))
        if sb and b.c == -1.0:
            return self.add(a, b.base)
        if sa and a.c == -1.0:
            return self.scaled(-1.0, self.add(a.base, b))
        if fa and a == 0.0:
            return self.mul(-1.0, b)
        if _skey(a) == _skey(b):
            return 0.0
        return self.node("sub", a, b)

    def mul(self, a, b):
        fa, fb = type(a) is float, type(b) is float
        if fa and fb:
            return _fold("mul", (a, b))
        if fa:
            a, b, fb = b, a, True
        if fb:  # b is the literal factor
            if b == 0.0:
                return 0.0
            if b == 1.0:
                return a
            if isinstance(a, _Scaled):
                return self.scaled(_rnd(a.c * b), a.base)
            if type(a) is int and a in self.known:
                return self.node("mul", a, b)
            return _Scaled(b, a)
        sa, sb = isinstance(a, _Scaled), isinstance(b, _Scaled)
        if sa and sb:
            return self.scaled(_rnd(a.c * b.c), self.mul(a.base, b.base))
        if sa:
            return self.scaled(a.c, self.mul(a.base, b))
        if sb:
            return self.scaled(b.c, self.mul(a, b.base))
        return self.node("mul", a, b, commutative=True)

    def div(self, a, b):
        fa, fb = type(a) is float, type(b) is float
        if fa and fb:
            return _fold("div", (a, b))
        if fb and b == 1.0:
            return a
        if fa and a == 0.0:
            return 0.0
        sa, sb = isinstance(a, _Scaled), isinstance(b, _Scaled)
        if sa and sb and a.c == b.c:
            return self.div(a.base, b.base)
        if sb and b.c == -1.0:
            return self.mul(-1.0, self.div(a, b.base))
        if sa and a.c == -1.0:
            return self.mul(-1.0, self.div(a.base, b))
        return self.node("div", a, b)

    def unary(self, op, a):
        if op == "neg":
            return self.mul(-1.0, a)
        if type(a) is float:
            return _fold(op, (a,))
        return self.node(op, a)

    def pow(self, a, e: float):
        """a ** e for a constant e; the exponents ATen's CUDA pow takes
        apart are lowered here, so both sides of the program agree."""
        if e == 1.0:
            return a
        if e == 0.0:
            return 1.0
        if e == 2.0:
            return self.mul(a, a)
        if e == 3.0:
            return self.mul(self.mul(a, a), a)
        if e == 0.5:
            return self.unary("sqrt", a)
        if e == -0.5:
            return self.div(1.0, self.unary("sqrt", a))
        if e == -1.0:
            return self.div(1.0, a)
        if e == -2.0:
            return self.div(1.0, self.mul(a, a))
        if type(a) is float:
            return _fold("pow", (a, e))
        return self.node("pow", a, e)

    def where(self, c, a, b):
        if type(c) is bool:
            return a if c else b
        if _skey(a) == _skey(b):
            return a
        return self.node("where", c, a, b)

    def call(self, desc, inputs, n_out):
        """The outputs of a call of `desc` (an `OdeCall`) on `inputs`: one
        node for the call, one read ("elem") for each of its n_out outputs.
        A call is never folded: it runs on the device even on data alone."""
        inputs = tuple(self.mat(v) for v in inputs)
        key = (desc.kind, id(desc.prog), desc.tol) + tuple(_skey(v) for v in inputs)
        hit = self.memo.get(key)
        if hit is None:
            self.calls.append(desc)
            hit = self.memo[key] = self._append(
                (desc.kind, f"c{len(self.calls) - 1}") + inputs)
        outs = []
        for j in range(n_out):
            k = ("elem", hit, j)
            if k not in self.memo:
                self.memo[k] = self._append(("elem", hit, str(j)))
            outs.append(self.memo[k])
        return outs

    def reduce(self, items):
        """The sum of `items` in index order. Folded in sequence, the adds
        the kernel and its plain version both run; at a group width W that
        the plan names, as W lanes run it: lane l folds items l, l + W, ...
        in that order, then an xor butterfly adds the lane partials, and the
        sum is lane 0's. Those adds are built as they are, unsimplified, so
        the program holds exactly the lanes' operations."""
        k = len(self.reductions)
        W = self.plan.get(k, 1)
        if W == 1:
            acc = items[0] if items else 0.0
            for v in items[1:]:
                acc = self.add(acc, v)
            self.reductions.append((list(items), acc))
            return acc
        items = [self.mat(v) for v in items]
        inner = set()

        def add(a, c):
            v = self.node("add", a, c, commutative=True)
            inner.add(v)
            return v

        lanes = []
        for lane in range(W):
            acc = items[lane]
            for v in items[lane + W::W]:
                acc = add(acc, v)
            lanes.append(acc)
        o = W // 2
        while o:
            lanes = [add(lanes[lane], lanes[lane ^ o]) for lane in range(W)]
            o //= 2
        root = lanes[0]
        inner.discard(root)
        self.reductions.append((items, root))
        self.grouped.append(_Grouped(W, tuple(items), frozenset(inner), root))
        return root


# ---------------------------------------------------------------------------
# Forward mode: the port's own tangent rules over the primal program.
# ---------------------------------------------------------------------------


def _tangent(b: _Scalars, i: int, op: str, args: tuple, tan: dict):
    """The tangent of node i = op(args), or None where it is zero."""
    rule = b.rules.get(i)
    if rule is not None:
        kind, x = rule
        tx = tan.get(x) if type(x) is int else None
        return None if tx is None else b.mul(tx, _SPECIAL_DERIVATIVES[kind](b, x, i))
    if op in ("x", "phi", "data", "sign") or op in _CMP:
        return None
    ts = [tan.get(a) if type(a) is int else None for a in args]
    if all(t is None for t in ts):
        return None
    if op in _CALLS:
        desc = b.calls[int(args[0][1:])]
        raise NotImplementedError(
            f"forward mode through the adaptive ODE solve {desc.prog.name} "
            "(smcnuts::ode_dopri5): its derivative is the continuous adjoint, reverse "
            "mode only, as JAX's odeint has only a custom VJP")
    t = [0.0 if v is None else v for v in ts]
    if op == "add":
        return b.add(t[0], t[1])
    if op == "sub":
        return b.sub(t[0], t[1])
    if op == "mul":
        return b.add(b.mul(t[0], args[1]), b.mul(args[0], t[1]))
    if op == "div":
        return b.div(b.sub(t[0], b.mul(i, t[1])), args[1])
    if op == "neg":
        return b.mul(-1.0, t[0])
    if op == "exp":
        return b.mul(t[0], i)
    if op == "log":
        return b.div(t[0], args[0])
    if op == "log1p":
        return b.div(t[0], b.add(1.0, args[0]))
    if op == "expm1":
        return b.mul(t[0], b.add(i, 1.0))
    if op == "sqrt":
        return b.mul(0.5, b.div(t[0], i))
    if op == "tanh":
        return b.mul(t[0], b.sub(1.0, b.mul(i, i)))
    if op == "abs":
        return b.mul(t[0], b.unary("sign", args[0]))
    if op == "recip":
        return b.mul(-1.0, b.mul(t[0], b.mul(i, i)))
    if op == "pow":
        e = args[1]
        return b.mul(e, b.mul(t[0], b.pow(args[0], _rnd(e - 1.0))))
    if op == "where":
        return b.where(args[0], t[1], t[2])
    if op == "cos":
        return b.mul(-1.0, b.mul(t[0], b.unary("sin", args[0])))
    if op == "sin":
        return b.mul(t[0], b.unary("cos", args[0]))
    if op in ("erf", "erfc"):
        c = _TWO_OVER_SQRT_PI if op == "erf" else -_TWO_OVER_SQRT_PI
        return b.mul(t[0], b.mul(c, b.unary("exp", b.mul(-1.0, b.mul(args[0], args[0])))))
    if op == "lgamma":
        return b.mul(t[0], _digamma(b, args[0]))
    if op == "tan":
        return b.mul(t[0], b.add(1.0, b.mul(i, i)))
    if op == "atan":
        return b.div(t[0], b.add(1.0, b.mul(args[0], args[0])))
    if op in ("asin", "acos"):
        d = b.div(t[0], b.unary("sqrt", b.sub(1.0, b.mul(args[0], args[0]))))
        return d if op == "asin" else b.mul(-1.0, d)
    if op == "sinh":
        return b.mul(t[0], b.unary("cosh", args[0]))
    if op == "cosh":
        return b.mul(t[0], b.unary("sinh", args[0]))
    raise NotImplementedError(f"forward mode through {op} of a parameter: its derivative "
                              "is not written")


# ---------------------------------------------------------------------------
# Special functions as compositions of the program's own ops.
# ---------------------------------------------------------------------------
#
# ATen computes i0e, i1e, digamma, trigamma and ndtri in its own code
# (`ATen/native/Math.h`), which a kernel built with -fmad=false could not
# round alike, so the
# lowering builds each from the program's ops (add, mul, div, sqrt, log,
# where and the comparisons; range splits through `where`), mirroring ATen's
# float code step for step: the kernel and its plain version then compute
# the same ops and agree to the bit by construction, and the CPU tests hold
# the composition to torch.special and JAX. cos, sin, tan, atan, asin,
# acos, sinh, cosh, erf, erfc and lgamma stay single ops, emitted as
# libdevice calls (`_CALL`): on an H100 each equals ATen's CUDA op on every
# float32 of the range the densities use (`libdevice_unary`, chip_smoke.py
# phase `solvers`). log_ndtr is replaced in the traced density itself
# (`_SpecialFunctions`); Phi traces as erf.

_SQRT1_2 = 0.7071067811865476
_TWO_OVER_SQRT_PI = 1.1283791670955126
_LOG_SQRT_2PI = 0.9189385332046728
_INV_SQRT_2PI = 0.3989422804014327
# Terms of log_ndtr's continued fraction below -3.
LOG_NDTR_TERMS = 16
# Chebyshev coefficients of exp(-x) I0(x) on [0, 8] and of exp(-x) sqrt(x)
# I0(x) on [8, inf) (Cephes, as `chebyshev_coefficients_i0e_A/B`).
_I0E_A = (
    -4.41534164647933937950e-18, 3.33079451882223809783e-17, -2.43127984654795469359e-16,
    1.71539128555513303061e-15, -1.16853328779934516808e-14, 7.67618549860493561688e-14,
    -4.85644678311192946090e-13, 2.95505266312963983461e-12, -1.72682629144155570723e-11,
    9.67580903537323691224e-11, -5.18979560163526290666e-10, 2.65982372468238665035e-9,
    -1.30002500998624804212e-8, 6.04699502254191894932e-8, -2.67079385394061173391e-7,
    1.11738753912010371815e-6, -4.41673835845875056359e-6, 1.64484480707288970893e-5,
    -5.75419501008210370398e-5, 1.88502885095841655729e-4, -5.76375574538582365885e-4,
    1.63947561694133579842e-3, -4.32430999505057594430e-3, 1.05464603945949983183e-2,
    -2.37374148058994688156e-2, 4.93052842396707084878e-2, -9.49010970480476444210e-2,
    1.71620901522208775349e-1, -3.04682672343198398683e-1, 6.76795274409476084995e-1)
_I0E_B = (
    -7.23318048787475395456e-18, -4.83050448594418207126e-18, 4.46562142029675999901e-17,
    3.46122286769746109310e-17, -2.82762398051658348494e-16, -3.42548561967721913462e-16,
    1.77256013305652638360e-15, 3.81168066935262242075e-15, -9.55484669882830764870e-15,
    -4.15056934728722208663e-14, 1.54008621752140982691e-14, 3.85277838274214270114e-13,
    7.18012445138366623367e-13, -1.79417853150680611778e-12, -1.32158118404477131188e-11,
    -3.14991652796324136454e-11, 1.18891471078464383424e-11, 4.94060238822496958910e-10,
    3.39623202570838634515e-9, 2.26666899049817806459e-8, 2.04891858946906374183e-7,
    2.89137052083475648297e-6, 6.88975834691682398426e-5, 3.36911647825569408990e-3,
    8.04490411014108831608e-1)
# The same for I1, ATen's float tables (`chebyshev_coefficients_i1e_A/B<float>`).
_I1E_A = (
    9.38153738649577178388e-9, -4.44505912879632808065e-8, 2.00329475355213526229e-7,
    -8.56872026469545474066e-7, 3.47025130813767847674e-6, -1.32731636560394358279e-5,
    4.78156510755005422638e-5, -1.61760815825896745588e-4, 5.12285956168575772895e-4,
    -1.51357245063125314899e-3, 4.15642294431288815669e-3, -1.05640848946261981558e-2,
    2.47264490306265168283e-2, -5.29459812080949914269e-2, 1.02643658689847095384e-1,
    -1.76416518357834055153e-1, 2.52587186443633654823e-1)
_I1E_B = (
    -3.83538038596423702205e-9, -2.63146884688951950684e-8, -2.51223623787020892529e-7,
    -3.88256480887769039346e-6, -1.10588938762623716291e-4, -9.76109749136146840777e-3,
    7.78576235018280120474e-1)
# digamma's asymptotic series and its value at 10 (ATen's float calc_digamma).
_DIGAMMA_A = (
    8.33333333333333333333e-2, -2.10927960927960927961e-2, 7.57575757575757575758e-3,
    -4.16666666666666666667e-3, 3.96825396825396825397e-3, -8.33333333333333333333e-3,
    8.33333333333333333333e-2)
_PSI_10 = 2.25175258906672110764
# i1e's derivative below this |x| is its limit, 1/2 (torch's i1e backward).
_I1E_EPS = 1.1920928955078125e-07


def _chbevl(b, y, coeffs):
    """Cephes' chbevl: the Chebyshev series of `coeffs` at y, Clenshaw's
    recurrence b0 <- y * b1 - b2 + c in ATen's order."""
    b0, b1, b2 = _rnd(coeffs[0]), 0.0, 0.0
    for c in coeffs[1:]:
        b2, b1 = b1, b0
        b0 = b.add(b.sub(b.mul(y, b1), b2), _rnd(c))
    return b.mul(0.5, b.sub(b0, b2))


def _bessel_e(b, x, small_coeffs, large_coeffs, times_x):
    """exp(-|x|) I(|x|) by ATen's two Chebyshev series: on |x| <= 8 at
    |x|/2 - 2 (times |x| for I1), beyond at 32/|x| - 2 over sqrt(|x|)."""
    a = b.unary("abs", x)
    small = _chbevl(b, b.sub(b.mul(0.5, a), 2.0), small_coeffs)
    if times_x:
        small = b.mul(small, a)
    large = b.div(_chbevl(b, b.sub(b.div(32.0, a), 2.0), large_coeffs), b.unary("sqrt", a))
    return b.where(b.node("le", a, 8.0), small, large)


def _i0e(b, x):
    return _bessel_e(b, x, _I0E_A, _I0E_B, False)


def _i1e(b, x):
    out = _bessel_e(b, x, _I1E_A, _I1E_B, True)
    return b.where(b.node("lt", x, 0.0), b.mul(-1.0, out), out)


def _digamma(b, x):
    """ATen's float calc_digamma for x >= 0: the recurrence up to 10 (its
    `while (x < 10)` as ten selected steps, enough for any x > 0), the value
    at 10, else the asymptotic series. x < 0 (ATen's reflection) gives NaN:
    the densities take lgamma of positive shapes."""
    res, z = 0.0, x
    for _ in range(10):
        below = b.node("lt", z, 10.0)
        res = b.where(below, b.sub(res, b.div(1.0, z)), res)
        z = b.where(below, b.add(z, 1.0), z)
    w = b.div(1.0, b.mul(z, z))
    poly = _rnd(_DIGAMMA_A[0])
    for c in _DIGAMMA_A[1:]:
        poly = b.add(b.mul(poly, w), _rnd(c))
    series = b.sub(b.sub(b.add(res, b.unary("log", z)), b.div(0.5, z)), b.mul(w, poly))
    out = b.where(b.node("eq", z, 10.0), b.add(res, _rnd(_PSI_10)), series)
    return b.where(b.node("lt", x, 0.0), math.nan, out)


def _i0e_derivative(b, x, value):
    return b.sub(_i1e(b, x), b.mul(b.unary("sign", x), value))


def _i1e_derivative(b, x, value):
    """torch's i1e backward: i0e(x) - i1e(x) (sign(x) + 1/x), 1/2 near 0."""
    big = b.node("gt", b.unary("abs", x), _I1E_EPS)
    xs = b.where(big, x, _I1E_EPS)
    d = b.sub(_i0e(b, xs), b.mul(value, b.add(b.unary("sign", xs), b.div(1.0, xs))))
    return b.where(big, d, 0.5)


def _trigamma(b, x):
    """ATen's float trigamma (`ATen/native/Math.h`, the jiterator's
    `trigamma_string` on CUDA): below 1/2 the reflection pi^2 / sin^2(pi x)
    and x <- 1 - x, six steps of the recurrence, then the asymptotic series;
    both sides of the reflection computed and one selected."""
    low = b.node("lt", x, 0.5)
    s = b.unary("sin", b.mul(_rnd(math.pi), x))
    pi2 = b.mul(_rnd(math.pi), _rnd(math.pi))
    result = b.where(low, b.mul(-1.0, b.div(pi2, b.mul(s, s))), 0.0)
    z = b.where(low, b.sub(1.0, x), x)
    for _ in range(6):
        result = b.add(result, b.div(1.0, b.mul(z, z)))
        z = b.add(z, 1.0)
    ixx = b.div(1.0, b.mul(z, z))
    inner = b.sub(b.div(1.0, 30.0), b.mul(ixx, b.div(1.0, 42.0)))
    inner = b.sub(b.div(1.0, 6.0), b.mul(ixx, inner))
    series = b.add(b.add(1.0, b.div(1.0, b.mul(2.0, z))), b.mul(ixx, inner))
    result = b.add(result, b.div(series, z))
    return b.where(low, b.mul(-1.0, result), result)


# ndtri's rational approximations (Cephes; ATen's `calc_ndtri`, whose Q
# tables carry the leading 1 explicitly).
_NDTRI_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1, -5.66762857469070293439E1,
             1.39312609387279679503E1, -1.23916583867381258016E0)
_NDTRI_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0, 8.63602421390890590575E1,
             -2.25462687854119370527E2, 2.00260212380060660359E2, -8.20372256168333339912E1,
             1.59056225126211695515E1, -1.18331621121330003142E0)
_NDTRI_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1, 5.71628192246421288162E1,
             4.40805073893200834700E1, 1.46849561928858024014E1, 2.18663306850790267539E0,
             -1.40256079171354495875E-1, -3.50424626827848203418E-2, -8.57456785154685413611E-4)
_NDTRI_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1, 4.13172038254672030440E1,
             1.50425385692907503408E1, 2.50464946208309415979E0, -1.42182922854787788574E-1,
             -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_NDTRI_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0, 3.93881025292474443415E0,
             1.33303460815807542389E0, 2.01485389549179081538E-1, 1.23716634817820021358E-2,
             3.01581553508235416007E-4, 2.65806974686737550832E-6, 6.23974539184983293730E-9)
_NDTRI_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0, 1.37702099489081330271E0,
             2.16236993594496635890E-1, 1.34204006088543189037E-2, 3.28014464682127739104E-4,
             2.89247864745380683936E-6, 6.79019408009981274425E-9)
_EXP_M2 = 0.13533528323661269189
_SQRT_2PI = 2.50662827463100050242


def _polevl(b, x, coeffs):
    """Cephes' polevl: Horner from the first coefficient, `result * x + c`."""
    acc = 0.0
    for c in coeffs:
        acc = b.add(b.mul(acc, x), _rnd(c))
    return acc


def _ndtri(b, y0):
    """ATen's calc_ndtri in float: the central approximation for |y - 1/2|
    <= 1/2 - exp(-2), the tails at z = sqrt(-2 log y) (two ranges split at
    z = 8), -inf at 0, inf at 1, NaN outside [0, 1]. Each branch reads its
    input clamped into its own range, so a branch not taken stays finite."""
    upper = b.node("gt", y0, _rnd(1.0 - _EXP_M2))
    y = b.where(upper, b.sub(1.0, y0), y0)
    central = b.node("gt", y, _rnd(_EXP_M2))
    yc = b.sub(b.where(central, y, 0.5), 0.5)
    y2 = b.mul(yc, yc)
    mid = b.add(yc, b.mul(yc, b.div(b.mul(y2, _polevl(b, y2, _NDTRI_P0)),
                                     _polevl(b, y2, _NDTRI_Q0))))
    mid = b.mul(mid, _rnd(_SQRT_2PI))
    yt = b.where(central, _rnd(_EXP_M2), y)
    x = b.unary("sqrt", b.mul(-2.0, b.unary("log", yt)))
    x0 = b.sub(x, b.div(b.unary("log", x), x))
    z = b.div(1.0, x)
    near = b.div(b.mul(z, _polevl(b, z, _NDTRI_P1)), _polevl(b, z, _NDTRI_Q1))
    far = b.div(b.mul(z, _polevl(b, z, _NDTRI_P2)), _polevl(b, z, _NDTRI_Q2))
    tail = b.sub(x0, b.where(b.node("lt", x, 8.0), near, far))
    tail = b.where(upper, tail, b.mul(-1.0, tail))
    out = b.where(central, mid, tail)
    out = b.where(b.node("eq", y0, 0.0), -math.inf, out)
    out = b.where(b.node("eq", y0, 1.0), math.inf, out)
    bad = b.node("lt", y0, 0.0)
    out = b.where(bad, math.nan, out)
    return b.where(b.node("gt", y0, 1.0), math.nan, out)


def _trigamma_derivative(b, x, value):
    raise NotImplementedError(
        "forward mode through trigamma of a parameter: its derivative, tetragamma, "
        "is not lowered")


def _ndtri_derivative(b, x, value):
    """sqrt(2 pi) exp(ndtri(x)^2 / 2), autograd's formula."""
    return b.mul(_rnd(_SQRT_2PI), b.unary("exp", b.mul(0.5, b.mul(value, value))))


_SPECIAL = {"i0e": _i0e, "i1e": _i1e, "digamma": _digamma, "trigamma": _trigamma,
            "ndtri": _ndtri}
_SPECIAL_DERIVATIVES = {"i0e": _i0e_derivative, "i1e": _i1e_derivative,
                        "digamma": lambda b, x, value: _special(b, "trigamma", x),
                        "trigamma": _trigamma_derivative, "ndtri": _ndtri_derivative}


def _special(b, kind, x):
    """Special function `kind` of x from the program's ops; its value node
    is differentiated in forward mode by the function's own derivative
    (`_Scalars.rules`). In reverse mode autograd's backward is traced: i0e's
    emits i1e and sgn, i1e's i0e, lgamma's digamma, digamma's polygamma(1,
    .), trigamma here, ndtri's exp of its value. They mirror ATen's float
    code, so a float64 program does not lower them."""
    if _REAL.dtype != torch.float32:
        raise NotImplementedError(f"{kind} in a {_REAL.dtype} program: the lowering "
                                  "mirrors ATen's float code only")
    x = b.mat(x)
    v = b.mat(_SPECIAL[kind](b, x))
    if type(x) is int and type(v) is int:
        b.rules[v] = (kind, x)
    return v


class _LogNdtr(torch.autograd.Function):
    """(log Phi(x), its derivative phi(x) / Phi(x)) in torch ops the lowering
    has; the backward multiplies by the derivative, so autograd traces one
    op, not the composition's reverse. On x >= -3, with e = erfc(|x| /
    sqrt 2): log1p(-e / 2) for x >= 0 (ATen's form) and log(e / 2) below,
    where erfc keeps its relative precision; the derivative exp(-x^2/2) /
    (sqrt(2 pi) Phi(x)). Below -3: the continued fraction f = z + 1/(z +
    2/(z + ...)) at z = -x to LOG_NDTR_TERMS terms, Phi / phi = 1 / f (below
    1e-9 of log Phi from z = 3 on): log Phi = -x^2/2 - log sqrt(2 pi) - log
    f, and the derivative f itself. Autograd's formula for
    torch.special.log_ndtr, exp(-(log_ndtr(x) + x^2/2)) / sqrt(2 pi), would
    lose the rounding of x^2/2 there (~1e-4 relative at x = -40 in
    float32). Each segment reads its input clamped into its own range."""

    @staticmethod
    def forward(x):
        low = x < -3.0
        xh = torch.where(low, -3.0, x)
        up = xh >= 0.0
        t = xh * _SQRT1_2
        e = torch.erfc(torch.where(up, t, -t))
        phi_cdf = torch.where(up, 1.0 - 0.5 * e, 0.5 * e)
        high = torch.where(up, torch.log1p(-0.5 * e), torch.log(0.5 * e))
        high_d = torch.exp(-(t * t)) * _INV_SQRT_2PI / phi_cdf
        z = -torch.where(low, x, -3.0)
        f = z
        for k in range(LOG_NDTR_TERMS, 0, -1):
            f = z + k / f
        lower = -0.5 * (z * z) - _LOG_SQRT_2PI - torch.log(f)
        return torch.where(low, lower, high), torch.where(low, f, high_d)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(output[1])

    @staticmethod
    def backward(ctx, g, _):
        return g * ctx.saved_tensors[0]


def log_ndtr(x):
    """log Phi(x) for a traced density: `_LogNdtr`'s value."""
    return _LogNdtr.apply(x)[0]


def trace_fx(fn, *inputs) -> torch.fx.GraphModule:
    """make_fx(fn)(*inputs) with one fake mode for the metadata of every
    node: make_fx builds a FakeTensorMode for each value it records, which
    is half of a long trace's time; the graph is the same."""
    from torch._guards import TracingContext, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    with tracing(TracingContext(FakeTensorMode(allow_fallback_kernels=True))):
        return make_fx(fn)(*inputs)


class _Det(torch.autograd.Function):
    """torch.linalg.det with the backward of a nonsingular matrix, g det
    A^-T (autograd's own also takes an SVD, for singular matrices, which the
    lowering does not have; a singular matrix gets a gradient of inf or
    NaN)."""

    @staticmethod
    def forward(a):
        return torch.linalg.det(a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        a, det = ctx.saved_tensors
        return (g * det)[..., None, None] * torch.linalg.inv(a).mT


class _SpecialFunctions(torch.overrides.TorchFunctionMode):
    """While a density is traced: torch.special.log_ndtr as `log_ndtr`,
    torch.linalg.det as `_Det`."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.special.log_ndtr:
            return log_ndtr(*args)
        if func is torch.linalg.det and not kwargs:
            return _Det.apply(*args)
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# Lowering a make_fx graph of ATen ops to the scalar program.
# ---------------------------------------------------------------------------


def _lit(v):
    """A Python number of the graph as a program literal."""
    return v if type(v) is bool else _rnd(v)


def _const_array(shape, value) -> np.ndarray:
    out = np.empty(tuple(shape), dtype=object)
    out.fill(_lit(value))
    return out


def _arr(v) -> np.ndarray:
    """An env entry as an object array; a Python number of the graph as a
    0-d array of its literal."""
    return v if isinstance(v, np.ndarray) else _const_array((), v)


def _wrap(v) -> np.ndarray:
    """The result of indexing an object array, as an array (indexing down
    to one element returns the element itself)."""
    if isinstance(v, np.ndarray):
        return v
    out = np.empty((), dtype=object)
    out[()] = v
    return out


def _ew(fn, *vals) -> np.ndarray:
    """fn applied element by element, with broadcasting."""
    arrs = [_arr(v) for v in vals]
    shape = np.broadcast_shapes(*(a.shape for a in arrs))
    arrs = np.broadcast_arrays(*arrs)
    out = np.empty(shape, dtype=object)
    for idx in np.ndindex(shape):
        out[idx] = fn(*(a[idx] for a in arrs))
    return out


def _seq_sum(b: _Scalars, items):
    """The sum of items in index order (`_Scalars.reduce`)."""
    return b.reduce(list(items))


def _reduce(b, a, dims, keepdim, fold=_seq_sum):
    """fold(b, items) over `dims` of a (every dim where none is named)."""
    a = _arr(a)
    nd = a.ndim
    dims = sorted({d % nd for d in (range(nd) if not dims else dims)}) if nd else []
    keep = [d for d in range(nd) if d not in dims]
    moved = np.transpose(a, keep + dims)
    flat = moved.reshape(tuple(a.shape[d] for d in keep) + (-1,))
    out = np.empty(flat.shape[:-1], dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = fold(b, list(flat[idx]))
    if keepdim:
        out = out.reshape(tuple(1 if d in dims else a.shape[d] for d in range(nd)))
    return out


def _check_float(dtype, what):
    if dtype is not None and dtype != _REAL.dtype:
        raise NotImplementedError(
            f"{what}: the generated program computes in {_REAL.dtype}, the "
            f"function asks for {dtype}")


def _lower(gm: torch.fx.GraphModule, inputs: list, b: _Scalars, model: str):
    """Evaluate the fx graph on object arrays of program values; returns the
    lowered output (a pytree of arrays)."""
    env = {}
    placeholders = iter(inputs)

    def get(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (list, tuple)):
            return type(a)(get(v) for v in a)
        return a

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = next(placeholders)
            continue
        if node.op == "get_attr":
            t = getattr(gm, node.target).detach().cpu()
            if t.dtype == torch.bool:  # folded predicates
                env[node] = _ew(bool, t.numpy().astype(object))
            elif t.is_floating_point():
                vals = t.double().numpy()
                env[node] = _ew(lambda v: b.datum(float(v)), vals.astype(object))
            elif t.dtype in (torch.int32, torch.int64):  # indices and counts: literals
                env[node] = _ew(float, t.numpy().astype(object))
            else:
                raise NotImplementedError(
                    f"model '{model}': a constant of {t.dtype} in the density")
            continue
        if node.op == "output":
            return get(node.args[0])
        args, kwargs = get(node.args), get(node.kwargs)
        if node.target is operator.getitem:
            env[node] = args[0][args[1]]
            continue
        name = getattr(node.target, "_overloadpacket", None)
        name = getattr(name, "__name__", str(node.target))
        handler = _HANDLERS.get(name)
        if handler is None and name.endswith("_") and name[:-1] in _HANDLERS:
            # An in-place op: the out-of-place result, written into its
            # operand (a view writes its base), or for an op that changes the
            # shape (squeeze_) rebound to the operand's node.
            out = _arr(_HANDLERS[name[:-1]](b, node, *args, **kwargs))
            target = _arr(args[0])
            if out.shape == target.shape and target.flags.writeable:
                target[...] = out
                out = target
            else:
                env[node.args[0]] = out
            env[node] = out
            continue
        if handler is None:
            raise NotImplementedError(
                f"model '{model}': the ATen op {node.target} is not supported "
                "by the generated in-kernel model")
        env[node] = handler(b, node, *args, **kwargs)
    raise AssertionError("the graph has no output")


def _binary(fn):
    def h(b, node, a, c, alpha=1, **kw):
        if kw.get("rounding_mode") is not None:
            raise NotImplementedError(f"{node.target} with rounding_mode")
        if alpha != 1:
            c = _ew(lambda v: b.mul(_rnd(alpha), v), c)
        return _ew(lambda u, v: fn(b, u, v), a, c)
    return h


def _unary(op):
    return lambda b, node, a: _ew(lambda u: b.unary(op, u), a)


def _shape(fn):
    return lambda b, node, a, *args, **kw: fn(_arr(a), *args)


def _ctor(value_of):
    def h(b, node, *args, **kw):
        _check_float(kw.get("dtype"), node.target)
        shape, value = value_of(node, args, kw)
        return _const_array(shape, value)
    return h


def _select(a, dim, index):
    return _wrap(a[(slice(None),) * (dim % a.ndim) + (index,)])


def _slice(a, dim=0, start=None, end=None, step=1):
    return a[(slice(None),) * (dim % a.ndim) + (slice(start, end, step),)]


def _expand(a, shape, implicit=False):
    lead = len(shape) - a.ndim
    return np.broadcast_to(a, tuple(a.shape[i - lead] if s == -1 else s
                                    for i, s in enumerate(shape)))


def _squeeze(a, dim=None):
    if dim is None:
        return np.squeeze(a)
    dims = dim if isinstance(dim, (list, tuple)) else [dim]
    return np.squeeze(a, tuple(d % a.ndim for d in dims if a.shape[d % a.ndim] == 1))


def _place(grad, sizes, key):
    out = _const_array(sizes, 0.0)
    grad = _arr(grad)
    out[key] = grad[()] if grad.ndim == 0 else grad
    return out


def _where(b, node, c, x, y):
    return _ew(lambda cc, u, v: b.where(cc, u, v), c, x, y)


def _to_copy(b, node, a, **kw):
    _check_float(kw.get("dtype"), node.target)
    return _arr(a).copy()


def _matmul(b, node, x, y):
    x, y = _arr(x), _arr(y)
    x2 = x if x.ndim == 2 else x.reshape(1, -1)
    y2 = y if y.ndim == 2 else y.reshape(-1, 1)
    out = np.empty((x2.shape[0], y2.shape[1]), dtype=object)
    for i in range(out.shape[0]):
        for j in range(out.shape[1]):
            out[i, j] = _seq_sum(b, [b.mul(x2[i, k], y2[k, j]) for k in range(x2.shape[1])])
    return out.reshape(tuple(x.shape[:-1]) + tuple(y.shape[1:]))


def _sum(b, node, a, dims=None, keepdim=False, **kw):
    _check_float(kw.get("dtype"), node.target)
    return _reduce(b, a, dims, keepdim)


def _minimum(b, u, v, take_min=True):
    """torch.minimum / maximum of two values: a NaN operand is the result
    (the first one if both are), else the smaller (larger)."""
    pick = b.where(b.node("lt" if take_min else "gt", u, v), u, v)
    return b.where(b.node("ne", u, u), u, b.where(b.node("ne", v, v), v, pick))


def _logaddexp(b, u, v):
    """ATen's `_log_add_exp_helper`: log1p(exp(min - max)) + max (NaN rules
    of torch.minimum / maximum), u itself where both are the same infinity."""
    lo, hi = _minimum(b, u, v), _minimum(b, u, v, take_min=False)
    out = b.add(b.unary("log1p", b.unary("exp", b.sub(lo, hi))), hi)
    finite = b.node("lt", b.unary("abs", lo), math.inf)
    return b.where(b.node("ne", lo, hi), out, b.where(finite, out, u))


def _atan2(b, y, x):
    """atan2 from atan (a libdevice call) and selects: atan(y / x) shifted by
    pi into the left half plane, +-pi/2 on the y axis, 0 at the origin."""
    r = b.unary("atan", b.div(y, x))
    pi = _rnd(math.pi)
    left = b.where(b.node("ge", y, 0.0), b.add(r, pi), b.sub(r, pi))
    axis = b.where(b.node("gt", y, 0.0), _rnd(math.pi / 2),
                   b.where(b.node("lt", y, 0.0), _rnd(-math.pi / 2), 0.0))
    return b.where(b.node("gt", x, 0.0), r, b.where(b.node("lt", x, 0.0), left, axis))


def _pow_tensor(b, a, e):
    """a ** e for an exponent that is not constant: exp(e log a), 1 at e = 0
    (a negative base gives NaN, as torch does for an exponent that is not
    an integer)."""
    if type(e) is float:
        return b.pow(a, e)
    v = b.unary("exp", b.mul(e, b.unary("log", a)))
    return b.where(b.node("eq", e, 0.0), 1.0, v)


def _pow(b, node, a, e):
    if isinstance(e, np.ndarray):
        return _ew(lambda u, v: _pow_tensor(b, u, v), a, e)
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return _ew(lambda v: _pow_tensor(b, _rnd(a), v), e)
    return _ew(lambda u: b.pow(u, _rnd(e)), a)


def _logsumexp(b, node, a, dims, keepdim=False):
    """torch.logsumexp: m the maximum (0 where infinite), log(sum exp(a - m))
    + m, the sum in index order."""
    def lse(b, items):
        m = items[0]
        for v in items[1:]:
            m = _minimum(b, m, v, take_min=False)
        m = b.where(b.node("eq", b.unary("abs", m), math.inf), 0.0, m)
        s = b.reduce([b.unary("exp", b.sub(v, m)) for v in items])
        return b.add(b.unary("log", s), m)

    return _reduce(b, a, dims, keepdim, lse)


def _log_sigmoid_forward(b, node, x):
    """(log sigmoid x, ATen's buffer): min(x, 0) - log1p(exp(-|x|)); the
    buffer is read by the backward only, which recomputes from x."""
    out = _ew(lambda u: b.sub(b.where(b.node("lt", u, 0.0), u, 0.0),
                              b.unary("log1p", b.unary("exp", b.mul(-1.0, b.unary("abs", u))))),
              x)
    return out, _const_array(out.shape, 0.0)


def _log_sigmoid_backward(b, node, g, x, buffer):
    """ATen's formula: g (1 - z / (1 + z)) below 0, g z / (1 + z) above, z =
    exp(-|x|)."""
    def d(u, v):
        z = b.unary("exp", b.mul(-1.0, b.unary("abs", v)))
        q = b.div(z, b.add(1.0, z))
        return b.mul(u, b.where(b.node("lt", v, 0.0), b.sub(1.0, q), q))
    return _ew(d, g, x)


def _special_handler(kind):
    return lambda b, node, a: _ew(lambda u: _special(b, kind, u), a)


def _polygamma(b, node, n, a):
    if n != 1:
        raise NotImplementedError(f"{node.target} of order {n}: only trigamma (order 1) "
                                  "is lowered")
    return _ew(lambda u: _special(b, "trigamma", u), a)


def _logical_and(b):
    def f(u, v):
        if type(u) is bool or type(v) is bool:
            c, other = (u, v) if type(u) is bool else (v, u)
            return other if c else False
        return b.node("and", u, v, commutative=True)
    return f


def _masked_fill(b, node, a, mask, value):
    value = _arr(value)[()] if isinstance(value, np.ndarray) else _lit(value)
    return _ew(lambda u, m: b.where(m, value, u), a, mask)


def _index_of(v) -> int:
    """An index held as a program literal (an integer constant of the
    graph)."""
    if type(v) is int or type(v) is bool or v != int(v):
        raise NotImplementedError("an index that is not a constant of the graph")
    return int(v)


def _index_put(b, node, a, indices, values, accumulate=False):
    out = _arr(a).copy()
    key = tuple(slice(None) if i is None else np.vectorize(_index_of, otypes=[np.int64])(_arr(i))
                for i in indices)
    vals = np.broadcast_to(_arr(values), out[key].shape)
    if accumulate:
        vals = _ew(b.add, out[key], vals)
    out[key] = vals
    return out


def _arange(b, node, *args, **kw):
    start, end, step = (0, args[0], 1) if len(args) == 1 else (
        args + (1,) if len(args) == 2 else args)
    out = np.empty(len(range(int(start), int(end), int(step))), dtype=object)
    out[:] = [float(v) for v in range(int(start), int(end), int(step))]
    return out


def _eye(b, node, n, m=None, **kw):
    _check_float(kw.get("dtype"), node.target)
    out = _const_array((n, n if m is None else m), 0.0)
    for i in range(min(out.shape)):
        out[i, i] = 1.0
    return out


def _diagonal(b, node, a, offset=0, dim1=0, dim2=1):
    d = np.diagonal(_arr(a), offset, dim1, dim2)
    d.flags.writeable = True  # a view: an in-place op on it writes its base
    return d


def _on_diagonal(shape, values, offset, dim1, dim2):
    """Zeros of `shape` with `values` on the diagonal (offset, dim1, dim2)."""
    out = _const_array(shape, 0.0)
    view = np.diagonal(out, offset, dim1 % out.ndim, dim2 % out.ndim)
    view.flags.writeable = True
    view[...] = _arr(values)
    return out


def _diagonal_backward(b, node, g, sizes, offset, dim1, dim2):
    return _on_diagonal(tuple(sizes), g, offset, dim1, dim2)


def _diag_embed(b, node, a, offset=0, dim1=-2, dim2=-1):
    a = _arr(a)
    n = a.shape[-1] + abs(offset)
    return _on_diagonal(a.shape[:-1] + (n, n), a, offset, dim1, dim2)


def _tril(b, node, a, diagonal=0):
    out = _arr(a).copy()
    n, m = out.shape[-2:]
    for i in range(n):
        for j in range(max(0, i + diagonal + 1), m):
            out[..., i, j] = 0.0
    return out


def _split(b, node, a, sizes, dim=0):
    a = _arr(a)
    cuts = np.cumsum(sizes)[:-1]
    return tuple(np.split(a, cuts, axis=dim % a.ndim))


def _cumsum(b, node, a, dim, **kw):
    """The running sums along dim, each from the last in index order (torch
    builds jacfwd's basis offsets with one on some versions)."""
    out = _arr(a).copy()
    moved = np.moveaxis(out, dim % out.ndim, 0)
    for i in range(1, moved.shape[0]):
        moved[i] = _ew(b.add, moved[i - 1], moved[i])
    return out


def _zero_tensor(b, node, size, **kw):
    return _const_array(size, 0.0)


# ---------------------------------------------------------------------------
# Small dense linear algebra at a static n, as scalar ops (the eager path
# keeps ATen's linalg). Each routine works on one (n, n) matrix of program
# values; `_batched` maps it over leading dimensions. Outputs that no lowered
# node may read (an info code, LU factors and pivots) are checked dead.
# ---------------------------------------------------------------------------


def _batched(fn, *mats):
    """fn over the matrices of the leading (batch) dimensions; each output
    (an array, or a 0-d array for a scalar) restacked."""
    mats = [_arr(m) for m in mats]
    lead = np.broadcast_shapes(*(m.shape[:-2] for m in mats))
    mats = [np.broadcast_to(m, lead + m.shape[-2:]) for m in mats]
    outs = None
    for idx in np.ndindex(lead):
        res = fn(*(m[idx] for m in mats))
        res = res if isinstance(res, tuple) else (res,)
        if outs is None:
            outs = [np.empty(lead + _arr(r).shape, dtype=object) for r in res]
        for o, r in zip(outs, res):
            o[idx + (...,)] = _arr(r)
    return outs if len(outs) > 1 else outs[0]


def _check_dead(node, outputs, what):
    """Raise if a node reads output k (in `outputs`) of the multi-output
    `node` (LU factors and pivots, which the program does not form), other
    than `_linalg_check_errors` (a check that raises, which the program
    drops: its factorisations give NaN or inf instead)."""
    for user in node.users:
        if user.target is operator.getitem and user.args[1] in outputs:
            for reader in user.users:
                if "_linalg_check_errors" not in str(reader.target):
                    raise NotImplementedError(
                        f"{node.target}: its {what} output is read by {reader.target}, "
                        "which the generated lowering does not compute")


def _first_failure(b, oks):
    """LAPACK's info: 0 where every predicate of `oks` holds, else 1 + the
    index of the first that does not, as a program value."""
    info = 0.0
    for j in range(len(oks) - 1, -1, -1):
        info = b.where(oks[j], info, float(j + 1))
    return info


def _cholesky(b, a):
    """Cholesky-Banachiewicz, row by row: L[i][j] = (A[i][j] - sum_k<j
    L[i][k] L[j][k]) / L[j][j], the diagonal its square root; and LAPACK's
    info, the first diagonal whose radicand is not positive (a matrix that
    is not positive definite: its root is NaN there)."""
    n = a.shape[0]
    L = _const_array((n, n), 0.0)
    oks = []
    for i in range(n):
        for j in range(i + 1):
            s = a[i, j]
            for k in range(j):
                s = b.sub(s, b.mul(L[i, k], L[j, k]))
            if i == j:
                oks.append(b.node("gt", s, 0.0))
                L[i, j] = b.unary("sqrt", s)
            else:
                L[i, j] = b.div(s, L[j, j])
    return L, np.array(_first_failure(b, oks), dtype=object)


def _linalg_cholesky_ex(b, node, a, upper=False, check_errors=False):
    L, info = _batched(lambda m: _cholesky(b, m), a)
    if upper:
        L = np.swapaxes(L, -1, -2).copy()
    return L, info


def _tri_solve(b, A, B, upper, unit):
    """A X = B for a triangular A: forward (lower) or back (upper)
    substitution, column by column of B, each row's sum in index order."""
    n, m = A.shape[0], B.shape[1]
    X = _const_array((n, m), 0.0)
    rows = range(n - 1, -1, -1) if upper else range(n)
    for c in range(m):
        for i in rows:
            s = B[i, c]
            ks = range(i + 1, n) if upper else range(i)
            for k in ks:
                s = b.sub(s, b.mul(A[i, k], X[k, c]))
            X[i, c] = s if unit else b.div(s, A[i, i])
    return X


def _linalg_solve_triangular(b, node, A, B, upper, left=True, unitriangular=False):
    def solve(a, x):
        if left:
            return _tri_solve(b, a, x, upper, unitriangular)
        return _tri_solve(b, a.T, x.T, not upper, unitriangular).T
    return _batched(solve, A, B)


def _cholesky_solve(b, node, B, L, upper=False):
    def solve(x, l):
        if upper:
            return _tri_solve(b, l, _tri_solve(b, l.T, x, False, False), True, False)
        return _tri_solve(b, l.T, _tri_solve(b, l, x, False, False), True, False)
    return _batched(solve, B, L)


def _lu(b, a, rhs):
    """Gaussian elimination with partial pivoting on A, applied to the
    columns of rhs: at column k the pivot is the first row i >= k of the
    largest |U[i][k]| (LAPACK's choice), found by selects, not branches: the
    row index is carried as a value, and every row is rebuilt by selects on
    it. Returns (U, the rhs eliminated, the pivot index of each column)."""
    n = a.shape[0]
    U, R = a.copy(), rhs.copy()
    pivots = []
    for k in range(n):
        best, p = b.unary("abs", U[k, k]), float(k)
        for i in range(k + 1, n):
            mag = b.unary("abs", U[i, k])
            take = b.node("gt", mag, best)
            best = b.where(take, mag, best)
            p = b.where(take, float(i), p)
        pivots.append(p)
        old_k = list(U[k, k:]) + list(R[k])
        new_k = old_k
        for i in range(k + 1, n):
            row_i = list(U[i, k:]) + list(R[i])
            chosen = b.node("eq", p, float(i))
            new_k = [b.where(chosen, u, v) for u, v in zip(row_i, new_k)]
            row_i = [b.where(chosen, u, v) for u, v in zip(old_k, row_i)]
            U[i, k:], R[i] = row_i[:n - k], row_i[n - k:]
        U[k, k:], R[k] = new_k[:n - k], new_k[n - k:]
        for i in range(k + 1, n):
            f = b.div(U[i, k], U[k, k])
            for j in range(k + 1, n):
                U[i, j] = b.sub(U[i, j], b.mul(f, U[k, j]))
            for c in range(R.shape[1]):
                R[i, c] = b.sub(R[i, c], b.mul(f, R[k, c]))
            U[i, k] = 0.0
    return U, R, pivots


def _lu_solve(b, a, rhs):
    """(the solution of a X = rhs, LAPACK's info: 1 + the first zero pivot,
    else 0)."""
    U, R, _ = _lu(b, a, rhs)
    info = _first_failure(b, [b.node("ne", U[k, k], 0.0) for k in range(a.shape[0])])
    return _tri_solve(b, U, R, True, False), np.array(info, dtype=object)


def _linalg_solve_ex(b, node, A, B, left=True, check_errors=False):
    _check_dead(node, (1, 2), "LU or pivots")
    B = _arr(B)
    vector = B.ndim == 1 or (B.ndim == _arr(A).ndim - 1)

    def solve(a, x):
        if left:
            return _lu_solve(b, a, x)
        X, info = _lu_solve(b, a.T, x.T)
        return X.T, info

    X, info = _batched(solve, A, B[..., None] if vector else B)
    return (X[..., 0] if vector else X), None, None, info


def _linalg_inv_ex(b, node, A, check_errors=False):
    A = _arr(A)
    n = A.shape[-1]
    eye = _const_array((n, n), 0.0)
    for i in range(n):
        eye[i, i] = 1.0
    return _batched(lambda a: _lu_solve(b, a, eye), A)


def _det_parts(b, a):
    """(the swaps' sign, U's diagonal) of the pivoted elimination of a: -1
    for each row swap."""
    U, _, pivots = _lu(b, a, _const_array((a.shape[0], 0), 0.0))
    sign = 1.0
    for k, p in enumerate(pivots):
        sign = b.mul(sign, b.where(b.node("eq", p, float(k)), 1.0, -1.0))
    return sign, [U[k, k] for k in range(a.shape[0])]


def _per_matrix(fn, A):
    """fn(one matrix) -> a tuple of scalars, over the batch dimensions of A."""
    A = _arr(A)
    outs = None
    for idx in np.ndindex(A.shape[:-2]):
        res = fn(A[idx])
        if outs is None:
            outs = [np.empty(A.shape[:-2], dtype=object) for _ in res]
        for o, r in zip(outs, res):
            o[idx] = r
    return outs


def _linalg_slogdet(b, node, A):
    """(sign, log|det|, LU, pivots): the sign the product of the swaps' and
    of U's diagonal signs, log|det| the sum of log|U[k][k]| in index order."""
    _check_dead(node, (2, 3), "LU or pivots")

    def one(a):
        sign, diag = _det_parts(b, a)
        for u in diag:
            sign = b.mul(sign, b.unary("sign", u))
        return sign, b.reduce([b.unary("log", b.unary("abs", u)) for u in diag])

    sign, logabs = _per_matrix(one, A)
    return sign, logabs, None, None


def _linalg_det(b, node, A):
    """(det, LU, pivots): the swaps' sign times U's diagonal, in index
    order."""
    _check_dead(node, (1, 2), "LU or pivots")

    def one(a):
        sign, diag = _det_parts(b, a)
        for u in diag:
            sign = b.mul(sign, u)
        return (sign,)

    det, = _per_matrix(one, A)
    return det, None, None


# ---------------------------------------------------------------------------
# Adaptive ODE solves inside the program: the Stan frontend's ode_rk45 and
# the other adaptive interfaces trace to one node of `ops/ode.py`'s op
# `smcnuts::ode_dopri5` a solve and one of `ode_dopri5_adjoint` an adjoint
# (the reverse-mode backward). Each becomes a call node: in the kernel a
# call of `forward_lane` / `adjoint_lane` of csrc/ode_dopri5.cuh over the
# call site's right-hand side (its float32 `OdeProgram`, the struct that the
# ODE kernel inlines), in the particle's thread; in the plain version
# `ode.dopri5_plain` / `dopri5_adjoint_plain` on the lanes, which the ODE
# kernel equals to the bit.
# ---------------------------------------------------------------------------

_CALLS = ("ode", "ode_adj")


@dataclasses.dataclass(frozen=True, eq=False)
class OdeCall:
    """A solve ("ode": inputs y0 (n), ts (T), a (A); outputs ys (T, n), row
    0 y0) or an adjoint ("ode_adj": inputs ys (T, n), ts (T), g (T, n), a
    (A); outputs y0_bar (n), ts_bar (T), a_bar (A)) of the right-hand side
    `prog` (an `ops/ode.OdeProgram` in float32), at tol = (rtol, atol,
    mxstep)."""

    kind: str
    prog: object
    T: int
    tol: tuple

    @property
    def n_out(self) -> int:
        n, A = self.prog.n, self.prog.n_args
        return self.T * n if self.kind == "ode" else n + self.T + A


def _ode_program(rhs, n, shapes, what):
    """The float32 program of the ODE right-hand side `rhs` (a key of
    ops/ode.py's registry) at these shapes; raises naming the solve where its
    float32 route is the host loop."""
    from . import ode

    if _REAL.dtype != torch.float32:
        raise NotImplementedError(f"{what} in a {_REAL.dtype} program")
    r = ode._entry(rhs)
    route = r.routes.get(torch.float32)
    if route != ode.KERNEL:
        raise NotImplementedError(
            f"{what} of {r.name}: its right-hand side's float32 route is '{route}', "
            "so the solve cannot run in the NUTS kernel")
    prog = r.programs.get(ode._program_key(torch.float32, n, shapes))
    if prog is None:
        raise NotImplementedError(f"{what} of {r.name}: no float32 program at these shapes")
    return prog


def _flat(v):
    """The program values of an entry of an object array, flat (indexing
    down to one element returns the element, a node id or a literal)."""
    return list(_wrap(v).reshape(-1))


def _ode_solve(b, node, rhs, rtol, atol, mxstep, y0, ts, args):
    y0, ts, args = _arr(y0), _arr(ts), [_arr(a) for a in args]
    B, n = y0.shape
    T = ts.shape[1]
    prog = _ode_program(rhs, n, [a.shape[1:] for a in args], node.target)
    desc = OdeCall("ode", prog, T, (float(rtol), float(atol), int(mxstep)))
    out = np.empty((B, T, n), dtype=object)
    for i in range(B):
        vals = b.call(desc, _flat(y0[i]) + _flat(ts[i]) + [v for a in args for v in _flat(a[i])],
                      desc.n_out)
        out[i] = np.array(vals, dtype=object).reshape(T, n)
    return out


def _ode_adjoint(b, node, rhs, rtol, atol, mxstep, ys, ts, g, args):
    ys, ts, g, args = _arr(ys), _arr(ts), _arr(g), [_arr(a) for a in args]
    B, T, n = ys.shape
    prog = _ode_program(rhs, n, [a.shape[1:] for a in args], node.target)
    desc = OdeCall("ode_adj", prog, T, (float(rtol), float(atol), int(mxstep)))
    y0_bar = np.empty((B, n), dtype=object)
    ts_bar = np.empty((B, T), dtype=object)
    bars = [np.empty(a.shape, dtype=object) for a in args]
    for i in range(B):
        vals = b.call(desc, _flat(ys[i]) + _flat(ts[i]) + _flat(g[i])
                      + [v for a in args for v in _flat(a[i])], desc.n_out)
        y0_bar[i], ts_bar[i] = vals[:n], vals[n:n + T]
        o = n + T
        for bar in bars:
            k = int(np.prod(bar.shape[1:], dtype=np.int64))
            bar[i] = np.array(vals[o:o + k], dtype=object).reshape(bar.shape[1:])
            o += k
    return [y0_bar, ts_bar, *bars]


class _OdeCallPlain(nn.Module):
    """The plain version of one call node over lanes: its inputs (P,) tensors
    or literals, stacked, through `ode.dopri5_plain` / `dopri5_adjoint_plain`
    -> (P, n_out)."""

    def __init__(self, desc: OdeCall):
        super().__init__()
        self.desc = desc

    def forward(self, first, *inputs):
        from .ode import dopri5_adjoint_plain, dopri5_plain

        d, prog = self.desc, self.desc.prog
        n, T, P = prog.n, d.T, first.shape[0]
        X = torch.stack([v if isinstance(v, torch.Tensor) else torch.full_like(first, v)
                         for v in inputs], 1)
        if d.kind == "ode":
            y0, ts, a = (X[:, :n].contiguous(), X[:, n:n + T].contiguous(),
                         X[:, n + T:].contiguous())
            return dopri5_plain(prog, y0, ts, a, *d.tol)[0].reshape(P, T * n)
        ys, ts = X[:, :T * n].reshape(P, T, n), X[:, T * n:T * n + T].contiguous()
        g, a = X[:, T * n + T:2 * T * n + T].reshape(P, T, n), X[:, 2 * T * n + T:].contiguous()
        (y0_bar, ts_bar, a_bar), _ = dopri5_adjoint_plain(prog, ys.contiguous(), ts,
                                                          g.contiguous(), a, *d.tol)
        return torch.cat([y0_bar, ts_bar, a_bar], 1)


def _c_call(prog: Program, i: int) -> str:
    """Call node i in the kernel: its inputs gathered into local arrays, then
    `forward_lane` / `adjoint_lane` of csrc/ode_dopri5.cuh writing its
    outputs to c<i>; the lane's RK steps added to `ode_steps` (solves,
    adjoints)."""
    op, tag, *a = prog.ops[i]
    d = prog.calls[int(tag[1:])]
    struct = _ode_struct(d.prog)[0]
    n, A, T = d.prog.n, d.prog.n_args, d.T
    rtol, atol, mxstep = d.tol

    def arr(name, vals):
        body = ", ".join(_ref(v) for v in vals) if vals else "0.0f"
        return f"      const float {name}[{max(len(vals), 1)}] = {{{body}}};"

    tol = f"{_c_literal64(rtol)}, {_c_literal64(atol)}, {mxstep}LL"
    lines = [f"    float c{i}[{d.n_out}];", "    {"]
    if op == "ode":
        lines += [arr("in_y", a[:n]), arr("in_t", a[n:n + T]), arr("in_a", a[n + T:]),
                  f"      ode_steps[0] += smcnuts::ode::forward_lane<{struct}>(in_y, in_t, in_a, "
                  f"c{i}, {T}, {tol});"]
    else:
        lines += [arr("in_y", a[:T * n]), arr("in_t", a[T * n:T * n + T]),
                  arr("in_g", a[T * n + T:2 * T * n + T]), arr("in_a", a[2 * T * n + T:]),
                  f"      ode_steps[1] += smcnuts::ode::adjoint_lane<{struct}>(in_y, in_t, in_g, in_a, "
                  f"c{i}, c{i} + {n}, c{i} + {n + T}, {T}, {tol});"]
    return "\n".join(lines + ["    }"])


def _ode_struct(prog):
    from .ode import ode_struct

    return ode_struct(prog)


_HANDLERS = {
    "add": _binary(_Scalars.add), "sub": _binary(_Scalars.sub),
    "rsub": _binary(lambda b, u, v: b.sub(v, u)),
    "mul": _binary(_Scalars.mul), "div": _binary(_Scalars.div),
    **{op: _unary(op) for op in ("neg", "exp", "log", "log1p", "expm1", "sqrt",
                                 "tanh", "abs", "lgamma", "sign", "cos", "sin",
                                 "erf", "erfc", "tan", "atan", "asin", "acos", "sinh",
                                 "cosh")},
    "atan2": _binary(_atan2),
    "minimum": _binary(_minimum),
    "maximum": _binary(lambda b, u, v: _minimum(b, u, v, take_min=False)),
    "logaddexp": _binary(_logaddexp),
    "logsumexp": _logsumexp,
    "log_sigmoid_forward": _log_sigmoid_forward,
    "log_sigmoid_backward": _log_sigmoid_backward,
    "special_ndtri": _special_handler("ndtri"),
    "polygamma": _polygamma,
    "masked_fill": _masked_fill,
    "fill": lambda b, node, a, v: _ew(lambda u, w: w, a, v),
    "index_put": _index_put,
    "arange": _arange,
    "eye": _eye,
    "diagonal": _diagonal,
    "diagonal_backward": _diagonal_backward,
    "diag_embed": _diag_embed,
    "trace": lambda b, node, a: _wrap(_seq_sum(b, list(np.diagonal(_arr(a))))),
    "tril": _tril,
    "split_with_sizes": _split,
    "cumsum": _cumsum,
    "_local_scalar_dense": lambda b, node, a: _arr(a)[()],
    "_efficientzerotensor": _zero_tensor,
    "linalg_cholesky_ex": _linalg_cholesky_ex,
    "_linalg_check_errors": lambda b, node, *a, **kw: None,
    "linalg_solve_triangular": _linalg_solve_triangular,
    "cholesky_solve": _cholesky_solve,
    "_linalg_solve_ex": _linalg_solve_ex,
    "linalg_inv_ex": _linalg_inv_ex,
    "_linalg_slogdet": _linalg_slogdet,
    "_linalg_det": _linalg_det,
    "ode_dopri5": _ode_solve,
    "ode_dopri5_adjoint": _ode_adjoint,
    "sgn": _unary("sign"),
    "reciprocal": _unary("recip"),
    **{name: _special_handler(kind)
       for name, kind in (("special_i0e", "i0e"), ("special_i1e", "i1e"),
                          ("digamma", "digamma"))},
    "rsqrt": lambda b, node, a: _ew(lambda u: b.div(1.0, b.unary("sqrt", u)), a),
    "sigmoid": lambda b, node, a: _ew(
        lambda u: b.div(1.0, b.add(1.0, b.unary("exp", b.mul(-1.0, u)))), a),
    "sigmoid_backward": lambda b, node, g, y: _ew(
        lambda u, v: b.mul(b.mul(u, b.sub(1.0, v)), v), g, y),
    "tanh_backward": lambda b, node, g, y: _ew(
        lambda u, v: b.mul(u, b.sub(1.0, b.mul(v, v))), g, y),
    "pow": _pow, "where": _where,
    **{op: (lambda op: lambda b, node, u, v: _ew(lambda p, q: b.node(op, p, q), u, v))(op)
       for op in _CMP if op != "and"},
    "logical_and": lambda b, node, u, v: _ew(_logical_and(b), u, v),
    "sum": _sum,
    "dot": _matmul, "mv": _matmul, "mm": _matmul,
    **{op: _shape(lambda a, *r: a) for op in ("alias", "detach", "contiguous")},
    # Copies: an in-place op on the copy must not write the original.
    **{op: _shape(lambda a, *r: a.copy()) for op in ("clone", "lift_fresh_copy")},
    "_to_copy": _to_copy,
    **{op: _shape(lambda a, shape: a.reshape(tuple(shape)))
       for op in ("view", "_unsafe_view", "reshape")},
    "expand": _shape(_expand),
    "unsqueeze": _shape(lambda a, dim: np.expand_dims(a, dim % (a.ndim + 1))),
    "squeeze": _shape(_squeeze),
    "permute": _shape(lambda a, dims: np.transpose(a, dims)),
    "t": _shape(lambda a: a.T),
    "transpose": _shape(lambda a, d0, d1: np.swapaxes(a, d0, d1)),
    "select": _shape(_select),
    "slice": _shape(_slice),
    "unbind": _shape(lambda a, dim=0: tuple(_wrap(t) for t in np.moveaxis(a, dim, 0))),
    "select_backward": lambda b, node, g, sizes, dim, index: _place(
        g, sizes, (slice(None),) * dim + (index,)),
    "slice_backward": lambda b, node, g, sizes, dim, start, end, step: _place(
        g, sizes, (slice(None),) * dim + (slice(start, end, step),)),
    "stack": lambda b, node, ts, dim=0: np.stack([_arr(t) for t in ts], dim),
    "cat": lambda b, node, ts, dim=0: np.concatenate([_arr(t) for t in ts], dim),
    "zeros_like": _ctor(lambda n, a, kw: (_arr(a[0]).shape, 0.0)),
    "ones_like": _ctor(lambda n, a, kw: (_arr(a[0]).shape, 1.0)),
    "full_like": _ctor(lambda n, a, kw: (_arr(a[0]).shape, a[1])),
    "new_zeros": _ctor(lambda n, a, kw: (a[1], 0.0)),
    "new_ones": _ctor(lambda n, a, kw: (a[1], 1.0)),
    "new_full": _ctor(lambda n, a, kw: (a[1], a[2])),
    "zeros": _ctor(lambda n, a, kw: (a[0], 0.0)),
    "ones": _ctor(lambda n, a, kw: (a[0], 1.0)),
    "full": _ctor(lambda n, a, kw: (a[0], a[1])),
    "scalar_tensor": _ctor(lambda n, a, kw: ((), a[0])),
}


# ---------------------------------------------------------------------------
# The program: dead code removed, renumbered, as fx and as CUDA.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Program:
    """ops[i] = (op, *args), args node indices (< i) or float32 literals;
    `logp` and `grad` are node indices or literals; `data` the data block."""

    ops: tuple
    logp: object
    grad: tuple
    data: tuple
    dim: int
    # A program split over a group of W lanes (`_group_program`): its loops
    # (`Loop`) and the order in which its straight-line nodes ("v", i) and
    # loops ("loop", k) are emitted. W = 1: none, every node in order.
    group: int = 1
    loops: tuple = ()
    schedule: tuple = ()
    # A forward program's recurrences emitted as loops over their steps
    # (`_reroll`, `Recurrence`), in program order; the other ops straight-line.
    recurrences: tuple = ()
    # The ODE solves its call nodes run (`OdeCall`), by the k of their tag.
    calls: tuple = ()


@dataclasses.dataclass(frozen=True)
class Loop:
    """The sums of n summands whose summand cones are one body, emitted once
    inside a loop over a lane's summands i = lane + k W. `ops[t]` is
    (op, refs), a template op evaluated at index i; a ref is ("u", v) a node
    computed before the loop or a literal, ("x", a) the coordinate x[a + i],
    ("col", o) entry o + i of the data block (a column of the data table)
    or ("t", t) template op t. `sums[r]` is (the summand's ref, the node of
    the sum); `exports[e]` is (template op t, ((i, node), ...)): the program
    nodes of op t that are read after the loop, broadcast from the lane that
    owns index i."""

    n: int
    ops: tuple
    sums: tuple
    exports: tuple


def _live(b: _Scalars, outs) -> set:
    """The nodes the outputs read, transitively."""
    live = set()
    stack = [o for o in outs if type(o) is int]
    while stack:
        i = stack.pop()
        if i in live:
            continue
        live.add(i)
        op, *args = b.ops[i]
        if op not in ("x", "phi", "data"):
            stack += [a for a in args if type(a) is int]
    return live


def _finish(b: _Scalars, logp, grads, dim, order="built") -> Program:
    """The program of the outputs: their live nodes, renumbered in emission
    order, "built" (the order the nodes were made in) or "primal" (a forward
    program's (primal node, pass) order, `_primal_order`)."""
    return _finish_map(b, logp, grads, dim, order)[0]


def _finish_map(b: _Scalars, logp, grads, dim, order="built"):
    """`_finish`, and the map from the builder's node ids to the program's."""
    ops, ren, data, new = _renumber(b, [logp] + list(grads), order)
    return Program(ops, ren[0], tuple(ren[1:]), data, dim, calls=tuple(b.calls)), new


def _renumber(b: _Scalars, outs, order="built"):
    """The live nodes of `outs` renumbered in emission order: (ops, the
    outputs renumbered, the data block, the map from the `_Scalars` node
    ids)."""
    outs = [b.mat(o) for o in outs]
    live = _live(b, outs)
    order = _order(b.ops, live) if order == "built" else _primal_order(b.ops, live, b.keys)
    new = {old: k for k, old in enumerate(order)}
    data_ids = sorted(i for i in order if b.ops[i][0] == "data")
    data_new = {b.ops[i][1]: k for k, i in enumerate(data_ids)}
    ops = []
    for i in order:
        op, *args = b.ops[i]
        if op == "data":
            ops.append(("data", data_new[args[0]]))
        elif op in ("x", "phi"):
            ops.append((op, *args))
        else:
            ops.append((op, *(new[a] if type(a) is int else a for a in args)))
    ren = [new[o] if type(o) is int else o for o in outs]
    data = tuple(b.data[b.ops[i][1]] for i in data_ids)
    return tuple(ops), ren, data, new


def _order(ops, live) -> list:
    """The emission order of the live nodes: the order they were built in.

    The JAX package also sorts by dataflow depth (`_schedule_call`), for
    Mosaic's bounded scheduling window; ptxas schedules the whole function,
    and on an H100 the depth-sorted arma program ran within 1% of this order
    (0.479 against 0.484 ms at 25 x 512 x depth 10, PERF.md), so it is not
    ported."""
    return sorted(live)


def _primal_order(ops, live, keys) -> list:
    """The emission order of a forward program's live nodes: a topological
    order (Kahn's algorithm) that takes the smallest key first, ties by
    creation. A primal node i has the key (i, -1); a node that tangent pass d
    created while it differentiated primal node i, (i, d) (`_Scalars.keys`).
    So step t of a recurrence is followed by its tangents and their sum terms,
    and a primal value dies with its last pass instead of living until the
    last pass reaches it: the arma density at T=200 holds 22 values at once
    instead of 214 in the built order (`peak_live`). On an H100 that took the
    kernel from 255 registers and 356 bytes spilled to 122 and none, and
    moved its time by under 1% (chip_smoke.py phase 11; PERF.md)."""
    users = {i: [] for i in live}
    waiting = {}
    for i in live:
        op, *args = ops[i]
        deps = () if op in ("x", "phi", "data") else {a for a in args if type(a) is int}
        waiting[i] = len(deps)
        for a in deps:
            users[a].append(i)
    ready = [(keys.get(i, (i, -1)), i) for i in live if waiting[i] == 0]
    heapq.heapify(ready)
    out = []
    while ready:
        _, i = heapq.heappop(ready)
        out.append(i)
        for u in users[i]:
            waiting[u] -= 1
            if waiting[u] == 0:
                heapq.heappush(ready, (keys.get(u, (u, -1)), u))
    return out


def peak_live(prog: Program) -> int:
    """The most values live at once in the program's emission order: after
    op t, the values defined up to t that an op after t reads or that are
    outputs (logp and the gradient, read at the end). What the kernel's
    registers must hold, before ptxas reorders anything."""
    n = len(prog.ops)
    last = list(range(n))
    for t, (op, *args) in enumerate(prog.ops):
        if op not in ("x", "phi", "data"):
            for a in args:
                if type(a) is int:
                    last[a] = t
    for o in (prog.logp, *prog.grad):
        if type(o) is int:
            last[o] = n
    ends = [0] * (n + 1)  # ends[t]: values whose last read is op t
    for i in range(n):
        ends[last[i]] += 1
    peak = live = 0
    for t in range(n):
        live += 1 - ends[t]
        peak = max(peak, live)
    return peak


# ---------------------------------------------------------------------------
# Sums split over a group of lanes: the re-roll pass.
# ---------------------------------------------------------------------------


class _NoMatch(Exception):
    """The summand cones are not one body."""


class _NoSplit(Exception):
    """Why a program cannot be split over a group of lanes."""


class _Body:
    """The template of the summand cones of sums of n summands, built by
    matching a tuple of n program values (one a summand index) at a time:
    `match` returns a ref (`Loop`): ("u", v) where every index has the same
    value, ("x", a) where index i reads x[a + i], ("col", c) where each reads
    a datum (column c of the data table; two indices may read one datum) or
    a literal of its own, ("t", t) where every index runs the same op on
    operands that match in turn. Anything else raises `_NoMatch`. Matching is
    memoised by the tuple, so the template is a DAG and the cones of several
    sums that share nodes at the same index share template ops."""

    def __init__(self, b: _Scalars, n: int):
        self.b, self.n = b, n
        self.memo = {}
        self.ops = []  # (op, refs)
        self.members = []  # the n program nodes of each template op
        self.columns = []  # n float32 values each
        self._columns = {}
        self._shapes = []

    def _view(self, v):
        """(op, *args) of a node, or of a lazy coefficient as `mat` makes it real."""
        if isinstance(v, _Scaled):
            return ("neg", v.base) if v.c == -1.0 else ("mul", v.c, v.base)
        return self.b.ops[v]

    def _shape(self, v):
        """A hash of the op tree below v with leaves by kind: what decides
        which operand of an add or multiply is which, index by index."""
        if type(v) is not int:
            return hash(("c",)) if type(v) is float else hash(("b", v))
        for i in range(len(self._shapes), v + 1):
            op, *args = self.b.ops[i]
            if op in ("x", "phi", "data"):
                self._shapes.append(hash((op,)))
                continue
            subs = [self._shape(a) for a in args]
            if op in ("add", "mul"):
                subs.sort()
            self._shapes.append(hash((op, *subs)))
        return self._shapes[v]

    def _column(self, values):
        key = tuple(_bits(v) for v in values)
        if key not in self._columns:
            self._columns[key] = len(self.columns)
            self.columns.append(tuple(values))
        return ("col", self._columns[key])

    def absorb(self, vals: tuple, avoid: set) -> bool:
        """Match `vals` into the body as a template op whose shared operands
        read none of `avoid` (what the loop itself provides), or leave the
        body as it was and return False."""
        state = (dict(self.memo), dict(self._columns), len(self.ops), len(self.columns))
        try:
            ok = self.match(vals)[0] == "t"
        except _NoMatch:
            ok = False
        shared = [r[1] for _, refs in self.ops[state[2]:] for r in refs
                  if r[0] == "u" and type(r[1]) is int]
        seen = set()
        while ok and shared:
            v = shared.pop()
            if v in seen:
                continue
            seen.add(v)
            ok = v not in avoid
            op, *args = self.b.ops[v]
            if op not in ("x", "phi", "data"):
                shared += [a for a in args if type(a) is int]
        if not ok:
            self.memo, self._columns = state[0], state[1]
            del self.ops[state[2]:], self.members[state[2]:], self.columns[state[3]:]
        return ok

    def match(self, vals: tuple):
        key = tuple(_skey(v) for v in vals)
        hit = self.memo.get(key)
        if hit is None:
            hit = self.memo[key] = self._match(vals, key)
        return hit

    def _match(self, vals, key):
        if all(k == key[0] for k in key):
            return ("u", vals[0])
        kinds = {type(v) for v in vals}
        if kinds == {float}:
            return self._column(vals)
        if float in kinds or bool in kinds:
            raise _NoMatch
        views = [self._view(v) for v in vals]
        op = views[0][0]
        if any(w[0] != op or len(w) != len(views[0]) for w in views) or op == "phi":
            raise _NoMatch
        if op == "x":
            if any(w[1] != views[0][1] + i for i, w in enumerate(views)):
                raise _NoMatch
            return ("x", views[0][1])
        if op == "data":
            return self._column([self.b.data[w[1]] for w in views])
        args = [w[1:] for w in views]
        if op in ("add", "mul"):
            # Commutative: each index's operands in the order of index 0's.
            first = (self._shape(args[0][0]), self._shape(args[0][1]))
            for i, (a, c) in enumerate(args):
                shapes = (self._shape(a), self._shape(c))
                if shapes != first:
                    if shapes[::-1] != first:
                        raise _NoMatch
                    args[i] = (c, a)
        refs = tuple(self.match(tuple(a[p] for a in args)) for p in range(len(args[0])))
        self.ops.append((op, refs))
        self.members.append(tuple(vals))
        return ("t", len(self.ops) - 1)


@contextlib.contextmanager
def _deep_matching():
    """Room for `_Body.match`, which recurses once an op down a cone (a long
    recurrence's cones are as deep as the recurrence is long)."""
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 20000))
    try:
        yield
    finally:
        sys.setrecursionlimit(limit)


def _rerollable(b: _Scalars, items) -> bool:
    """Whether the summands' cones are one body: the same ops in the same
    shape, reading x[a + i], data and literals of their own and values that
    every summand shares."""
    if len(items) < 2:
        return False
    try:
        with _deep_matching():
            return _Body(b, len(items)).match(tuple(items))[0] in ("t", "x")
    except (_NoMatch, RecursionError):
        return False


def _is_live(v, live) -> bool:
    base = v.base if isinstance(v, _Scaled) else v
    return type(base) is int and base in live


def _choose_group(b: _Scalars, outs, W):
    """The plan of a program built as `b` (the sums folded in sequence) at
    group width W > 1: every live sum of W summands or more, each to be
    built at W. Raises `_NoSplit` where no sum is that long or the summand
    cones of one that long are not one body."""
    live = _live(b, outs)
    long_sums = [k for k, (items, total) in enumerate(b.reductions)
                 if _is_live(total, live) and len(items) >= W]
    if not long_sums:
        raise _NoSplit(f"no sum of {W} summands or more")
    for k in long_sums:
        items, total = b.reductions[k]
        if not _rerollable(b, items):
            raise _NoSplit(f"the summands of sum {k} ({len(items)} summands, node "
                           f"{total}) are not one body")
    return dict.fromkeys(long_sums, W)


def _group_program(b: _Scalars, logp, grads, dim, W):
    """The program of a builder whose planned sums were built at group width
    W, with its loops and emission order; raises `_NoSplit` where the split
    does not hold (a sum's cones are not one body here, a value inside a
    sum's adds is read elsewhere, a loop would need its own results first).

    Sums of equal length whose summands read no other such sum's result form
    one loop; a sum that reads another's result runs in a later loop. A
    program node of a loop body that anything after the loop reads (an
    output such as grad[2 + j], or a straight-line node) is exported: the
    lane that owns its index keeps it, and a shuffle broadcasts it."""
    outs = [b.mat(logp)] + [b.mat(g) for g in grads]
    live = _live(b, outs)
    sums = list({g.root: g for g in b.grouped if g.root in live}.values())
    if not sums:
        raise _NoSplit("no split sum is live")
    root_of = {g.root: g for g in sums}
    inner = set().union(*(g.inner for g in sums))

    def reads(g):
        """The other sums whose results g's summands read."""
        seen, stack, out = set(), list(g.items), set()
        while stack:
            v = stack.pop()
            if v in seen:
                continue
            seen.add(v)
            if v in root_of and v != g.root:
                out.add(v)
            op, *args = b.ops[v]
            if op not in ("x", "phi", "data"):
                stack += [a for a in args if type(a) is int]
        return out

    deps = {g.root: reads(g) for g in sums}
    layer = {}

    def layer_of(r):
        if r not in layer:
            layer[r] = 1 + max((layer_of(d) for d in deps[r]), default=-1)
        return layer[r]

    groups = {}
    for g in sums:
        groups.setdefault((layer_of(g.root), len(g.items)), []).append(g)
    bodies = []
    try:
        with _deep_matching():
            for key in sorted(groups):
                n, body = key[1], _Body(b, key[1])
                refs = [body.match(g.items) for g in groups[key]]
                if any(r[0] not in ("t", "x") for r in refs):
                    raise _NoMatch
                # The gradient of a vector the body reads as x[a + i] (such as
                # grad[2 + j] of eight schools) joins the body where its cones
                # are one body too and read nothing the loop provides.
                avoid = {g.root for g in groups[key]}.union(*body.members)
                bases = {r[1] for _, rs in body.ops for r in rs if r[0] == "x"}
                for a in sorted(bases | {r[1] for r in refs if r[0] == "x"}):
                    if a + n <= dim:
                        body.absorb(tuple(outs[1 + a + i] for i in range(n)), avoid)
                bodies.append((body, groups[key], refs))
    except (_NoMatch, RecursionError):
        raise _NoSplit(f"the sums of {n} summands are not one body together") from None

    loop_of = {g.root: li for li, (_, gs, _) in enumerate(bodies) for g in gs}
    body_of = {}
    for li, (body, _, _) in enumerate(bodies):
        for t, nodes in enumerate(body.members):
            for i, v in enumerate(nodes):
                body_of.setdefault(v, (li, t, i))

    # What runs outside the loops: every node the outputs and the loops'
    # shared operands read, but what a loop provides (its sums and exports).
    # A loop keeps the sums and template ops that something after it reads.
    sum_ref = {g.root: r for _, gs, refs in bodies for g, r in zip(gs, refs)}
    straight, exports, seen, kept = set(), {}, set(), set()
    reached = [set() for _ in bodies]
    stack = [o for o in outs if type(o) is int]

    def reach(li, ref):
        todo = [ref[1]] if ref[0] == "t" else []
        while todo:
            t = todo.pop()
            if t not in reached[li]:
                reached[li].add(t)
                for r in bodies[li][0].ops[t][1]:
                    if r[0] == "t":
                        todo.append(r[1])
                    elif r[0] == "u" and type(r[1]) is int:
                        stack.append(r[1])

    while stack:
        v = stack.pop()
        if v in seen:
            continue
        seen.add(v)
        op, *args = b.ops[v]
        if v in root_of:
            kept.add(v)
            reach(loop_of[v], sum_ref[v])
        elif v in inner:
            raise _NoSplit(f"node {v}, a partial sum of a split sum, is read elsewhere")
        elif v in body_of:
            li, t, i = body_of[v]
            if bodies[li][0].ops[t][0] in _CMP:
                raise _NoSplit(f"node {v}, a comparison in a loop body, is read after "
                               f"the loop")
            exports.setdefault(li, {}).setdefault(t, {})[i] = v
            reach(li, ("t", t))
        else:
            straight.add(v)
            if op not in ("x", "phi", "data"):
                stack += [a for a in args if type(a) is int]
    needed = {loop_of[v] for v in kept} | set(exports)

    # Emission order: Kahn's algorithm over straight-line nodes and loops,
    # the smallest builder id first (a loop by its first summand).
    def provider(v):
        if v in straight:
            return ("v", v)
        return ("loop", loop_of[v] if v in root_of else body_of[v][0])

    units = [("v", v) for v in straight] + [("loop", li) for li in needed]
    waits = {}
    for u in units:
        if u[0] == "v":
            op, *args = b.ops[u[1]]
            reads_ = [a for a in args if type(a) is int] if op not in ("x", "phi", "data") else []
        else:
            ops = bodies[u[1]][0].ops
            reads_ = [r[1] for t in reached[u[1]] for r in ops[t][1]
                      if r[0] == "u" and type(r[1]) is int]
        providers = {provider(a) for a in reads_}
        if u in providers:
            raise _NoSplit(f"loop {u[1]} reads its own results")
        waits[u] = providers
    users = {u: [] for u in units}
    for u, ws in waits.items():
        for w in ws:
            users[w].append(u)

    def key(u):
        return u[1] if u[0] == "v" else min(g.items[0] for g in bodies[u[1]][1])

    count = {u: len(ws) for u, ws in waits.items()}
    ready = [(key(u), u) for u in units if count[u] == 0]
    heapq.heapify(ready)
    schedule = []
    while ready:
        _, u = heapq.heappop(ready)
        schedule.append(u)
        for w in users[u]:
            count[w] -= 1
            if count[w] == 0:
                heapq.heappush(ready, (key(w), w))
    if len(schedule) != len(units):
        raise _NoSplit("the loops and the straight-line nodes read each other in a cycle")

    prog, new = _finish_map(b, logp, grads, dim)
    data, loops, index = list(prog.data), [], {}
    for kind, li in schedule:
        if kind != "loop":
            continue
        index[li] = len(loops)
        body, gs, refs = bodies[li]
        order = sorted(reached[li])  # the kept template ops, in template order
        renum = {t: k for k, t in enumerate(order)}
        offsets = {}

        def ren(r):
            if r[0] == "u" and type(r[1]) is int:
                return ("u", new[r[1]])
            if r[0] == "col":
                if r[1] not in offsets:
                    offsets[r[1]] = len(data)
                    data.extend(body.columns[r[1]])
                return ("col", offsets[r[1]])
            return ("t", renum[r[1]]) if r[0] == "t" else r

        ops = tuple((body.ops[t][0], tuple(ren(r) for r in body.ops[t][1])) for t in order)
        loops.append(Loop(
            n=body.n, ops=ops,
            sums=tuple((ren(r), new[g.root]) for g, r in zip(gs, refs) if g.root in kept),
            exports=tuple((renum[t], tuple((i, new[v]) for i, v in sorted(ex.items())))
                          for t, ex in sorted(exports.get(li, {}).items()))))
    sched = tuple(("v", new[u[1]]) if u[0] == "v" else ("loop", index[u[1]]) for u in schedule)
    return dataclasses.replace(prog, data=tuple(data), group=W, loops=tuple(loops),
                               schedule=sched)


# ---------------------------------------------------------------------------
# Forward-mode recurrences emitted as loops: the carried re-roll pass.
# ---------------------------------------------------------------------------

# A run of steps becomes a loop where it has this many steps and operations,
# and its kinds of step (each emitted once) at most half its operations.
REROLL_MIN_STEPS = 8
REROLL_MIN_OPS = 128
REROLL_MAX_KINDS = 8
REROLL_MAX_SLOTS = 512
# The data block with the loops' columns stays within this many floats (a
# block's 48 KB of shared memory without an opt-in, `ops/nuts_cuda.py`,
# with room to spare); a program that would need more stays straight-line.
REROLL_MAX_DATA = 8192
# The unroll factor nvcc is given for a loop (`#pragma unroll`): the largest
# power of two up to 8 whose unrolled body holds at most REROLL_UNROLL_OPS
# template ops, so the code grows with the step's code, not with the
# recurrence. On an H100 at 25 x 512 trees x depth 10 (a few warps an SM, a
# step's latency exposed at unroll 1) the generated arma ran 1.81x its
# straight line at 8 (0.97x at 1), the Stan T=200 recurrence 1.27x at 8,
# irt_ar (four kinds of step, 202 template ops) 1.41x at 2 and 1.14x at 8
# (experiments/generated_loop_unroll_torch.py; PERF.md). An int here forces
# the factor, as that script does.
REROLL_UNROLL = None
REROLL_UNROLL_OPS = 512
_LEAVES = ("x", "phi", "data")


@dataclasses.dataclass(frozen=True)
class Register:
    """A value that a recurrence's steps carry: one slot (`index` -1), or an
    array of slots of which step k reads and writes slot d[index + k] (an
    accumulator that the data index, such as the gradient of b[item[t]], or
    a gather of values made before the loop). `init[s]` is slot s's value
    before the loop (a node id, or None), `writes` the (kind, template op)
    pairs that assign it at the end of a step. `alias` = (recurrence,
    array): the slots are that earlier recurrence's export array, read
    only."""

    writes: tuple
    init: tuple
    index: int = -1
    alias: tuple = ()


@dataclasses.dataclass(frozen=True)
class Recurrence:
    """Program ops bounds[0] .. bounds[-1] - 1 emitted as one loop over
    n = len(bounds) - 1 steps, step k the ops bounds[k] .. bounds[k + 1] - 1:
    an emission plan, the program keeps every op. Step k is of kind
    kinds[k] (read from the data block's column at `kind`, -1 where there is
    one kind), and `classes[c]` is kind c's template, (op, refs) a step's
    ops in order. A ref is ("t", j) the step's template op j, ("u", v) a
    node computed before the loop or a literal, ("col", o) entry o + k of the
    data block (a literal, datum, slot index or kind of the step's own) or
    ("r", R) register R (`Register`). `arrays[a]` holds ((kind, template
    op), ...): the values a step of that kind stores at entry k of export
    array a. `outs` defines each node of the loop that is read after it:
    (node, ("r", R)), (node, ("r", R, slot)) or (node, ("e", a, k))."""

    bounds: tuple
    kinds: tuple
    kind: int
    classes: tuple
    registers: tuple
    arrays: tuple
    outs: tuple
    # A loop whose gathers read only the loop before it, at the step a fixed
    # number of steps from its own, runs inside that loop's iterations:
    # `head` is the first loop of the iterations it shares (-1: its own),
    # and its step k runs in iteration k + shift, after the loops before it
    # in the iteration, its gathers reading the entry just made (`_fuse`).
    head: int = -1
    shift: int = 0


class _Peel(Exception):
    """The step at which a run of steps stops being one loop."""

    def __init__(self, step):
        super().__init__(step)
        self.step = step


class _NoLoop(Exception):
    """The run of steps is not one loop."""


def _key(v):
    """A program value as it compares: literals by their bits."""
    return ("c", _bits(v)) if type(v) is float else ("b", v) if type(v) is bool else v


def _find_chain(ops, usable) -> list:
    """The longest chain of usable ops of one kind, each reading the one
    before: a recurrence's accumulator (the density, a tangent), one link a
    step. Program indices, in order."""
    best, prev = [0] * len(ops), [-1] * len(ops)
    for i, (op, *args) in enumerate(ops):
        if not usable[i] or op in _LEAVES:
            continue
        best[i] = 1
        for a in args:
            if type(a) is int and usable[a] and ops[a][0] == op and best[a] >= best[i]:
                best[i], prev[i] = best[a] + 1, a
    i = max(range(len(ops)), key=best.__getitem__, default=-1)
    chain = []
    while i >= 0 and best[i]:
        chain.append(i)
        i = prev[i]
    return chain[::-1]


def _step_sig(ops, s, e) -> tuple:
    """The shape of ops s .. e - 1 as a step: each op and its operands' kinds,
    a reference inside the step by its place in it."""
    out = []
    for i in range(s, e):
        op, *args = ops[i]
        if op in _LEAVES:
            out.append((op,))
            continue
        out.append((op, *(("t", a - s) if type(a) is int and a >= s else
                          ("n",) if type(a) is int else ("b", a) if type(a) is bool else ("f",)
                          for a in args)))
    return tuple(out)


def _peel_rare_ends(wins, sigs):
    """Drop the steps at either end whose shape no other step has."""
    counts = {}
    for g in sigs:
        counts[g] = counts.get(g, 0) + 1
    lo, hi = 0, len(wins)
    while lo < hi and counts[sigs[lo]] == 1:
        lo += 1
    while hi > lo and counts[sigs[hi - 1]] == 1:
        hi -= 1
    return wins[lo:hi], sigs[lo:hi]


def _slots(reads, writes, bounds, kinds):
    """How one register holds what its steps read (`reads[k]`, the nodes
    step k reads from it) and write (`writes`, kind -> template op): one
    slot, where each read finds the last value written or, before any
    write, one node made before the loop; else slots, step k reading and
    writing the slot that holds what it reads (a node made before the loop
    takes a slot of its own). Returns (each slot's first value, each step's
    slot or None for one slot, each slot's last value); raises _Peel(k)
    where step k reads a value that no slot holds any more."""
    n, s0 = len(reads), bounds[0]
    for k in range(n):
        if len(reads[k]) > 1:
            raise _Peel(k)
    cur, first, one = None, None, True
    for k in range(n):
        if reads[k]:
            (v,) = reads[k]
            if cur is None and v < s0:
                first = cur = v
            elif cur != v:
                one = False
                break
        if kinds[k] in writes:
            cur = bounds[k] + writes[kinds[k]]
    if one:
        return [first], None, [cur]
    content, held, idx, init = [], {}, [0] * n, []
    for k in range(n):
        w = kinds[k] in writes
        if reads[k]:
            (v,) = reads[k]
            s = held.get(v)
            if s is None or content[s] != v:
                if v >= s0:
                    raise _Peel(k)
                s = held[v] = len(content)
                content.append(v)
                init.append(v)
        elif w:
            s = len(content)
            content.append(None)
            init.append(None)
        else:
            continue
        idx[k] = s
        if w:
            content[s] = bounds[k] + writes[kinds[k]]
            held[content[s]] = s
    return init, idx, content


def _plan(prog: Program, bounds, kinds, before, last_use):
    """The draft loop of the steps `bounds` (kinds `kinds`): its templates,
    columns and registers. `before` holds the drafts of loops that come
    earlier in the program, whose export arrays a gather may read. Raises
    _Peel(k) where step k breaks the loop, _NoLoop where no run would do."""
    ops, data = prog.ops, prog.data
    n, s0, end = len(bounds) - 1, bounds[0], bounds[-1]
    steps_of = {}
    for k, c in enumerate(kinds):
        steps_of.setdefault(c, []).append(k)
    for v in range(s0, end):
        if ops[v][0] in _CMP and last_use[v] >= bounds[bisect.bisect_right(bounds, v)]:
            raise _Peel(bisect.bisect_right(bounds, v) - 1)  # a predicate read later
    columns = {}

    def column(vals):
        full = [0.0] * n
        for k, v in vals:
            full[k] = v
        key = tuple(_bits(v) for v in full)
        columns.setdefault(key, full)
        return ("col", key)

    classes, pending = [], {}
    for c in range(len(steps_of)):
        ks = steps_of[c]
        tmpl = []
        for j in range(bounds[ks[0] + 1] - bounds[ks[0]]):
            per = [ops[bounds[k] + j] for k in ks]
            op, *args0 = per[0]
            if op == "x":
                raise _NoLoop("a coordinate's leaf inside a step")
            if op == "phi":
                tmpl.append(("phi", ()))
                continue
            if op == "data":
                vals = [(k, data[o[1]]) for k, o in zip(ks, per)]
                same = all(_bits(v) == _bits(vals[0][1]) for _, v in vals)
                tmpl.append(("data", (("u", vals[0][1]) if same else column(vals),)))
                continue
            refs = []
            for p, a0 in enumerate(args0):
                vals = [(k, o[1 + p]) for k, o in zip(ks, per)]
                if type(a0) is float:
                    same = all(_bits(v) == _bits(a0) for _, v in vals)
                    refs.append(("u", a0) if same else column(vals))
                elif type(a0) is not int:
                    refs.append(("u", a0))
                elif a0 >= bounds[ks[0]]:
                    refs.append(("t", a0 - bounds[ks[0]]))
                elif a0 < s0 and all(v == a0 for _, v in vals):
                    refs.append(("u", a0))
                else:
                    pending[(c, j, p)] = vals
                    refs.append(None)
            tmpl.append((op, refs))
        classes.append(tmpl)

    # Registers: a reader (kind, op, operand) and the (kind, op) that made
    # what it reads are one register.
    parent = {}

    def find(u):
        while parent.setdefault(u, u) != u:
            parent[u] = parent[parent[u]]
            u = parent[u]
        return u

    for key, vals in pending.items():
        find(("r", key))
        for k, v in vals:
            if v >= s0:
                kp = bisect.bisect_right(bounds, v) - 1
                parent[find(("r", key))] = find(("w", kinds[kp], v - bounds[kp]))
    members = {}
    for u in list(parent):
        members.setdefault(find(u), []).append(u)
    groups = []
    for us in members.values():
        writes = {}
        for u in us:
            if u[0] == "w":
                if u[1] in writes:
                    raise _NoLoop("two values of one step in one register")
                if ops[bounds[steps_of[u[1]][0]] + u[2]][0] in _CMP:
                    raise _NoLoop("a predicate carried")
                writes[u[1]] = u[2]
        groups.append(dict(readers=[u[1] for u in us if u[0] == "r"], writes=writes))

    def reads_of(readers):
        reads = [set() for _ in range(n)]
        for key in readers:
            for k, v in pending[key]:
                reads[k].add(v)
        return reads

    def fits(readers, writes):
        try:
            return _slots(reads_of(readers), writes, bounds, kinds)
        except _Peel:
            return None

    # A register whose steps read what a read-only one gathers (an
    # accumulator whose first value each slot takes from before the loop)
    # takes that one's reads; read-only registers that fit one array share it.
    merged = set()
    group_of = {key: gi for gi, g in enumerate(groups) for key in g["readers"]}
    for g in groups:
        for c, j in list(g["writes"].items()):
            for p in range(len(classes[c][j][1])):
                h = group_of.get((c, j, p))
                if h is None or h in merged or groups[h]["writes"] or groups[h] is g:
                    continue
                if fits(g["readers"] + groups[h]["readers"], g["writes"]):
                    g["readers"] += groups[h]["readers"]
                    merged.add(h)
    shared = []
    for gi, g in enumerate(groups):
        if gi in merged or g["writes"]:
            continue
        for h in shared:
            if fits(h["readers"] + g["readers"], {}):
                h["readers"] += g["readers"]
                merged.add(gi)
                break
        else:
            shared.append(g)
    groups = [g for gi, g in enumerate(groups) if gi not in merged]
    # An op that reads a register and is read after the loop writes it back,
    # where the register still fits: its last values leave from the slots,
    # not from an export array (the accumulator of b[item[t]]'s gradient).
    writers = {(c, j) for g in groups for c, j in g["writes"].items()}
    for g in groups:
        for c, j, _ in list(g["readers"]):
            if (c in g["writes"] or (c, j) in writers or classes[c][j][0] in _CMP
                    or all(last_use[bounds[k] + j] < end for k in steps_of[c])):
                continue
            if fits(g["readers"], {**g["writes"], c: j}):
                g["writes"][c] = j
                writers.add((c, j))

    regs, final, where_r = [], {}, {}
    for R, g in enumerate(groups):
        writes, reads = g["writes"], reads_of(g["readers"])
        for key in g["readers"]:
            where_r[key] = R
        for k in range(n):
            if len(reads[k]) > 1:
                raise _Peel(k)
        read = sorted({v for r in reads for v in r})
        src = [d for d in before if d["bounds"][0] <= read[0] and read[-1] < d["bounds"][-1]]
        if not writes and src and len(read) > 1:
            # A gather of an earlier loop's values: its export array.
            d, idx, made = src[0], [0] * n, {}
            for k in range(n):
                if reads[k]:
                    (v,) = reads[k]
                    kk = bisect.bisect_right(d["bounds"], v) - 1
                    if made.setdefault(d["kinds"][kk], v - d["bounds"][kk]) != v - d["bounds"][kk]:
                        break
                    idx[k] = kk
            else:
                regs.append(dict(writes={}, init=[], index=idx,
                                 alias=(d, tuple(sorted(made.items())))))
                continue
        init, idx, content = _slots(reads, writes, bounds, kinds)
        if len(content) > REROLL_MAX_SLOTS:
            raise _NoLoop("too many slots")
        made = sum(v is not None and ops[v][0] not in _LEAVES for v in init)
        if not writes and 2 * made > n:
            # A copy of straight-line values into local memory, about one a
            # step: the loop would only move them there and back.
            raise _NoLoop("a gather of values computed before the loop")
        regs.append(dict(writes=writes, init=init, index=idx, alias=None))
        for s, v in enumerate(content):
            if v is not None and v >= s0:
                final[v] = ("r", R) if idx is None else ("r", R, s)
    for key, R in where_r.items():
        classes[key[0]][key[1]][1][key[2]] = ("r", R)
    return dict(bounds=tuple(bounds), kinds=tuple(kinds), classes=classes,
                columns=columns, registers=regs, final=final)


def _loop_of_chain(prog: Program, chain, taken, drafts, last_use):
    """The draft loop whose steps end where the chain's links do (shifted
    by the offset that gives the fewest kinds of step), the steps at either
    end that break it peeled; None where no loop of REROLL_MIN_STEPS steps
    and REROLL_MIN_OPS operations remains."""
    ops = prog.ops
    taken_before = [0]
    for t in taken:
        taken_before.append(taken_before[-1] + t)
    gaps = sorted(b - a for a, b in zip(chain, chain[1:]))
    best = None
    for delta in range(max(1, gaps[len(gaps) // 4])):
        run, runs = [], []
        for a, b in zip(chain, chain[1:]):
            s, e = a + 1 + delta, b + 1 + delta
            if e <= len(ops) and taken_before[e] == taken_before[s]:
                run.append((s, e))
            else:
                runs.append(run)
                run = []
        wins = max(runs + [run], key=len)
        wins, sigs = _peel_rare_ends(wins, [_step_sig(ops, s, e) for s, e in wins])
        score = (len(set(sigs)), -len(wins))
        if wins and (best is None or score < best[0]):
            best = (score, wins, sigs)
    if best is None:
        return None
    _, wins, sigs = best
    before = [d for d in drafts if d["bounds"][-1] <= wins[0][0]]
    while len(wins) >= REROLL_MIN_STEPS:
        kind_of = {}
        kinds = [kind_of.setdefault(g, len(kind_of)) for g in sigs]
        if len(kind_of) > REROLL_MAX_KINDS:
            return None
        bounds = [s for s, _ in wins] + [wins[-1][1]]
        try:
            draft = _plan(prog, bounds, kinds, before, last_use)
        except _Peel as e:
            k = e.step
            wins, sigs = (wins[k + 1:], sigs[k + 1:]) if 2 * k < len(wins) else (wins[:k], sigs[:k])
            wins, sigs = _peel_rare_ends(wins, sigs)
            continue
        except _NoLoop:
            return None
        size = bounds[-1] - bounds[0]
        body = sum(len(t) for t in draft["classes"])
        return draft if size >= REROLL_MIN_OPS and 2 * body <= size else None
    return None


def _reroll(prog: Program) -> Program:
    """`prog` with its recurrences emitted as loops (`Recurrence`): each run
    of steps that repeat the same ops in the same shape, found from the
    longest chains of accumulating ops and checked op for op; the program's
    ops are unchanged, so its plain version, `count_ops` and `peak_live`
    too. A program with none is returned as it is."""
    ops = prog.ops
    last_use = list(range(len(ops)))
    for i, (op, *args) in enumerate(ops):
        if op not in _LEAVES:
            for a in args:
                if type(a) is int:
                    last_use[a] = i
    for o in (prog.logp, *prog.grad):
        if type(o) is int:
            last_use[o] = len(ops)
    taken, blocked, drafts = [False] * len(ops), set(), []
    while True:
        usable = [not t and i not in blocked for i, t in enumerate(taken)]
        chain = _find_chain(ops, usable)
        if len(chain) <= REROLL_MIN_STEPS:
            break
        draft = _loop_of_chain(prog, chain, taken, drafts, last_use)
        if draft is None:
            blocked.update(chain)
            continue
        drafts.append(draft)
        for i in range(draft["bounds"][0], draft["bounds"][-1]):
            taken[i] = True
    if not drafts:
        return prog
    drafts.sort(key=lambda d: d["bounds"][0])
    number = {id(d): li for li, d in enumerate(drafts)}
    owner = [-1] * len(ops)
    for li, d in enumerate(drafts):
        for i in range(d["bounds"][0], d["bounds"][-1]):
            owner[i] = li

    # What is read outside each loop: by straight-line ops, the outputs,
    # other loops' shared operands and registers' first values.
    needed = [{} for _ in drafts]

    def need(v):
        if type(v) is int and owner[v] >= 0:
            needed[owner[v]][v] = None

    for i, (op, *args) in enumerate(ops):
        if owner[i] < 0 and op not in _LEAVES:
            for a in args:
                need(a)
    for o in (prog.logp, *prog.grad):
        need(o)
    for d in drafts:
        for tmpl in d["classes"]:
            for _, refs in tmpl:
                for r in refs:
                    if r[0] == "u":
                        need(r[1])
        for reg in d["registers"]:
            for v in reg["init"]:
                need(v)

    arrays = [[] for _ in drafts]  # per loop: {kind: template op} each

    def array(li, made):
        for a, arr in enumerate(arrays[li]):
            if all(arr.get(c, j) == j for c, j in made):
                arr.update(made)
                return a
        arrays[li].append(dict(made))
        return len(arrays[li]) - 1

    for d in drafts:
        for reg in d["registers"]:
            if reg["alias"] is not None:
                src, made = reg["alias"]
                reg["alias"] = (number[id(src)], array(number[id(src)], made))
    outs = []
    for li, d in enumerate(drafts):
        b = d["bounds"]
        mine = []
        for v in sorted(needed[li]):
            if v in d["final"]:
                mine.append((v, d["final"][v]))
                continue
            k = bisect.bisect_right(b, v) - 1
            mine.append((v, ("e", array(li, [(d["kinds"][k], v - b[k])]), k)))
        outs.append(tuple(mine))

    data, placed = list(prog.data), {}

    def place(vals):
        key = tuple(_bits(float(v)) for v in vals)
        if key not in placed:
            placed[key] = len(data)
            data.extend(float(v) for v in vals)
        return placed[key]

    recs = []
    for li, d in enumerate(drafts):
        def ref(r):
            return ("col", place(d["columns"][r[1]])) if r[0] == "col" else r

        regs = tuple(Register(
            writes=tuple(sorted(reg["writes"].items())), init=tuple(reg["init"]),
            index=-1 if reg["index"] is None else place(reg["index"]),
            alias=reg["alias"] or ()) for reg in d["registers"])
        recs.append(Recurrence(
            bounds=d["bounds"], kinds=d["kinds"],
            kind=place(d["kinds"]) if len(d["classes"]) > 1 else -1,
            classes=tuple(tuple((op, tuple(ref(r) for r in refs)) for op, refs in tmpl)
                          for tmpl in d["classes"]),
            registers=regs,
            arrays=tuple(tuple(sorted(arr.items())) for arr in arrays[li]),
            outs=outs[li]))
    recs = _fuse(prog, data, recs)
    if len(data) > REROLL_MAX_DATA or any(
            r.alias for rec in recs if rec.head < 0 for r in rec.registers):
        # A loop that gathers another's values but cannot run in its
        # iterations would pass them through export arrays in local memory,
        # which on an H100 made the Stan T=200 recurrence 5.5x slower than
        # its straight line (PERF.md): such a program stays straight-line.
        return prog
    out = dataclasses.replace(prog, data=tuple(data), recurrences=recs)
    for k in range(len(recs)):
        _check_unrolled(out, k)
    return out


def _fuse(prog: Program, data, recs) -> tuple:
    """The recurrences, each that reads the loops before it only by
    gathering the previous one's values at step k + c (c fixed) from its
    step k, and whose operands, first values and the straight-line ops
    between them read nothing else of those loops, set to run inside their
    iterations (`Recurrence.head`): the values pass from one to the other
    in registers, not through an export array in local memory."""
    recs = list(recs)
    for i in range(1, len(recs)):
        a, b = recs[i - 1], recs[i]
        head = a.head if a.head >= 0 else i - 1
        spans = [(recs[g].bounds[0], recs[g].bounds[-1]) for g in range(head, i)]

        def inside(v):
            return type(v) is int and any(lo <= v < hi for lo, hi in spans)

        reading = {}
        for c, tmpl in enumerate(b.classes):
            for _, refs in tmpl:
                for r in refs:
                    if r[0] == "r":
                        reading.setdefault(r[1], set()).add(c)
        gathers = [R for R, r in enumerate(b.registers) if r.alias]
        shifts = {int(data[b.registers[R].index + k]) - k for R in gathers
                  for k, c in enumerate(b.kinds) if c in reading.get(R, ())}
        if (not gathers or len(shifts) != 1
                or any(b.registers[R].alias[0] != i - 1 for R in gathers)
                or any(inside(v) for r in b.registers for v in r.init)
                or any(r[0] == "u" and inside(r[1]) for tmpl in b.classes
                       for _, refs in tmpl for r in refs)
                or any(inside(v) for j in range(a.bounds[-1], b.bounds[0])
                       if prog.ops[j][0] not in _LEAVES for v in prog.ops[j][1:])):
            continue
        recs[i] = dataclasses.replace(b, head=head, shift=a.shift + shifts.pop())
    return tuple(recs)


def _unrolled(prog: Program, k: int):
    """Recurrence k of `prog` as its loop computes it, step by step: the
    ops of each step with their operands resolved to node ids (a literal or
    datum by its value), and the nodes that `outs` defines, resolved."""
    recs, data = prog.recurrences, prog.data
    rec = recs[k]
    slots = [list(r.init) for r in rec.registers]
    steps = []
    for s, c in enumerate(rec.kinds):
        base = rec.bounds[s]

        def val(r):
            kind, v = r
            if kind == "t":
                return base + v
            if kind == "u":
                return v
            if kind == "col":
                return data[v + s]
            reg = rec.registers[v]
            i = 0 if reg.index < 0 else int(data[reg.index + s])
            if reg.alias:
                src = recs[reg.alias[0]]
                return src.bounds[i] + dict(src.arrays[reg.alias[1]])[src.kinds[i]]
            return slots[v][i]

        step = [(op,) if op == "phi" else (op, *(val(r) for r in refs))
                for op, refs in rec.classes[c]]
        for R, reg in enumerate(rec.registers):
            for cc, j in reg.writes:
                if cc == c:
                    slots[R][0 if reg.index < 0 else int(data[reg.index + s])] = base + j
        steps.append(step)
    outs = {}
    for node, src in rec.outs:
        if src[0] == "e":
            i = src[2]
            outs[node] = rec.bounds[i] + dict(rec.arrays[src[1]])[rec.kinds[i]]
        else:
            outs[node] = slots[src[1]][src[2] if len(src) == 3 else 0]
    return steps, outs


def _check_unrolled(prog: Program, k: int):
    """Recurrence k regenerates its steps' ops exactly, and each node it
    defines after the loop is the one named."""
    rec = prog.recurrences[k]
    steps, outs = _unrolled(prog, k)
    for s, step in enumerate(steps):
        lo, hi = rec.bounds[s], rec.bounds[s + 1]
        want = [prog.ops[i] if prog.ops[i][0] != "data" else ("data", prog.data[prog.ops[i][1]])
                for i in range(lo, hi)]
        if [tuple(map(_key, o)) for o in step] != [tuple(map(_key, o)) for o in want]:
            raise AssertionError(f"recurrence {k}: step {s} does not regenerate ops "
                                 f"{lo}..{hi - 1}")
    if any(node != v for node, v in outs.items()):
        raise AssertionError(f"recurrence {k}: a node after the loop is not its own")


_INFIX = {"add": "+", "sub": "-", "mul": "*", "div": "/", **{
    k: v for k, v in zip(_CMP, ("<", "<=", ">", ">=", "==", "!=", "&&"))}}
_CALL = {"exp": "expf", "log": "logf", "log1p": "log1pf", "expm1": "expm1f",
         "sqrt": "sqrtf", "tanh": "tanhf", "abs": "fabsf", "lgamma": "lgammaf",
         "cos": "cosf", "sin": "sinf", "erf": "erff", "erfc": "erfcf", "tan": "tanf",
         "atan": "atanf", "asin": "asinf", "acos": "acosf", "sinh": "sinhf", "cosh": "coshf"}
# The libdevice calls that `libdevice_unary` holds to ATen's CUDA ops, by
# their op in the program (the kernel's code of each, `csrc/libdevice_sweep.cu`).
LIBDEVICE_SWEEP = {"cos": 0, "sin": 1, "erf": 2, "erfc": 3, "lgamma": 4, "tan": 5, "atan": 6,
                   "asin": 7, "acos": 8, "sinh": 9, "cosh": 10}


def libdevice_unary(op: str, x: torch.Tensor) -> torch.Tensor:
    """The libdevice call the kernel emits for `op` (one of LIBDEVICE_SWEEP)
    on x, float32: the kernel of `csrc/libdevice_sweep.cu` for a
    CUDA tensor (built with the NUTS kernels' flags), torch's op, the
    program's plain version, for a CPU tensor."""
    if op not in LIBDEVICE_SWEEP:
        raise ValueError(f"op must be one of {tuple(LIBDEVICE_SWEEP)}, got {op!r}")
    if x.device.type == "cpu":
        return _UNARY[op](x)
    if x.device.type != "cuda":
        raise ValueError(f"libdevice_unary runs on cpu or cuda tensors, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() < 1:
        raise ValueError("x must be a non-empty contiguous float32 tensor")
    from .nuts_cuda import build_library

    out = torch.empty_like(x)
    err = build_library().lib.smcnuts_libdevice_unary(
        LIBDEVICE_SWEEP[op], x.data_ptr(), out.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"libdevice_unary kernel launch failed: CUDA error {err}")
    libdevice_unary.launches += 1
    return out


libdevice_unary.launches = 0  # kernel launches, and nothing else


def _c_literal(v: float) -> str:
    """A float32 literal, bit-exact (hex float; the value is already a
    float32)."""
    if math.isnan(v):
        return "__int_as_float(0x7fc00000)"
    if math.isinf(v):
        return "__int_as_float(0x7f800000)" if v > 0 else "__int_as_float(0xff800000)"
    return f"({v.hex()}f)"


def _c_literal64(v: float) -> str:
    """A float64 literal, bit-exact (hex float)."""
    if math.isnan(v):
        return "__longlong_as_double(0x7ff8000000000000LL)"
    if math.isinf(v):
        return f"__longlong_as_double({'0x7ff0' if v > 0 else '0xfff0'}000000000000LL)"
    return f"({v.hex()})"


def _c_rhs(op, a, ref, real="float") -> str:
    """The C expression of op on operands a, each written by `ref`, in the
    real type `real` ("float", or "double": the libdevice calls of double,
    as ATen's CUDA ops of float64 make them)."""
    f = "f" if real == "float" else ""
    if op in _INFIX:
        return f"{ref(a[0])} {_INFIX[op]} {ref(a[1])}"
    if op == "neg":
        return f"-{ref(a[0])}"
    if op == "recip":
        return f"1.0{f} / {ref(a[0])}"
    if op == "pow":
        return f"pow{f}({ref(a[0])}, {ref(a[1])})"
    if op == "sign":
        return f"static_cast<{real}>((0.0{f} < {ref(a[0])}) - ({ref(a[0])} < 0.0{f}))"
    if op == "where":
        return f"{ref(a[0])} ? {ref(a[1])} : {ref(a[2])}"
    return f"{_CALL[op] if f else _CALL[op][:-1]}({ref(a[0])})"


def _ref(a) -> str:
    return f"v{a}" if type(a) is int else _c_literal(a)


def _c_line(prog: Program, i: int) -> str:
    op, *a = prog.ops[i]
    kind = "bool" if op in _CMP else "float"
    if op in _CALLS:
        return _c_call(prog, i)
    if op == "elem":
        rhs = f"c{a[0]}[{a[1]}]"
    elif op == "x":
        rhs = f"x[{a[0]}]"
    elif op == "phi":
        rhs = "phi"
    elif op == "data":
        rhs = f"d[{a[0]}]"
    else:
        rhs = _c_rhs(op, a, _ref)
    return f"    const {kind} v{i} = {rhs};"


def _c_loop(prog: Program, k: int) -> list:
    """Loop k of a grouped program: lane `lane` evaluates the template at its
    indices i = lane + s W (the coordinates x[a + i] chosen by selects over
    static indices, the data table's entries at d[o + i]), folds each sum's
    summands in index order, and keeps what it exports; then the xor
    butterfly of the sums and the broadcasts of the exports."""
    loop, W = prog.loops[k], prog.group
    n = loop.n
    steps = -(-n // W)
    p = f"l{k}"

    def ref(r):
        kind, v = r
        if kind == "u":
            return _ref(v) if type(v) is not bool else ("true" if v else "false")
        if kind == "x":
            return f"{p}x{v}"
        if kind == "col":
            return f"d[{v} + i]"
        return f"{p}t{v}"

    coords = sorted({r[1] for _, refs in loop.ops for r in refs if r[0] == "x"}
                    | {r[1] for r, _ in loop.sums if r[0] == "x"})
    lines = [f"    // {len(loop.sums)} sums of {n} summands: lane l takes summands "
             f"l, l + {W}, ..."]
    lines += [f"    float {p}s{r} = 0.0f;" for r in range(len(loop.sums))]
    lines += [f"    float {p}e{e}[{steps}];" for e in range(len(loop.exports))]
    lines += ["#pragma unroll", f"    for (int step = 0; step < {steps}; ++step) {{",
              f"      const int i = step * {W} + lane;"]
    pad = "      "
    if n % W:
        lines.append(f"      if (i < {n}) {{")
        pad = "        "
    for a in coords:
        lines.append(f"{pad}float {p}x{a} = x[{a} + step * {W}];")
        for q in range(1, W):
            lines.append(f"{pad}if (step * {W} + {q} < {n} && lane == {q}) "
                         f"{p}x{a} = x[{a} + step * {W} + {q}];")
    for t, (op, refs) in enumerate(loop.ops):
        kind = "bool" if op in _CMP else "float"
        lines.append(f"{pad}const {kind} {p}t{t} = {_c_rhs(op, refs, ref)};")
    for r, (summand, _) in enumerate(loop.sums):
        lines.append(f"{pad}{p}s{r} = step == 0 ? {ref(summand)} : {p}s{r} + {ref(summand)};")
    for e, (t, _) in enumerate(loop.exports):
        lines.append(f"{pad}{p}e{e}[step] = {p}t{t};")
    if n % W:
        lines.append("      }")
    lines += ["    }", "#pragma unroll", f"    for (int o = {W // 2}; o > 0; o /= 2) {{"]
    lines += [f"      {p}s{r} = {p}s{r} + __shfl_xor_sync(mask, {p}s{r}, o);"
              for r in range(len(loop.sums))]
    lines.append("    }")
    lines += [f"    const float v{root} = {p}s{r};" for r, (_, root) in enumerate(loop.sums)]
    for e, (_, nodes) in enumerate(loop.exports):
        lines += [f"    const float v{v} = __shfl_sync(mask, {p}e{e}[{i // W}], {i % W}, {W});"
                  for i, v in nodes]
    return lines


def _arrays_used(prog: Program):
    """The export arrays that the emission keeps: (stored, current), sets
    of (recurrence, array). An array is stored where a node after its loop,
    or a gather of a loop that runs on its own, reads it; a loop that runs
    inside another's iterations (`Recurrence.head`) reads the entry of the
    step that has just run, kept in one value, the array's current entry."""
    stored, current = set(), set()
    for k, rec in enumerate(prog.recurrences):
        stored |= {(k, src[1]) for _, src in rec.outs if src[0] == "e"}
        for r in rec.registers:
            if r.alias:
                (current if rec.head >= 0 else stored).add(r.alias)
    return stored, current


def _c_declare(prog: Program, k: int, stored) -> list:
    """Recurrence k's registers (their first values) and stored arrays."""
    rec = prog.recurrences[k]
    lines = [f"    // ops {rec.bounds[0]}..{rec.bounds[-1] - 1}: a recurrence of "
             f"{len(rec.bounds) - 1} steps, {len(rec.classes)} kind(s) of step"]
    for R, r in enumerate(rec.registers):
        init = ["0.0f" if v is None else _ref(v) for v in r.init]
        if r.alias:
            continue
        if r.index < 0:
            lines.append(f"    float r{k}c{R} = {init[0]};")
        else:
            lines.append(f"    float r{k}c{R}[{len(init)}] = {{{', '.join(init)}}};")
    lines += [f"    float r{k}e{a}[{len(rec.bounds) - 1}];" for a in range(len(rec.arrays))
              if (k, a) in stored]
    return lines


def _c_step(prog: Program, k: int, step: str, pad: str, stored, current) -> list:
    """One step of recurrence k, its index `step` (a C expression): the
    slots' indices and the step's kind read from the data block, the kind's
    template, then the registers and array entries it assigns."""
    rec = prog.recurrences[k]
    p = f"r{k}"

    def reg(R):
        r = rec.registers[R]
        if r.alias and r.alias in current:
            return f"r{r.alias[0]}x{r.alias[1]}"
        if r.alias:
            return f"r{r.alias[0]}e{r.alias[1]}[{p}i{r.index}]"
        return f"{p}c{R}" if r.index < 0 else f"{p}c{R}[{p}i{r.index}]"

    def ref(r):
        kind, v = r
        if kind == "t":
            return f"{p}t{v}"
        if kind == "u":
            return _ref(v)
        if kind == "col":
            return f"d[{v} + {step}]"
        return reg(v)

    lines = [f"{pad}const int {p}i{o} = static_cast<int>(d[{o} + {step}]);"
             for o in sorted({r.index for r in rec.registers
                              if r.index >= 0 and r.alias not in current})]
    many = len(rec.classes) > 1
    if many:
        lines.append(f"{pad}const int {p}k = static_cast<int>(d[{rec.kind} + {step}]);")
    inner = pad + "  " if many else pad
    for c, tmpl in enumerate(rec.classes):
        if many:
            lines.append(f"{pad}if ({p}k == 0) {{" if c == 0 else
                         f"{pad}}} else if ({p}k == {c}) {{" if c < len(rec.classes) - 1
                         else f"{pad}}} else {{")
        for j, (op, refs) in enumerate(tmpl):
            rhs = "phi" if op == "phi" else ref(refs[0]) if op == "data" else _c_rhs(op, refs, ref)
            lines.append(f"{inner}const {'bool' if op in _CMP else 'float'} {p}t{j} = {rhs};")
        lines += [f"{inner}{reg(R)} = {p}t{j};" for R, r in enumerate(rec.registers)
                  for cc, j in r.writes if cc == c]
        for a, arr in enumerate(rec.arrays):
            for cc, j in arr:
                if cc == c and (k, a) in stored:
                    lines.append(f"{inner}{p}e{a}[{step}] = {p}t{j};")
                if cc == c and (k, a) in current:
                    lines.append(f"{inner}{p}x{a} = {p}t{j};")
    if many:
        lines.append(f"{pad}}}")
    return lines


def _c_outs(prog: Program, k: int) -> list:
    """The nodes of recurrence k that are read after it."""
    lines = []
    for node, src in prog.recurrences[k].outs:
        rhs = (f"r{k}e{src[1]}[{src[2]}]" if src[0] == "e" else
               f"r{k}c{src[1]}[{src[2]}]" if len(src) == 3 else f"r{k}c{src[1]}")
        lines.append(f"    const float v{node} = {rhs};")
    return lines


def _unroll(prog: Program, group) -> int:
    """The unroll factor of the loop that runs the recurrences `group`
    (REROLL_UNROLL)."""
    if REROLL_UNROLL is not None:
        return REROLL_UNROLL
    body = sum(len(t) for m in group for t in prog.recurrences[m].classes)
    u = 1
    while u < 8 and 2 * u * body <= REROLL_UNROLL_OPS:
        u *= 2
    return u


def _c_recurrences(prog: Program) -> list:
    """The straight-line ops and the recurrences in program order: each
    recurrence one `for` over its steps (unrolled by `_unroll`, so the code
    does not grow with them), the recurrences that run inside another's iterations
    (`Recurrence.head`) in the same `for`, the straight-line ops between
    them before it."""
    recs, stored, current = prog.recurrences, *_arrays_used(prog)
    lines, i, k = [], 0, 0
    while k < len(recs):
        group = [k] + [m for m in range(k + 1, len(recs)) if recs[m].head == k]
        lines += [_c_line(prog, j) for j in range(i, recs[k].bounds[0])]
        for a, b in zip(group, group[1:]):
            lines += [_c_line(prog, j) for j in range(recs[a].bounds[-1], recs[b].bounds[0])]
        for m in group:
            lines += _c_declare(prog, m, stored)
        if len(group) == 1:
            lines += [f"#pragma unroll {_unroll(prog, group)}",
                      f"    for (int step = 0; step < {len(recs[k].bounds) - 1}; ++step) {{"]
            lines += _c_step(prog, k, "step", "      ", stored, current)
        else:
            span = [(recs[m].shift, recs[m].shift + len(recs[m].bounds) - 1) for m in group]
            lo, hi = min(a for a, _ in span), max(b for _, b in span)
            lines += [f"    // recurrences {', '.join(map(str, group))} in one loop: step s of "
                      f"each in iteration s + its shift",
                      f"#pragma unroll {_unroll(prog, group)}",
                      f"    for (int it = {lo}; it < {hi}; ++it) {{"]
            lines += [f"      float r{m}x{a};" for m, a in sorted(current) if m in group]
            for m, (a, b) in zip(group, span):
                step = "it" if a == 0 else f"(it - {a})"
                if (a, b) == (lo, hi):
                    lines.append(f"      // recurrence {m}")
                    lines += _c_step(prog, m, step, "      ", stored, current)
                    continue
                lines.append(f"      if (it >= {a} && it < {b}) {{  // recurrence {m}")
                lines += _c_step(prog, m, step, "        ", stored, current)
                lines.append("      }")
        lines.append("    }")
        for m in group:
            lines += _c_outs(prog, m)
        i, k = recs[group[-1]].bounds[-1], group[-1] + 1
    return lines + [_c_line(prog, j) for j in range(i, len(prog.ops))]


def _c_body(prog: Program) -> list:
    calls = any(op in _CALLS for op, *_ in prog.ops)
    head = ["    int ode_steps[2] = {0, 0};"] if calls else []
    tail = [f"    atomicAdd(&smcnuts_generated_ode_steps_count[{k}], "
            f"static_cast<unsigned long long>(ode_steps[{k}]));" for k in (0, 1)] if calls else []
    return head + _c_statements(prog) + tail + [f"    return {_ref(prog.logp)};"]


def _c_statements(prog: Program) -> list:
    if prog.recurrences:
        lines = _c_recurrences(prog)
    elif prog.group == 1:
        lines = [_c_line(prog, i) for i in range(len(prog.ops))]
    else:
        lines = [f"    const int lane = group_lane<{prog.group}>();",
                 f"    const unsigned mask = group_mask<{prog.group}>();"]
        for kind, v in prog.schedule:
            lines += [_c_line(prog, v)] if kind == "v" else _c_loop(prog, v)
    for d, g in enumerate(prog.grad):
        lines.append(f"    grad[{d}] = {_ref(g)};")
    return lines


def _cuda_source(prog: Program, name: str, autodiff: str) -> tuple:
    """(source of the translation unit, struct name)."""
    body = "\n".join(_c_body(prog))
    tag = hashlib.sha256(
        f"{prog.dim} {len(prog.data)}\n{body}".encode()).hexdigest()[:16]
    struct_name = f"GeneratedModel_{tag}"
    n_ops = count_ops(prog)
    group, entry = "", f"smcnuts::{struct_name}"
    if prog.group > 1:
        group = (f"  static constexpr int kGroup = {prog.group};\n"
                 "  static constexpr int kMaxRegisters = 128;  // nuts_tree.cuh: MinBlocks\n")
        entry += f", {GROUP_BLOCK}"
        n_ops = (f"{n_ops} operations, its {len(prog.loops)} loop(s) split over "
                 f"{prog.group} lanes a particle, blocks of {GROUP_BLOCK} threads")
    elif prog.recurrences:
        n_ops = (f"{n_ops} operations, {len(prog.recurrences)} recurrence(s) "
                 f"emitted as loops over their steps")
    else:
        n_ops = f"{n_ops} operations"
    structs, steps = _c_ode_parts(prog)
    src = f"""// Generated by smcnuts_torch/ops/generated.py from the density '{name}'
// ({autodiff} mode, {n_ops}, {len(prog.data)} data floats): the
// NUTS kernel of nuts_tree.cuh with this model inlined, one entry.
#include "nuts_tree.cuh"
{structs}
namespace smcnuts {{

struct {struct_name} {{
  static constexpr int D = {prog.dim};
  static constexpr int kScalars = 0;
  static constexpr int kData = {len(prog.data)};
{group}
  const float* d;  // the data block, in shared memory

  static bool accepts(int n_data, int n_scalars) {{
    return n_data == kData && n_scalars == kScalars;
  }}

  __device__ {struct_name}(const float* data, int, const ModelScalars&) : d(data) {{}}

  __device__ __forceinline__ float logp_grad(const float* x, float phi, float* grad) const {{
{body}
  }}
}};

}}  // namespace smcnuts

extern "C" {{
SMCNUTS_ENTRY(smcnuts_nuts_tree_generated, {entry})
{steps}}}
"""
    return src, struct_name


def _c_ode_parts(prog: Program) -> tuple:
    """For a program with ODE calls: (the header, the step counter and the
    right-hand sides' structs, before the model; the C entry that reads the
    counter), else empty."""
    used = [prog.calls[int(a[0][1:])] for op, *a in prog.ops if op in _CALLS]
    if not used:
        return "", ""
    structs = {}
    for d in used:
        name, body = _ode_struct(d.prog)
        structs.setdefault(name, body)
    head = "\n".join([
        '#include "ode_dopri5.cuh"', "",
        "// The RK steps of the ODE solves and of their adjoints, every lane's, added",
        "// up (a lane's once an evaluation); read and reset by",
        "// smcnuts_generated_ode_steps.",
        "__device__ unsigned long long smcnuts_generated_ode_steps_count[2] = {0, 0};", "",
        "namespace smcnuts {", "", *structs.values(), "}  // namespace smcnuts", ""])
    entry = """int smcnuts_generated_ode_steps(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, smcnuts_generated_ode_steps_count,
                                         2 * sizeof(unsigned long long));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[2] = {0, 0};
    err = cudaMemcpyToSymbol(smcnuts_generated_ode_steps_count, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
"""
    return head, entry


def count_ops(prog: Program) -> int:
    """Operations of one evaluation: every node but the leaves and the reads
    of a call's outputs (an ODE solve counts as one)."""
    return sum(op not in ("x", "phi", "data", "elem") for op, *_ in prog.ops)


def _fx_graph(prog: Program) -> torch.fx.GraphModule:
    """The program as an fx graph of ATen ops over lane tensors: x (P, D),
    phi (P,) -> (logp (P,), grad (P, D))."""
    g = torch.fx.Graph()
    x = g.placeholder("x")
    phi = g.placeholder("phi")
    root = nn.Module()
    out, call = _fx_ops(g, prog.ops, prog.data, x, phi, prog.calls, root)
    logp = out(prog.logp)
    grad = call(_aten.stack.default, [out(o) for o in prog.grad], 1)
    g.output((logp, grad))
    gm = torch.fx.GraphModule(root, g)
    gm.graph.eliminate_dead_code()
    gm.recompile()
    return gm


def _fx_ops(g: torch.fx.Graph, ops, data, x, phi, calls=(), root=None):
    """The ops of a program as nodes of g over lane tensors (x (P, D) and
    phi (P,), placeholders of g); returns (out, call): out(o) the node of a
    program value o, a node or a literal. A literal first operand of a
    non-commutative op takes the op's scalar form, or a full tensor. A call
    node (an ODE solve, `calls`) is a submodule of `root`, `_OdeCallPlain`."""
    first = g.call_function(_aten.select.int, (x, 1, 0))

    def call(fn, *args):
        return g.call_function(fn, args)

    def full(c):
        return call(_aten.full_like.default, first, c)

    vals = []
    swap = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}
    for op, *a in ops:
        if op == "x":
            vals.append(call(_aten.select.int, x, 1, a[0]))
            continue
        if op == "phi":
            vals.append(phi)
            continue
        if op == "data":
            vals.append(data[a[0]])
            continue
        if op in _CALLS:
            name = f"ode_call{len(vals)}"
            root.add_module(name, _OdeCallPlain(calls[int(a[0][1:])]))
            vals.append(g.call_module(name, (first, *(vals[v] if type(v) is int else v
                                                       for v in a[1:]))))
            continue
        if op == "elem":
            vals.append(call(_aten.select.int, vals[a[0]], 1, int(a[1])))
            continue
        r = [vals[v] if type(v) is int else v for v in a]
        if op in ("add", "mul"):
            if isinstance(r[0], float):
                r = [r[1], r[0]]
            v = call(getattr(_aten, op).Tensor, *r)
        elif op == "sub":
            v = (call(_aten.rsub.Scalar, r[1], r[0]) if isinstance(r[0], float)
                 else call(_aten.sub.Tensor, *r))
        elif op == "div":
            # A true division, as the kernel's: ATen's CUDA division by a
            # Python scalar would multiply by its reciprocal instead.
            v = call(_aten.div.Tensor, *(full(u) if isinstance(u, float) else u for u in r))
        elif op == "and":
            v = call(_aten.logical_and.default, *r)
        elif op in _CMP:
            if isinstance(r[0], float):
                op, r = swap[op], [r[1], r[0]]
            v = call(getattr(_aten, op).Tensor if not isinstance(r[1], float)
                     else getattr(_aten, op).Scalar, *r)
        elif op == "where":
            v = call(_aten.where.self, r[0], *(full(u) if isinstance(u, float) else u
                                               for u in r[1:]))
        elif op == "pow":
            v = call(_aten.pow.Tensor_Scalar, r[0], r[1])
        elif op == "recip":
            v = call(_aten.reciprocal.default, r[0])
        else:
            v = call(getattr(_aten, op).default, r[0])
        vals.append(v)

    def out(o):
        return vals[o] if type(o) is int else full(o)

    return out, call


# The lane counts whose CUDA graph a generated model keeps (`_replay`).
REPLAY_GRAPHS = 4
_SEEN = object()


class GeneratedModel(nn.Module):
    """The counterpart of the JAX `TileModel` (`nuts_pallas.py:57`) for a
    generated model: `dim`, `autodiff` ("forward" or "reverse"), the
    simplified value-and-gradient `graph` (its plain version), the `data`
    block (a float32 buffer that follows `.to(device)`), the CUDA `source`
    and its `hash`, `n_ops`, the operations of one evaluation, and `group`,
    the lanes its kernel runs a particle on. The compaction hints are the
    JAX TileModel's default, ()."""

    compaction_hint = ()
    compaction_hint_adapted = ()

    def __init__(self, prog: Program, autodiff: str, name: str):
        super().__init__()
        self.name = name
        self.dim = prog.dim
        self.autodiff = autodiff
        self.program = prog
        self.group = prog.group
        self.n_ops = count_ops(prog)
        self.graph = _fx_graph(prog)
        self._graphs = {}  # (device, lanes) -> _SEEN or (CUDA graph, inputs, outputs)
        self.register_buffer("data", torch.tensor(prog.data, dtype=torch.float32))
        self.source, self.struct_name = _cuda_source(prog, name, autodiff)
        self.hash = hashlib.sha256(self.source.encode()).hexdigest()[:16]

    def logp_and_grad(self, x, phi=1.0):
        """The plain version of the kernel's model: (logp (P,), grad (P, D))
        of float32 x (P, D), op for op as the kernel computes them; on the
        card through `_replay`, but for a program with ODE solves, whose
        plain solve checks its lanes from the host a step and so cannot be
        captured: that one runs op by op."""
        if x.dtype != torch.float32:
            raise NotImplementedError(
                f"the generated model computes in float32 (as its kernel), got {x.dtype}")
        if not isinstance(phi, torch.Tensor) or phi.dim() == 0:
            phi = torch.full((x.shape[0],), float(phi), dtype=x.dtype, device=x.device)
        phi = phi.to(x.dtype)
        if x.is_cuda and x.shape[0] > 0 and not self.program.calls:
            return self._replay(x, phi)
        return self.graph(x, phi)

    def _replay(self, x, phi):
        """The graph on the card (a program without ODE solves, whose plain
        version steps on the host): op by op at the first call of a lane count,
        captured into a CUDA graph at its second and replayed from then on.
        A replay launches the same ATen kernels on the same values, so its
        bits are those of the graph run op by op, without a host dispatch
        an operation (a leaf of a large program is tens of thousands). The
        REPLAY_GRAPHS lane counts used last keep their graphs."""
        key = (x.device, x.shape[0])
        entry = self._graphs.pop(key, None)
        if entry is None:
            out, entry = self.graph(x, phi), _SEEN
        else:
            if entry is _SEEN:
                static = (x.clone(), phi.clone())
                graph = torch.cuda.CUDAGraph()
                # thread_local: threads that build kernels meanwhile may call
                # the CUDA runtime.
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    result = self.graph(*static)
                entry = (graph, static, result)
            else:
                entry[1][0].copy_(x)
                entry[1][1].copy_(phi)
            entry[0].replay()
            out = tuple(v.clone() for v in entry[2])
        self._graphs[key] = entry
        while len(self._graphs) > REPLAY_GRAPHS:
            self._graphs.pop(next(iter(self._graphs)))
        return out


def tile_model_from_logp(logp_fn, dim, name="generated", group=None) -> GeneratedModel:
    """A generated model of `logp_fn(theta (D,), phi) -> scalar` with its
    gradient by reverse mode: `torch.func.grad_and_value` traced by make_fx
    into ATen ops, lowered to scalars and simplified. Data that the density
    closes over as tensors go to the data block.

    group=1 emits every node straight-line in the order it was built, one
    thread a particle; group=None is DEFAULT_GROUP, 1. Another power of two
    W splits the sums of W summands or more, whose summand cones must be one
    body (`_Body`), over a group of W lanes a particle (`_choose_group`):
    the body is emitted once inside a loop over a lane's summands, each
    sum's lane partial folded in index order and butterflied, the program's
    other nodes straight-line in every lane. It raises ValueError where the
    program cannot be split over W."""
    if group is None:
        group = DEFAULT_GROUP
    if group not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"group must be None or a power of two in 1..32, got {group}")

    def vg(theta, phi):
        return torch.func.grad_and_value(logp_fn)(theta, phi)

    with _SpecialFunctions():
        gm = trace_fx(vg, torch.zeros(dim), torch.zeros(()))

    def lower(plan):
        b = _Scalars(plan)
        x = np.empty((dim,), dtype=object)
        for d in range(dim):
            x[d] = b.leaf("x", d)
        phi = _const_array((), 0.0)
        phi[()] = b.leaf("phi")
        grad, value = _lower(gm, [x, phi], b, name)
        grad = _arr(grad)
        if grad.shape != (dim,) or _arr(value).shape != ():
            raise ValueError(f"model '{name}': logp_fn must map ({dim},) to a scalar")
        return b, _arr(value)[()], list(grad)

    b, value, grad = lower({})
    if group == 1:
        prog = _finish(b, value, grad, dim)
    else:
        try:
            plan = _choose_group(b, [b.mat(value)] + [b.mat(g) for g in grad], group)
            prog = _group_program(*lower(plan), dim, group)
        except _NoSplit as e:
            raise ValueError(f"model '{name}': cannot split over {group} lanes: "
                             f"{e}") from None
    return GeneratedModel(prog, "reverse", name)


def tile_model_from_logp_fwd(logp_seq_fn, dim, name="generated",
                             order="primal", reroll=True) -> GeneratedModel:
    """A generated model of `logp_seq_fn(coords, phi) -> scalar`, whose
    coordinates arrive as a sequence of D scalars, with its gradient by
    forward mode: the primal traced once (make_fx over D + 1 scalars), then
    one tangent pass a coordinate by this module's rules, in which a
    symbolically zero tangent stays absent. D <= MAX_FORWARD_DIM.

    The program is emitted in (primal node, pass) order (`_primal_order`),
    and with `reroll` each recurrence it holds (a run of steps that repeat
    the same ops in the same shape, `_reroll`) as one loop over its steps,
    so that the code does not grow with the recurrence's length; the
    program, and so its bits, stay the same. `reroll=False` emits every op
    straight-line (the measurement witness of `chip_smoke.py` phases 11 and
    13). `order="built"` emits it straight-line in the order it was built,
    the whole primal before the first pass: the same operations on the same
    operands, with more values live at once (phase 11's witness of the
    order)."""
    if order not in ("primal", "built"):
        raise ValueError(f"order must be 'primal' or 'built', got {order!r}")
    if not 1 <= dim <= MAX_FORWARD_DIM:
        raise ValueError(f"the forward adapter takes 1 <= dim <= {MAX_FORWARD_DIM}, got {dim}")

    def primal(*args):
        return logp_seq_fn(tuple(args[:dim]), args[dim])

    with _SpecialFunctions():
        gm = trace_fx(primal, *[torch.zeros(()) for _ in range(dim + 1)])
    b = _Scalars()
    inputs = []
    for d in range(dim):
        a = np.empty((), dtype=object)
        a[()] = b.leaf("x", d)
        inputs.append(a)
    phi = np.empty((), dtype=object)
    phi[()] = b.leaf("phi")
    out = _arr(_lower(gm, inputs + [phi], b, name))
    if out.shape != ():
        raise ValueError(f"model '{name}': logp_seq_fn must return a scalar")
    logp = b.mat(out[()])
    n_primal = len(b.ops)
    grads = []
    for d in range(dim):
        tan = {inputs[d][()]: 1.0}
        for i in range(n_primal):
            op, *args = b.ops[i]
            if op == "x":
                continue
            b.ctx = (i, d)
            t = _tangent(b, i, op, tuple(args), tan)
            if t is not None:
                tan[i] = t
        grads.append(tan.get(logp, 0.0) if type(logp) is int else 0.0)
    b.ctx = (n_primal, 0)  # the outputs' last multiplies, at the end
    prog = _finish(b, logp, grads, dim, order)
    if reroll and order == "primal":
        prog = _reroll(prog)
    return GeneratedModel(prog, "forward", name)


def straight_line(model: GeneratedModel) -> GeneratedModel:
    """The same program with every op straight-line: a re-rolled forward
    model's witness, without tracing the density again."""
    prog = model.program
    n_data = sum(op == "data" for op, *_ in prog.ops)
    prog = dataclasses.replace(prog, data=prog.data[:n_data], recurrences=())
    return GeneratedModel(prog, model.autodiff, model.name)


# ---------------------------------------------------------------------------
# Functions of many outputs: an ODE right-hand side and its VJP.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Function:
    """A lowered function of len(outs) outputs in the real type `dtype`:
    `ops` as a Program's (the inputs are the leaves ("x", d), the elements
    of the traced inputs flattened in order; "data" indexes `data`,
    constants of the function), `outs` node indices or literals, the traced
    outputs' elements flattened in order."""

    ops: tuple
    outs: tuple
    data: tuple
    dtype: torch.dtype


def lower_function(fn, inputs, name="function") -> Function:
    """fn(*inputs) traced by `trace_fx` on the tensors `inputs` (one dtype,
    float32 or float64) and lowered to scalars, simplified as a generated
    model is, its constants folded in that dtype. An op the lowering does
    not have raises NotImplementedError naming it."""
    dtype = inputs[0].dtype
    with _real(dtype):
        gm = trace_fx(fn, *inputs)
        b = _Scalars()
        leaves, d = [], 0
        for t in inputs:
            a = np.empty(tuple(t.shape), dtype=object)
            for idx in np.ndindex(a.shape):
                a[idx] = b.leaf("x", d)
                d += 1
            leaves.append(a)
        out = _lower(gm, leaves, b, name)
        flat = [v for o in (out if isinstance(out, (list, tuple)) else [out])
                for v in _arr(o).reshape(-1)]
        ops, outs, data, _ = _renumber(b, flat)
    return Function(ops, tuple(outs), data, dtype)


def function_ops(fn: Function) -> int:
    """Operations of one evaluation: every node but the leaves."""
    return sum(op not in ("x", "data") for op, *_ in fn.ops)


def function_graph(fn: Function) -> torch.fx.GraphModule:
    """The function as an fx graph of ATen ops over lanes: x (P, inputs) ->
    (P, len(outs)), op for op as `function_lines` computes it."""
    g = torch.fx.Graph()
    x = g.placeholder("x")
    out, call = _fx_ops(g, fn.ops, fn.data, x, None)
    g.output(call(_aten.stack.default, [out(o) for o in fn.outs], 1))
    g.eliminate_dead_code()
    return torch.fx.GraphModule(nn.Module(), g)


def function_lines(fn: Function, leaf, out: str) -> list:
    """The function's body in CUDA C++ in its real type: a line a node,
    input d written as leaf(d), then `out[k] = ...;` for every output."""
    real = "double" if fn.dtype == torch.float64 else "float"
    literal = _c_literal64 if real == "double" else _c_literal

    def ref(a):
        return f"v{a}" if type(a) is int else literal(a)

    lines = []
    for i, (op, *a) in enumerate(fn.ops):
        kind = "bool" if op in _CMP else real
        rhs = (leaf(a[0]) if op == "x" else literal(fn.data[a[0]]) if op == "data"
               else _c_rhs(op, a, ref, real))
        lines.append(f"    const {kind} v{i} = {rhs};")
    lines += [f"    {out}[{k}] = {ref(o)};" for k, o in enumerate(fn.outs)]
    return lines


# ---------------------------------------------------------------------------
# Building the generated kernel library.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GeneratedLibrary:
    lib: ctypes.CDLL
    fn: object  # the entry, smcnuts_nuts_tree_generated
    path: str
    build_seconds: float  # 0.0 when it was already built
    log: str  # nvcc's output (-Xptxas -v: registers, stack, spills)


_GENERATED: dict = {}


def ode_steps(model: GeneratedModel, reset=False) -> tuple:
    """(solves, adjoints): the RK steps the kernel's inlined ODE solves and
    their adjoints took since the last reset, every lane's added up (the
    library's device counter; synchronises). `reset` sets it to 0."""
    if not model.program.calls:
        raise ValueError(f"model '{model.name}' solves no ODE")
    fn = build_generated(model).lib.smcnuts_generated_ode_steps
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    out = (ctypes.c_ulonglong * 2)()
    err = fn(ctypes.addressof(out), int(reset))
    if err != 0:
        raise RuntimeError(f"reading the ODE step counter failed: CUDA error {err}")
    return int(out[0]), int(out[1])


def build_generated(model: GeneratedModel) -> GeneratedLibrary:
    """Build (once per hash of the generated source, every csrc file and the
    flags) and load the NUTS kernel library of one generated model into
    build/smcnuts_torch/generated/<hash>/. A failed build raises with nvcc's
    output."""
    from .nuts_cuda import BUILD_ROOT, CSRC_DIR, LINK_FLAGS, NVCC_FLAGS, _nvcc, entry_argtypes

    # Looked up on every dispatch: keyed in the process by the source's hash
    # (the csrc files and flags do not change while it runs).
    if model.hash in _GENERATED:
        return _GENERATED[model.hash]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    digest.update(model.source.encode())
    for path in sorted(os.listdir(CSRC_DIR)):
        digest.update(path.encode())
        with open(os.path.join(CSRC_DIR, path), "rb") as f:
            digest.update(f.read())
    key = digest.hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, "generated", key)
    so_path = os.path.join(out_dir, "libsmcnuts_generated.so")
    log_path = os.path.join(out_dir, "nvcc.log")
    seconds = 0.0
    if not os.path.exists(so_path):
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        src = os.path.join(out_dir, f"model.{tag}.cu")
        with open(src, "w") as f:
            f.write(model.source)
        tmp = f"{so_path}.{tag}"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-I", CSRC_DIR, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the generated model '{model.name}' "
                               f"with exit code {proc.returncode}:\n{proc.stdout}")
        with open(log_path, "w") as f:
            f.write(proc.stdout)
        os.replace(src, os.path.join(out_dir, "model.cu"))
        os.replace(tmp, so_path)  # atomic: concurrent builds agree
    lib = ctypes.CDLL(so_path)
    fn = lib.smcnuts_nuts_tree_generated
    fn.argtypes = entry_argtypes()
    fn.restype = ctypes.c_int
    log = ""
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = f.read()
    _GENERATED[model.hash] = GeneratedLibrary(lib, fn, so_path, seconds, log)
    return _GENERATED[model.hash]
