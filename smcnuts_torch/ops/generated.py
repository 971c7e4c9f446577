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

The program of a split model holds the lanes' partials and lane 0's
butterfly adds as ordinary adds, so the plain version, `count_ops` and
`peak_live` compute what the lanes compute.

What bounds the kernel on an H100: the FP32 instruction rate and latency of
its straight-line program (`GeneratedModel.n_ops` operations a leapfrog),
which `chip_smoke.py` divides by the card's FP32 rate (and by the FMUL+FADD
peak of `ops/peak.py`, what the -fmad=false build can reach); in a split
model also the tree control, which every lane of a group repeats.

Supported ATen ops: add, sub, rsub, mul, div, neg, exp, expm1, log, log1p,
sqrt, rsqrt, reciprocal, pow by a constant, tanh, sigmoid, abs, sign,
lgamma (of constants or in a value that is not differentiated:
its derivative, digamma, has no CUDA counterpart), where, the six
comparisons, sum, dot, mv, mm, select and slice by constants,
stack, cat, unbind, the backward ops that autograd emits for these, the
constructors of constant tensors, and the shape-only ops. Any other raises
NotImplementedError naming the ATen op and the model.
"""

from __future__ import annotations

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


def _f32(v) -> float:
    """v rounded to float32, as torch rounds a scalar operand of a float32
    tensor op."""
    with np.errstate(over="ignore"):
        return float(np.float32(v))


def _bits(v: float) -> bytes:
    return struct.pack("<f", v)


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
_CMP = {"lt": operator.lt, "le": operator.le, "gt": operator.gt,
        "ge": operator.ge, "eq": operator.eq, "ne": operator.ne}
# Unary ops of the program and the torch function that folds or runs each.
_UNARY = {
    "neg": torch.neg, "exp": torch.exp, "log": torch.log, "log1p": torch.log1p,
    "expm1": torch.expm1, "sqrt": torch.sqrt, "tanh": torch.tanh,
    "abs": torch.abs, "lgamma": torch.lgamma, "recip": torch.reciprocal,
    "sign": torch.sign,
}


def _fold(op, vals):
    """The float32 value of op on constants (a bool for a comparison)."""
    with np.errstate(all="ignore"):
        if op in _BINARY:
            return float(_BINARY[op](np.float32(vals[0]), np.float32(vals[1])))
        if op in _CMP:
            return bool(_CMP[op](vals[0], vals[1]))
        if op == "where":
            return vals[1] if vals[0] else vals[2]
        t = torch.tensor(vals[0], dtype=torch.float32)
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

    # -- leaves and nodes ---------------------------------------------------
    def _append(self, op):
        self.ops.append(op)
        if self.ctx is not None:
            self.keys[len(self.ops) - 1] = self.ctx
        return len(self.ops) - 1

    def leaf(self, op, *attrs):
        return self._append((op,) + attrs)

    def datum(self, v) -> int:
        v = _f32(v)
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
            return _f32(c * base)
        if isinstance(base, _Scaled):
            return _Scalars.scaled(_f32(c * base.c), base.base)
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
                return self.scaled(_f32(a.c * b), a.base)
            if type(a) is int and a in self.known:
                return self.node("mul", a, b)
            return _Scaled(b, a)
        sa, sb = isinstance(a, _Scaled), isinstance(b, _Scaled)
        if sa and sb:
            return self.scaled(_f32(a.c * b.c), self.mul(a.base, b.base))
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
    if op in ("x", "phi", "data", "sign") or op in _CMP:
        return None
    ts = [tan.get(a) if type(a) is int else None for a in args]
    if all(t is None for t in ts):
        return None
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
        return b.mul(e, b.mul(t[0], b.pow(args[0], _f32(e - 1.0))))
    if op == "where":
        return b.where(args[0], t[1], t[2])
    raise NotImplementedError(
        f"forward mode through {op} of a parameter: its derivative "
        + ("(digamma) has no CUDA counterpart" if op == "lgamma" else "is not written")
    )


# ---------------------------------------------------------------------------
# Lowering a make_fx graph of ATen ops to the scalar program.
# ---------------------------------------------------------------------------


def _lit(v):
    """A Python number of the graph as a program literal."""
    return v if type(v) is bool else _f32(v)


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


def _reduce(b, a, dims, keepdim):
    a = _arr(a)
    nd = a.ndim
    dims = sorted({d % nd for d in (range(nd) if not dims else dims)}) if nd else []
    keep = [d for d in range(nd) if d not in dims]
    moved = np.transpose(a, keep + dims)
    flat = moved.reshape(tuple(a.shape[d] for d in keep) + (-1,))
    out = np.empty(flat.shape[:-1], dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = _seq_sum(b, list(flat[idx]))
    if keepdim:
        out = out.reshape(tuple(1 if d in dims else a.shape[d] for d in range(nd)))
    return out


def _check_float(dtype, what):
    if dtype is not None and dtype != torch.float32:
        raise NotImplementedError(
            f"{what}: the generated model computes in float32, the density "
            f"asks for {dtype}")


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
            t = getattr(gm, node.target)
            if not t.is_floating_point():
                raise NotImplementedError(
                    f"model '{model}': a constant of {t.dtype} in the density")
            vals = t.detach().double().cpu().numpy()
            env[node] = _ew(lambda v: b.datum(float(v)), vals.astype(object))
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
            c = _ew(lambda v: b.mul(_f32(alpha), v), c)
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


def _pow(b, node, a, e):
    if isinstance(e, np.ndarray):
        if not all(type(v) is float for v in e.flat):
            raise NotImplementedError(f"{node.target} with an exponent that is not constant")
        return _ew(lambda u, v: b.pow(u, v), a, e)
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        raise NotImplementedError(f"{node.target}: a constant raised to a tensor")
    return _ew(lambda u: b.pow(u, _f32(e)), a)


def _where(b, node, c, x, y):
    return _ew(lambda cc, u, v: b.where(cc, u, v), c, x, y)


def _to_copy(b, node, a, **kw):
    _check_float(kw.get("dtype"), node.target)
    return _arr(a)


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


_HANDLERS = {
    "add": _binary(_Scalars.add), "sub": _binary(_Scalars.sub),
    "rsub": _binary(lambda b, u, v: b.sub(v, u)),
    "mul": _binary(_Scalars.mul), "div": _binary(_Scalars.div),
    **{op: _unary(op) for op in ("neg", "exp", "log", "log1p", "expm1", "sqrt",
                                 "tanh", "abs", "lgamma", "sign")},
    "reciprocal": _unary("recip"),
    "rsqrt": lambda b, node, a: _ew(lambda u: b.div(1.0, b.unary("sqrt", u)), a),
    "sigmoid": lambda b, node, a: _ew(
        lambda u: b.div(1.0, b.add(1.0, b.unary("exp", b.mul(-1.0, u)))), a),
    "sigmoid_backward": lambda b, node, g, y: _ew(
        lambda u, v: b.mul(b.mul(u, b.sub(1.0, v)), v), g, y),
    "tanh_backward": lambda b, node, g, y: _ew(
        lambda u, v: b.mul(u, b.sub(1.0, b.mul(v, v))), g, y),
    "pow": _pow, "where": _where,
    **{op: (lambda op: lambda b, node, u, v: _ew(lambda p, q: b.node(op, p, q), u, v))(op)
       for op in _CMP},
    "sum": _sum,
    "dot": _matmul, "mv": _matmul, "mm": _matmul,
    **{op: _shape(lambda a, *r: a) for op in (
        "clone", "alias", "detach", "lift_fresh_copy", "contiguous")},
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
    outs = [b.mat(logp)] + [b.mat(g) for g in grads]
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
    return Program(tuple(ops), ren[0], tuple(ren[1:]), data, dim), new


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


_INFIX = {"add": "+", "sub": "-", "mul": "*", "div": "/", **{
    k: v for k, v in zip(_CMP, ("<", "<=", ">", ">=", "==", "!="))}}
_CALL = {"exp": "expf", "log": "logf", "log1p": "log1pf", "expm1": "expm1f",
         "sqrt": "sqrtf", "tanh": "tanhf", "abs": "fabsf", "lgamma": "lgammaf"}


def _c_literal(v: float) -> str:
    """A float32 literal, bit-exact (hex float; the value is already a
    float32)."""
    if math.isnan(v):
        return "__int_as_float(0x7fc00000)"
    if math.isinf(v):
        return "__int_as_float(0x7f800000)" if v > 0 else "__int_as_float(0xff800000)"
    return f"({v.hex()}f)"


def _c_rhs(op, a, ref) -> str:
    """The C expression of op on operands a, each written by `ref`."""
    if op in _INFIX:
        return f"{ref(a[0])} {_INFIX[op]} {ref(a[1])}"
    if op == "neg":
        return f"-{ref(a[0])}"
    if op == "recip":
        return f"1.0f / {ref(a[0])}"
    if op == "pow":
        return f"powf({ref(a[0])}, {ref(a[1])})"
    if op == "sign":
        return f"static_cast<float>((0.0f < {ref(a[0])}) - ({ref(a[0])} < 0.0f))"
    if op == "where":
        return f"{ref(a[0])} ? {ref(a[1])} : {ref(a[2])}"
    return f"{_CALL[op]}({ref(a[0])})"


def _ref(a) -> str:
    return f"v{a}" if type(a) is int else _c_literal(a)


def _c_line(prog: Program, i: int) -> str:
    op, *a = prog.ops[i]
    kind = "bool" if op in _CMP else "float"
    if op == "x":
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


def _c_body(prog: Program) -> list:
    if prog.group == 1:
        lines = [_c_line(prog, i) for i in range(len(prog.ops))]
    else:
        lines = [f"    const int lane = group_lane<{prog.group}>();",
                 f"    const unsigned mask = group_mask<{prog.group}>();"]
        for kind, v in prog.schedule:
            lines += [_c_line(prog, v)] if kind == "v" else _c_loop(prog, v)
    for d, g in enumerate(prog.grad):
        lines.append(f"    grad[{d}] = {_ref(g)};")
    lines.append(f"    return {_ref(prog.logp)};")
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
    else:
        n_ops = f"{n_ops} operations"
    src = f"""// Generated by smcnuts_torch/ops/generated.py from the density '{name}'
// ({autodiff} mode, {n_ops}, {len(prog.data)} data floats): the
// NUTS kernel of nuts_tree.cuh with this model inlined, one entry.
#include "nuts_tree.cuh"

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
}}
"""
    return src, struct_name


def count_ops(prog: Program) -> int:
    """Operations of one evaluation: every node but the leaves."""
    return sum(op not in ("x", "phi", "data") for op, *_ in prog.ops)


def _fx_graph(prog: Program) -> torch.fx.GraphModule:
    """The program as an fx graph of ATen ops over lane tensors: x (P, D),
    phi (P,) -> (logp (P,), grad (P, D)). A literal first operand of a
    non-commutative op takes the op's scalar form, or a full tensor."""
    g = torch.fx.Graph()
    x = g.placeholder("x")
    phi = g.placeholder("phi")
    first = g.call_function(_aten.select.int, (x, 1, 0))

    def call(fn, *args):
        return g.call_function(fn, args)

    def full(c):
        return call(_aten.full_like.default, first, c)

    vals = []
    swap = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}
    for op, *a in prog.ops:
        if op == "x":
            vals.append(call(_aten.select.int, x, 1, a[0]))
            continue
        if op == "phi":
            vals.append(phi)
            continue
        if op == "data":
            vals.append(prog.data[a[0]])
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

    logp = out(prog.logp)
    grad = call(_aten.stack.default, [out(o) for o in prog.grad], 1)
    g.output((logp, grad))
    g.eliminate_dead_code()
    return torch.fx.GraphModule(nn.Module(), g)


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
        self.register_buffer("data", torch.tensor(prog.data, dtype=torch.float32))
        self.source, self.struct_name = _cuda_source(prog, name, autodiff)
        self.hash = hashlib.sha256(self.source.encode()).hexdigest()[:16]

    def logp_and_grad(self, x, phi=1.0):
        """The plain version of the kernel's model: (logp (P,), grad (P, D))
        of float32 x (P, D), op for op as the kernel computes them."""
        if x.dtype != torch.float32:
            raise NotImplementedError(
                f"the generated model computes in float32 (as its kernel), got {x.dtype}")
        if not isinstance(phi, torch.Tensor) or phi.dim() == 0:
            phi = torch.full((x.shape[0],), float(phi), dtype=x.dtype, device=x.device)
        return self.graph(x, phi.to(x.dtype))


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
    from torch.fx.experimental.proxy_tensor import make_fx

    if group is None:
        group = DEFAULT_GROUP
    if group not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"group must be None or a power of two in 1..32, got {group}")

    def vg(theta, phi):
        return torch.func.grad_and_value(logp_fn)(theta, phi)

    gm = make_fx(vg)(torch.zeros(dim), torch.zeros(()))

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
                             order="primal") -> GeneratedModel:
    """A generated model of `logp_seq_fn(coords, phi) -> scalar`, whose
    coordinates arrive as a sequence of D scalars, with its gradient by
    forward mode: the primal traced once (make_fx over D + 1 scalars), then
    one tangent pass a coordinate by this module's rules, in which a
    symbolically zero tangent stays absent. D <= MAX_FORWARD_DIM.

    The program is emitted in (primal node, pass) order (`_primal_order`);
    `order="built"` emits it in the order it was built, the whole primal
    before the first pass: the same operations on the same operands, so the
    same bits, with more values live at once (the measurement witness of
    `chip_smoke.py` phase 11)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    if order not in ("primal", "built"):
        raise ValueError(f"order must be 'primal' or 'built', got {order!r}")
    if not 1 <= dim <= MAX_FORWARD_DIM:
        raise ValueError(f"the forward adapter takes 1 <= dim <= {MAX_FORWARD_DIM}, got {dim}")

    def primal(*args):
        return logp_seq_fn(tuple(args[:dim]), args[dim])

    gm = make_fx(primal)(*[torch.zeros(()) for _ in range(dim + 1)])
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
    return GeneratedModel(_finish(b, logp, grads, dim, order), "forward", name)


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
